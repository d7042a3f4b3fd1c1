"""Recurrent memory-updater cells (counterpart of
``zebra_tpu/models/cells.py``), torch GRUCell/RNNCell gate conventions:

    r = σ(x·W_ir + b_ir + h·W_hr + b_hr)
    z = σ(x·W_iz + b_iz + h·W_hz + b_hz)
    n = tanh(x·W_in + b_in + r ⊙ (h·W_hn + b_hn))
    h' = (1-z) ⊙ n + z ⊙ h

Weights keep JAX's [in, out] layout (``w_ih`` [D, 3H], gates r|z|n), all
initialized U(-1/√H, 1/√H).

Seed-parallel parameters carry a leading seed axis on every leaf (``w``
[S, in, out], ``b`` [S, out]); the activations then carry it too
([S, ..., in]), and :func:`matmul` and :func:`add_bias` compute all S
lanes in one operation each."""

from __future__ import annotations

import torch
from torch import nn


def matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """``x @ w`` with JAX's dtype semantics (``cells.py:matmul``): with a
    ``compute_dtype``, or when ``x`` is already bf16 (a bf16 table gather),
    both operands are rounded to that dtype and the product accumulates and
    returns in f32; otherwise a plain f32 product.

    The rounded operands are multiplied as f32 (``x.float() @ w.float()``):
    a product of two bf16 values is exact in f32, and ``bf16 @ bf16`` in
    torch would return bf16."""
    if compute_dtype is None and x.dtype == torch.bfloat16:
        compute_dtype = torch.bfloat16
    if compute_dtype is not None:
        x, w = x.to(compute_dtype).float(), w.to(compute_dtype).float()
    if w.dim() == 2:
        return x @ w
    # a stacked weight [S, in, out] against x [S, ..., in]: one batched
    # product over the seed lanes
    s, d = w.shape[0], w.shape[1]
    return torch.bmm(x.reshape(s, -1, d), w).reshape(
        x.shape[:-1] + w.shape[-1:])


def add_bias(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y + b``; a stacked bias [S, out] meets y [S, ..., out] lane by
    lane."""
    if b.dim() == 2:
        b = b.reshape(b.shape[:1] + (1,) * (y.dim() - 2) + b.shape[1:])
    return y + b


def _uniform(generator, shape, bound):
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return u * (2 * bound) - bound


def gru_init(generator: torch.Generator, input_dim: int,
             hidden_dim: int) -> nn.ParameterDict:
    b = 1.0 / hidden_dim ** 0.5
    return nn.ParameterDict({
        "w_ih": _uniform(generator, (input_dim, 3 * hidden_dim), b),
        "w_hh": _uniform(generator, (hidden_dim, 3 * hidden_dim), b),
        "b_ih": _uniform(generator, (3 * hidden_dim,), b),
        "b_hh": _uniform(generator, (3 * hidden_dim,), b),
    })


def gru_apply(params, x: torch.Tensor, h: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    """x [..., D], h [..., H] → h' [..., H] in f32 (a bf16 ``h`` promotes)."""
    hd = h.shape[-1]
    gi = add_bias(matmul(x, params["w_ih"], compute_dtype), params["b_ih"])
    gh = add_bias(matmul(h, params["w_hh"], compute_dtype), params["b_hh"])
    i_r, i_z, i_n = gi[..., :hd], gi[..., hd: 2 * hd], gi[..., 2 * hd:]
    h_r, h_z, h_n = gh[..., :hd], gh[..., hd: 2 * hd], gh[..., 2 * hd:]
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def rnn_init(generator: torch.Generator, input_dim: int,
             hidden_dim: int) -> nn.ParameterDict:
    b = 1.0 / hidden_dim ** 0.5
    return nn.ParameterDict({
        "w_ih": _uniform(generator, (input_dim, hidden_dim), b),
        "w_hh": _uniform(generator, (hidden_dim, hidden_dim), b),
        "b_ih": _uniform(generator, (hidden_dim,), b),
        "b_hh": _uniform(generator, (hidden_dim,), b),
    })


def rnn_apply(params, x: torch.Tensor, h: torch.Tensor,
              compute_dtype=None) -> torch.Tensor:
    gi = add_bias(matmul(x, params["w_ih"], compute_dtype), params["b_ih"])
    return torch.tanh(add_bias(gi + matmul(h, params["w_hh"], compute_dtype),
                               params["b_hh"]))


CELLS = {
    "gru": (gru_init, gru_apply),
    "rnn": (rnn_init, rnn_apply),
}
