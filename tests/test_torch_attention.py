"""The port's temporal attention layer (zebra_tpu_torch/models/attention.py)
against the JAX package's ``attention_layer_apply`` at identical params and
against ``torch.nn.MultiheadAttention``, as tests/test_embedding_modules.py
holds the JAX layer; node and time dims 8, edge dim 3, 2 heads, 6 rows of
4 neighbors, rows with no valid neighbor included.

Bars: against JAX 1e-6 absolute (measured on the CPU: 3.6e-7, the products'
summation order); against ``nn.MultiheadAttention`` the JAX test's rtol
1e-4, atol 1e-5 (measured: 2.4e-7). The backward of a batch whose rows are
all invalid is finite."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.models.attention import attention_layer_apply as jax_apply
from zebra_tpu.models.attention import attention_layer_init as jax_init
from zebra_tpu_torch import bridge
from zebra_tpu_torch.models.attention import (
    attention_layer_apply,
    attention_layer_init,
)

NODE, EDGE, TIME, HEADS, B, N = 8, 3, 8, 2, 6, 4


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    x = dict(src=rs.randn(B, NODE), src_te=rs.randn(B, TIME),
             nbr=rs.randn(B, N, NODE), nbr_te=rs.randn(B, N, TIME),
             ef=rs.randn(B, N, EDGE))
    x = {k: v.astype(np.float32) for k, v in x.items()}
    valid = rs.rand(B, N) > 0.3
    valid[0] = False                 # the all-invalid guard
    valid[1] = [False, False, True, False]
    return x, valid


def _params():
    jp = jax_init(jax.random.key(0, impl="threefry2x32"), NODE, EDGE, TIME,
                  HEADS)
    tree = bridge.params_from_numpy(
        {"attn": [jax.tree.map(np.asarray, jp)]}, "cpu")
    return jp, tree["attn_0"]


def _port(p, x, valid):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    return attention_layer_apply(p, t["src"], t["src_te"], t["nbr"],
                                 t["nbr_te"], t["ef"], torch.from_numpy(valid),
                                 HEADS)


def test_matches_jax():
    x, valid = _inputs()
    jp, pp = _params()
    want = jax_apply(jp, *(jnp.asarray(x[k]) for k in ("src", "src_te", "nbr",
                                                       "nbr_te", "ef")),
                     jnp.asarray(valid), HEADS)
    got = _port(pp, x, valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_matches_torch_multihead_attention():
    x, valid = _inputs(1)
    _, p = _params()
    mha = torch.nn.MultiheadAttention(NODE + TIME, HEADS, kdim=NODE + EDGE
                                      + TIME, vdim=NODE + EDGE + TIME)
    with torch.no_grad():
        for w in ("q", "k", "v"):
            getattr(mha, f"{w}_proj_weight").copy_(p[f"w_{w}"].T)
        mha.in_proj_bias.copy_(torch.cat([p["b_q"], p["b_k"], p["b_v"]]))
        mha.out_proj.weight.copy_(p["w_o"].T)
        mha.out_proj.bias.copy_(p["b_o"])
        query = torch.from_numpy(np.concatenate([x["src"], x["src_te"]], 1))
        key = torch.from_numpy(np.concatenate([x["nbr"], x["ef"],
                                               x["nbr_te"]], 2))
        pad = ~valid
        inv = pad.all(1)
        pad[inv, 0] = False
        out, _ = mha(query[None], key.transpose(0, 1), key.transpose(0, 1),
                     key_padding_mask=torch.from_numpy(pad))
        out = out[0]
        out[torch.from_numpy(inv)] = 0.0
        hidden = torch.relu(torch.cat([out, torch.from_numpy(x["src"])], 1)
                            @ p["merge_fc1_w"] + p["merge_fc1_b"])
        want = hidden @ p["merge_fc2_w"] + p["merge_fc2_b"]
        got = _port(p, x, valid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_backward_is_finite_when_every_slot_is_invalid():
    x, _ = _inputs(2)
    _, p = _params()
    p.requires_grad_(True)
    got = _port(p, x, np.zeros((B, N), bool))
    got.square().sum().backward()
    for key, v in p.items():
        assert torch.isfinite(v.grad).all(), key
    # no valid neighbor: the attention output is zero, so the projections'
    # weights get no gradient
    assert float(p["w_k"].grad.abs().max()) == 0.0


@pytest.mark.parametrize("heads,ok", [(2, True), (3, False)])
def test_init_shapes_and_laws(heads, ok):
    gen = torch.Generator().manual_seed(0)
    if not ok:
        with pytest.raises(ValueError, match="n_head=3"):
            attention_layer_init(gen, NODE, EDGE, TIME, heads)
        return
    p = attention_layer_init(gen, 100, 172, 100, heads)
    jp = jax.tree.map(np.asarray, jax_init(jax.random.key(0), 100, 172, 100,
                                           heads))
    flat = bridge.params_to_numpy(torch.nn.ModuleDict({"attn_0": p}))
    for key, want in jp.items():
        got = flat["attn"][0][key]
        if isinstance(want, dict):
            for k in want:
                assert got[k].shape == want[k].shape, (key, k)
            std = want["w"].std()
            assert abs(got["w"].std() - std) <= 0.05 * std, key
            assert not got["b"].any()
        else:
            assert got.shape == want.shape, key
            assert abs(np.abs(got).max() - np.abs(want).max()) <= (
                0.05 * np.abs(want).max() + 1e-12), key
