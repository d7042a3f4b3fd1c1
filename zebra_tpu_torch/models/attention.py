"""Temporal multi-head attention layer (counterpart of
``zebra_tpu/models/attention.py``), the reference's TemporalAttentionLayer:

    query = [h_src ; time_enc(0)]
    key = value = [h_nbr ; edge_feat ; time_enc(Δt)]
    out = MergeLayer(attn_out, h_src)

with per-neighbor padding masks and the all-invalid guard: a row with no
valid neighbor unmasks slot 0, so its softmax stays finite (and so does its
backward), and its attention output is zeroed before the merge.

Plain tensor operations in JAX's [in, out] weight layout and order of
concatenation, not ``nn.MultiheadAttention``: with one query and
``n_degree`` keys per row there is nothing for a fused kernel to win.
Stacked parameters ([S, ...] on every leaf) take activations with a
leading [S] axis; the neighbor-side inputs may then be shared by the lanes
(no [S] axis) and broadcast."""

from __future__ import annotations

import math

import torch
from torch import nn

from zebra_tpu_torch.models.cells import add_bias, matmul

def attention_layer_init(generator: torch.Generator, node_dim: int,
                         edge_dim: int, time_dim: int,
                         n_head: int) -> nn.ParameterDict:
    """One layer's parameters, with JAX's shapes and laws: Xavier-uniform
    projections, zero biases, and the MergeLayer's normal init
    (query + node → node → node). query_dim = node + time must divide into
    ``n_head`` heads."""
    q_dim = node_dim + time_dim
    k_dim = node_dim + edge_dim + time_dim
    if q_dim % n_head:
        raise ValueError(f"n_head={n_head} must divide node_dim + time_dim "
                         f"= {q_dim}")
    dev = generator.device

    def xavier(d_in, d_out):
        bound = (6.0 / (d_in + d_out)) ** 0.5
        u = torch.rand((d_in, d_out), generator=generator, device=dev)
        return u * (2 * bound) - bound

    def normal(d_in, d_out, var):
        return torch.randn((d_in, d_out), generator=generator,
                           device=dev) * var ** 0.5

    zeros = lambda d: torch.zeros(d, device=dev)
    return nn.ParameterDict({
        "w_q": xavier(q_dim, q_dim),
        "w_k": xavier(k_dim, q_dim),
        "w_v": xavier(k_dim, q_dim),
        "b_q": zeros(q_dim), "b_k": zeros(q_dim), "b_v": zeros(q_dim),
        "w_o": xavier(q_dim, q_dim),
        "b_o": zeros(q_dim),
        "merge_fc1_w": normal(q_dim + node_dim, node_dim,
                              2.0 / (q_dim + 2 * node_dim)),
        "merge_fc1_b": zeros(node_dim),
        "merge_fc2_w": normal(node_dim, node_dim, 1.0 / node_dim),
        "merge_fc2_b": zeros(node_dim),
    })


def _linear(x, p, w: str, b: str):
    return add_bias(matmul(x, p[w]), p[b])


def attention_layer_apply(p, src_feat: torch.Tensor, src_te: torch.Tensor,
                          nbr_feat: torch.Tensor, nbr_te: torch.Tensor,
                          edge_feat: torch.Tensor, valid: torch.Tensor,
                          n_head: int) -> torch.Tensor:
    """src_feat [B, D], src_te [B, Dt], nbr_feat [B, n, D], nbr_te
    [B, n, Dt], edge_feat [B, n, De], valid bool [B, n] → [B, D] in f32
    (a bf16 memory row promotes). Stacked ``p``: src_feat [S, B, D] and
    nbr_feat [S, B, n, D]; the other inputs per lane or shared."""
    src_feat, nbr_feat = src_feat.float(), nbr_feat.float()
    lead, nbr_lead = src_feat.shape[:-1], nbr_feat.shape[:-1]
    query = torch.cat([src_feat, src_te.expand(lead + src_te.shape[-1:])],
                      dim=-1)                                    # [.., B, Q]
    keys = torch.cat([nbr_feat,
                      edge_feat.expand(nbr_lead + edge_feat.shape[-1:]),
                      nbr_te.expand(nbr_lead + nbr_te.shape[-1:])],
                     dim=-1)                                     # [.., B, n, K]
    q = _linear(query, p, "w_q", "b_q")
    k = _linear(keys, p, "w_k", "b_k")
    v = _linear(keys, p, "w_v", "b_v")
    hd = q.shape[-1] // n_head
    qh = q.reshape(q.shape[:-1] + (n_head, hd))                  # [.., B, h, d]
    kh = k.reshape(k.shape[:-1] + (n_head, hd))                  # [.., B, n, h, d]
    vh = v.reshape(v.shape[:-1] + (n_head, hd))
    logits = torch.einsum("...bhd,...bnhd->...bhn", qh, kh) / math.sqrt(hd)
    any_valid = valid.any(-1)                                    # [.., B]
    first = torch.arange(valid.shape[-1], device=valid.device) == 0
    mask = valid | (first & ~any_valid[..., None])
    logits = torch.where(mask[..., None, :], logits, -torch.inf)
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("...bhn,...bnhd->...bhd", attn, vh).reshape(
        q.shape)                                                 # [.., B, Q]
    out = _linear(out, p, "w_o", "b_o")
    out = torch.where(any_valid[..., None], out, 0.0)
    # MergeLayer(attn_out, src_feat)
    x = torch.cat([out, src_feat], dim=-1)
    hidden = torch.relu(_linear(x, p, "merge_fc1_w", "merge_fc1_b"))
    return _linear(hidden, p, "merge_fc2_w", "merge_fc2_b")
