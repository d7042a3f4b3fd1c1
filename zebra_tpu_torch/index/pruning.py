"""Pruning-strategy T-PPR query, in PyTorch (counterpart of
``zebra_tpu/index/pruning.py``): a stateless, bounded temporal BFS.

Per query node, walk ``depth`` levels of the ``width`` most recent temporal
neighbours, with walk weight

    w_child = w_parent · (1-α) · β / norm · β^z,
    norm    = β/(1-β) · (1-β^{n_ngh})      (n_ngh = all earlier interactions)

where z indexes siblings newest first, with an extra ·α at depth 0 when
α ≠ 0; candidates reached by several walks accumulate, and the answer is
the top-k by weight. The walk's structure does not depend on (α, β), so it
runs once with static [width^d] frontiers and the weights of all M members
ride a leading axis.

Duplicates are folded on (eidx, nbr) in one of two forms with the same
result: a key-match matrix with a masked sum per candidate up to
``_MATCH_MATRIX_MAX_C`` candidates per root, and above it a sort with a
segmented sum of fixed order (the [Q, C, C] matrix outgrows memory at
depth 3). The top-k breaks ties as the streaming index does: weight
descending, then eidx ascending, then nbr ascending. Every step is
deterministic on the card (sorts, gathers and reductions, no atomics),
and on the CPU a root's result does not depend on the other roots of its
call (no batched product; β^n from one table per call)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from zebra_tpu_torch.index.neighbor_finder import (
    NeighborIndex,
    most_recent_neighbors,
)
from zebra_tpu_torch.index.streaming import TpprQueries

# the candidate count per root above which dedup sorts instead of matching
_MATCH_MATRIX_MAX_C = 256


def _pair_keys(eidx: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """i64 eidx·2^32 + nbr: orders (eidx, nbr) pairs lexicographically."""
    return (eidx.to(torch.int64) << 32) + nbr.to(torch.int64)


def _dedup_matrix(eidx, nbr, w, valid):
    """Key-match dedup: each (eidx, nbr) pair's total weight at its first
    candidate, zero elsewhere. eidx/nbr/valid [Q, C], w [M, Q, C] → (order
    [Q, C], weights [M, Q, C]), the candidates sorted by (eidx, nbr) for
    the top-k."""
    c = eidx.shape[1]
    key = _pair_keys(eidx, nbr)
    eq = ((key[:, :, None] == key[:, None, :]) & valid[:, :, None]
          & valid[:, None, :])                              # [Q, C, C]
    # argmax is the first match, which is the candidate itself only for
    # the first of its pair
    first = valid & (eq.to(torch.uint8).argmax(2)
                     == torch.arange(c, device=w.device))
    # a sum per row rather than a product: its order does not depend on
    # how many roots share the call
    total = torch.where(eq, w[:, :, None, :], 0.0).sum(-1)
    dedup_w = torch.where(first, total, 0.0)
    _, order = torch.sort(key, dim=1, stable=True)
    return order, torch.gather(dedup_w, 2, order.expand_as(dedup_w))


def _dedup_sorted(eidx, nbr, w, valid):
    """Sort-based dedup (``zebra_tpu/index/pruning.py:_dedup_sorted``):
    candidates sorted by (eidx, nbr), invalid ones keyed past every real
    pair with zero weight; each run of one pair folds into its first
    element. The run totals come from a segmented suffix sum in ⌈log2 C⌉
    doubling steps, whose order of addition is fixed. Returns (order
    [Q, C], weights [M, Q, C]) in sorted order."""
    c = eidx.shape[1]
    big = 2 ** 30
    key = _pair_keys(torch.where(valid, eidx, big), torch.where(valid, nbr, big))
    key, order = torch.sort(key, dim=1, stable=True)
    w = torch.gather(torch.where(valid, w, 0.0), 2, order.expand_as(w))
    d = 1
    while d < c:
        same = F.pad(key[:, d:] == key[:, :-d], (0, d))
        w = w + torch.where(same, F.pad(w[..., d:], (0, d)), 0.0)
        d *= 2
    first = F.pad(key[:, 1:] != key[:, :-1], (1, 0), value=True)
    return order, torch.where(first, w, 0.0)


def pruned_topk(index: NeighborIndex, alpha: torch.Tensor, beta: torch.Tensor,
                nodes: torch.Tensor, t_q: torch.Tensor, width: int, depth: int,
                k: int) -> TpprQueries:
    """Top-k T-PPR estimates for each (node, t) query: ``alpha``/``beta``
    f32 [M], ``nodes`` [Q], ``t_q`` f32 [Q] on the index's device → fields
    [M, Q, k] (``zebra_tpu/index/pruning.py:pruned_topk_impl``). Empty slots
    hold nbr 0, eidx 0, weight 0 and dt equal to the query time."""
    m, q = alpha.shape[0], nodes.shape[0]
    dev = index.arena.device
    alpha_b, beta_b = alpha[:, None, None], beta[:, None, None]
    # β^n for every count a lookup can return, in one launch of a fixed
    # size: a power per element would round the tail of a vectorised CPU
    # loop differently, so a root's weights would depend on the batch
    powers = beta[:, None] ** torch.arange(
        max(width, index.max_degree + 1), device=dev)       # [M, P]
    sib = powers[:, None, None, :width]
    f_node, f_ts = nodes[:, None], t_q[:, None]
    f_valid = torch.ones((q, 1), dtype=torch.bool, device=dev)
    f_w = torch.ones((m, q, 1), device=dev)
    cands = []
    for dep in range(depth):
        f = f_node.shape[1]
        nb, ei, nts, nvalid, n_before = most_recent_neighbors(
            index, f_node.reshape(-1), f_ts.reshape(-1), width)
        # the norm of the sibling weights over all earlier neighbours, not
        # only the width taken
        norm = beta_b / (1.0 - beta_b) * (
            1.0 - powers[:, n_before.reshape(q, f)])
        base = f_w * (1.0 - alpha_b) * beta_b / torch.where(norm > 0, norm, 1.0)
        if dep == 0:
            base = torch.where(alpha_b != 0, base * alpha_b, base)
        c = f * width
        f_node, f_ts = nb.reshape(q, c), nts.reshape(q, c)
        f_valid = (nvalid.reshape(q, f, width) & f_valid[..., None]).reshape(
            q, c)
        f_w = (base[..., None] * sib).reshape(m, q, c)
        cands.append((f_node, ei.reshape(q, c), f_ts, f_w, f_valid))
    nbr, eidx, ts, w, valid = (torch.cat(x, dim=-1) for x in zip(*cands))

    dedup = (_dedup_matrix if nbr.shape[1] <= _MATCH_MATRIX_MAX_C
             else _dedup_sorted)
    order, w = dedup(eidx, nbr, w, valid)
    # candidates now in (eidx, nbr) order: a stable sort on the weight
    # alone breaks its ties by eidx, then nbr
    neg_w, pick = torch.sort(-w, dim=2, stable=True)
    top_w, pick = -neg_w[..., :k], pick[..., :k]
    fields = torch.stack([nbr, eidx, ts.view(torch.int32)], dim=-1)
    at = torch.gather(order.expand(m, -1, -1), 2, pick)     # [M, Q, k]
    got = torch.gather(fields.expand(m, -1, -1, -1), 2,
                       at[..., None].expand(-1, -1, -1, 3))
    live = top_w > 0
    got = torch.where(live[..., None], got, 0)
    return TpprQueries(
        nbr=got[..., 0], eidx=got[..., 1],
        dt=t_q[None, :, None] - got[..., 2].view(torch.float32),
        w=torch.where(live, top_w, 0.0))
