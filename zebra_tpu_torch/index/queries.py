"""The towers' T-PPR queries from the index layer's answers: a batch's
extraction rows unpacked (streaming), one bounded BFS over the adjacency
index (pruning), and the per-event read's layout flattened. Training,
serving and the node-classification replay share them."""

from __future__ import annotations

import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.index.neighbor_finder import NeighborIndex
from zebra_tpu_torch.index.pruning import pruned_topk
from zebra_tpu_torch.index.streaming import TpprQueries, unpack_queries


def flat_blocks(q: TpprQueries) -> TpprQueries:
    """Per-event fields [..., B, M, nb, k] → [..., M, nb·B, k]: the B
    events' first query block, then their second, and so on."""
    return TpprQueries(*(x.movedim(-4, -2).flatten(-3, -2) for x in q))


def batch_queries(cfg: Config, rows: torch.Tensor,
                  t: torch.Tensor) -> TpprQueries:
    """A batch's extraction rows [b, 3, F] → queries [M, 3b, k] in
    src‖dst‖neg row order; per lane, [S, b, 3, F] → [S, M, 3b, k]."""
    lanes, (b, _, f) = rows.shape[:-3], rows.shape[-3:]
    m, k = cfg.n_tppr, cfg.topk
    if lanes:
        rows, t = rows.reshape(-1, 3, f), t.repeat(lanes[0])
    q = unpack_queries(rows, t, m, k)                      # [·b, M, 3, k]
    return flat_blocks(TpprQueries(*(x.reshape(lanes + (b, m, 3, k))
                                     for x in q)))


def ensemble_tensors(cfg: Config, device):
    """(α, β) of the ensemble members as f32 [M] tensors on ``device``;
    made once per phase, since a copy from the host would wait for the
    device."""
    return (torch.tensor(cfg.alpha_list, device=device),
            torch.tensor(cfg.beta_list, device=device))


def pruned_queries(cfg: Config, index: NeighborIndex, alpha_beta, blocks,
                   t: torch.Tensor) -> TpprQueries:
    """The pruning strategy's queries of the id blocks ``blocks`` (each
    [b]), all at the times ``t`` [b]: one BFS over the concatenated roots
    → fields [M, len(blocks)·b, k] in block order. ``alpha_beta`` is
    :func:`ensemble_tensors`."""
    return pruned_topk(index, *alpha_beta, torch.cat(blocks),
                       t.repeat(len(blocks)), cfg.n_degree, cfg.n_layer,
                       cfg.topk)
