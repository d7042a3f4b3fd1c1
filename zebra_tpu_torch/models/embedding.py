"""The embedding modules other than diffusion (counterpart of
``zebra_tpu/models/embedding.py``):

- ``graph_attention``: the classic TGN recursive temporal attention over
  the ``n_degree`` most recent neighbors, ``n_layer`` hops
  (:mod:`.attention`);
- ``graph_sum``: the recursive sum aggregator, padding neighbors masked out
  of the sum;
- ``identity``: the memory rows;
- ``time``: the JODIE projection memory·(1 + w·Δt + b), Δt against the
  node's last update.

Train mode reads memory lazily: every gathered row with a pending message
passes through the updater cell (:func:`lazy_rows`), without committing.

Each hop queries the adjacency index (``index/neighbor_finder.py``) at the
neighbors' own edge times. Seed-parallel tables (``offs``, i64 [S]: lane s
owns rows [s·N, (s+1)·N)) move the memory gathers into each lane's rows,
while the adjacency lookups keep raw node ids: the index is shared by the
lanes. All lanes' roots of a hop take one lookup.

Edge ids past the feature table (fresh events a server observes) read the
table's last row, as JAX's clamped gather does; the diffusion tower and the
messages read the zero row 0 instead."""

from __future__ import annotations

from typing import Optional

import torch

from zebra_tpu_torch.config import RECURSIVE, Config
from zebra_tpu_torch.index.neighbor_finder import (
    NeighborIndex,
    most_recent_neighbors,
)
from zebra_tpu_torch.models.attention import attention_layer_apply
from zebra_tpu_torch.models.cells import add_bias, matmul
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import cell_apply, message_input
from zebra_tpu_torch.models.time_encoding import time_basis, time_encode


def lane_ids(ids: torch.Tensor, offs: Optional[torch.Tensor],
             shared: bool = True) -> torch.Tensor:
    """The flat-table rows of node ids ``ids`` in each seed lane: i64
    ``ids + offs[s]`` with a leading lane axis, or ``ids`` itself when
    ``offs`` is None (one seed). ``shared`` ids are the same for every lane
    ([...]); otherwise they carry the lane axis already ([S, ...])."""
    if offs is None:
        return ids
    ids = ids.to(torch.int64)
    if shared:
        ids = ids[None]
    return ids + offs.view((-1,) + (1,) * (ids.dim() - 1))


def lazy_rows(cfg: Config, params, mem: MemoryState, ids,
              enable: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Memory rows of ``ids``, passed through the updater cell where a
    message is pending (and ``enable`` holds, when given): f32 then, as the
    cell's output promotes a bf16 row."""
    rows = mem.memory[ids]
    msg, flag = message_input(cfg, params, mem, ids, rows)
    upd = cell_apply(cfg, params, msg, rows)
    gate = flag if enable is None else flag & enable
    return torch.where(gate[..., None], upd, rows)


def _rows(cfg: Config, params, mem: MemoryState, nodes, train: bool, offs):
    """The memory rows of raw node ids ``nodes`` ([Q] shared, or [S, Q]
    per lane), lazily updated in train mode."""
    ids = lane_ids(nodes, offs, shared=nodes.dim() == 1)
    return lazy_rows(cfg, params, mem, ids) if train else mem.memory[ids]


def recursive_embed(cfg: Config, params, mem: MemoryState,
                    edge_feats: torch.Tensor, nbr_index: NeighborIndex,
                    nodes: torch.Tensor, times: torch.Tensor, train: bool,
                    offs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """graph_attention / graph_sum embeddings of ``nodes`` [Q] at ``times``
    [Q] → [Q, node_dim] f32. Seed-parallel (``offs``, stacked params):
    ``nodes`` [S, Q] per lane or [Q] shared, ``times`` [Q] → [S, Q, D]."""
    basis = time_basis(cfg.time_dim, edge_feats.device)
    n, last_edge = cfg.n_degree, edge_feats.shape[0] - 1

    def level(nodes, times, layer):
        feats = _rows(cfg, params, mem, nodes, train, offs)
        if layer == 0:
            return feats
        hop = nodes.shape + (n,)
        nbr, eidx, nts, valid = (
            x.reshape(hop) for x in most_recent_neighbors(
                nbr_index, nodes.reshape(-1), times.reshape(-1), n)[:4])
        flat = nodes.shape[:-1] + (-1,)
        nbr_emb = level(nbr.reshape(flat), nts.reshape(flat), layer - 1)
        nbr_emb = nbr_emb.reshape(nbr_emb.shape[:-2] + hop[-2:]
                                  + nbr_emb.shape[-1:])      # [.., Q, n, D]
        te_src = time_encode(torch.zeros_like(times), basis)  # [.., Q, Dt]
        te_nbr = time_encode(times[..., None] - nts, basis)   # [.., Q, n, Dt]
        ef = edge_feats[eidx.clamp(max=last_edge)]            # [.., Q, n, De]
        if cfg.embedding_module == "graph_attention":
            return attention_layer_apply(
                params[f"attn_{layer - 1}"], feats, te_src, nbr_emb, te_nbr,
                ef, valid, cfg.n_head)
        p1, p2 = params[f"sum_fc1_{layer - 1}"], params[f"sum_fc2_{layer - 1}"]
        lead = nbr_emb.shape[:-1]
        nbr_in = torch.cat([nbr_emb.float(),
                            te_nbr.expand(lead + te_nbr.shape[-1:]),
                            ef.expand(lead + ef.shape[-1:])], dim=-1)
        h = add_bias(matmul(nbr_in, p1["w"]), p1["b"])
        h = torch.where(valid[..., None], h, 0.0)
        nbr_sum = torch.relu(h.sum(-2))                       # [.., Q, D]
        src_in = torch.cat([nbr_sum, feats.float(),
                            te_src.expand(feats.shape[:-1]
                                          + te_src.shape[-1:])], dim=-1)
        return add_bias(matmul(src_in, p2["w"]), p2["b"])

    if nodes.dim() > times.dim():
        times = times.expand(nodes.shape)
    return level(nodes, times, cfg.n_layer)


def time_embed(cfg: Config, params, mem: MemoryState, nodes: torch.Tensor,
               times: torch.Tensor, train: bool,
               offs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JODIE time projection of the memory rows of ``nodes`` at
    ``times``: rows·(1 + Δt·w + b), Δt against the node's last update."""
    ids = lane_ids(nodes, offs, shared=nodes.dim() == 1)
    rows = lazy_rows(cfg, params, mem, ids) if train else mem.memory[ids]
    dt = times - mem.last_update[ids]
    w, b = params["time_proj"]["w"][..., 0, :], params["time_proj"]["b"]
    if w.dim() == 2:            # stacked [S, D]: one row per lane
        w, b = w[:, None], b[:, None]
    return rows * (1.0 + dt[..., None] * w + b)


def identity_embed(cfg: Config, params, mem: MemoryState, nodes: torch.Tensor,
                   train: bool, offs: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """The memory rows of ``nodes`` (in the table's dtype in eval mode)."""
    return _rows(cfg, params, mem, nodes, train, offs)


def tower_embed(cfg: Config, params, mem: MemoryState,
                edge_feats: torch.Tensor,
                nbr_index: Optional[NeighborIndex], nodes: torch.Tensor,
                times: torch.Tensor, train: bool,
                offs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The embedding of ``nodes`` at ``times`` by ``cfg.embedding_module``,
    any tower but diffusion."""
    em = cfg.embedding_module
    if em in RECURSIVE:
        return recursive_embed(cfg, params, mem, edge_feats, nbr_index,
                               nodes, times, train, offs)
    if em == "time":
        return time_embed(cfg, params, mem, nodes, times, train, offs)
    if em == "identity":
        return identity_embed(cfg, params, mem, nodes, train, offs)
    raise ValueError(f"unknown embedding module {em!r}")
