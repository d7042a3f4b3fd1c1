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
neighbors' own edge times. A recursive tower is two parts: the hop tree
(:func:`hop_tree`: ids, edge ids, times and valid flags per level) and the
combine over a function that returns a level's rows (:func:`combine_tree`),
which one process and a row-sharded block (its fetched rows) share. Seed-parallel tables (``offs``, i64 [S]: lane s
owns rows [s·N, (s+1)·N)) move the memory gathers into each lane's rows,
while the adjacency lookups keep raw node ids: the index is shared by the
lanes. All lanes' roots of a hop take one lookup.

Edge ids past the feature table (fresh events a server observes) read the
table's last row, as JAX's clamped gather does; the diffusion tower and the
messages read the zero row 0 instead."""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

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
from zebra_tpu_torch.utils.profiling import ATTENTION, HOPS, ROWS, span


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


class Hop(NamedTuple):
    """One level of a recursive tower's hop tree: level 0 holds the roots,
    level l the ``n_degree`` most recent neighbors of each node of level
    l − 1, at that node's time, flat in parent-major order."""

    nodes: torch.Tensor                    # [..., Q_l] node ids
    times: torch.Tensor                    # [..., Q_l] the nodes' times
    eidx: Optional[torch.Tensor] = None    # [..., Q_{l-1}, n] the edge from
                                           # the parent (None at level 0)
    valid: Optional[torch.Tensor] = None   # [..., Q_{l-1}, n]


def hop_tree(cfg: Config, nbr_index: NeighborIndex, nodes: torch.Tensor,
             times: torch.Tensor) -> List[Hop]:
    """The ``n_layer`` + 1 levels of the hop tree of roots ``nodes`` at
    ``times`` ([..., Q], ``times`` broadcast to the roots): each hop
    queries the adjacency index at the neighbors' own edge times. Invalid
    slots hold node 0 at time 0."""
    if nodes.dim() > times.dim():
        times = times.expand(nodes.shape)
    n = cfg.n_degree
    tree = [Hop(nodes, times)]
    for _ in range(cfg.n_layer):
        nodes, times = tree[-1].nodes, tree[-1].times
        hop = nodes.shape + (n,)
        nbr, eidx, nts, valid = (
            x.reshape(hop) for x in most_recent_neighbors(
                nbr_index, nodes.reshape(-1), times.reshape(-1), n)[:4])
        flat = nodes.shape[:-1] + (-1,)
        tree.append(Hop(nbr.reshape(flat), nts.reshape(flat), eidx, valid))
    return tree


def combine_tree(cfg: Config, params, edge_feats: torch.Tensor,
                 tree: Sequence[Hop],
                 rows: Callable[[torch.Tensor], torch.Tensor]
                 ) -> torch.Tensor:
    """graph_attention / graph_sum over a :func:`hop_tree`: ``rows`` maps a
    level's node ids to their memory rows (gathered level by level from the
    roots down), then each layer combines a level's rows with its children's
    embeddings from the deepest level up → the roots' [..., Q, node_dim].
    The gathers are one ``zebra.rows`` span, the layers one
    ``zebra.attention`` span."""
    basis = time_basis(cfg.time_dim, edge_feats.device)
    last_edge = edge_feats.shape[0] - 1
    with span(ROWS):
        feats = [rows(h.nodes) for h in tree]
    with span(ATTENTION):
        emb = feats[-1]
        for d in range(len(tree) - 2, -1, -1):
            layer = len(tree) - 1 - d
            parent, child = tree[d], tree[d + 1]
            hop = child.valid.shape
            nbr_emb = emb.reshape(emb.shape[:-2] + hop[-2:]
                                  + emb.shape[-1:])           # [.., Q, n, D]
            te_src = time_encode(torch.zeros_like(parent.times),
                                 basis)                       # [.., Q, Dt]
            te_nbr = time_encode(parent.times[..., None]
                                 - child.times.reshape(hop), basis)
            ef = edge_feats[child.eidx.clamp(max=last_edge)]  # [.., Q, n, De]
            emb = _layer(cfg, params, layer, feats[d], te_src, nbr_emb,
                         te_nbr, ef, child.valid)
    return emb


def _layer(cfg: Config, params, layer: int, feats, te_src, nbr_emb, te_nbr,
           ef, valid) -> torch.Tensor:
    """One recursive layer: a node's row ``feats`` with its neighbors'
    embeddings."""
    if cfg.embedding_module == "graph_attention":
        return attention_layer_apply(
            params[f"attn_{layer - 1}"], feats, te_src, nbr_emb, te_nbr, ef,
            valid, cfg.n_head)
    p1, p2 = params[f"sum_fc1_{layer - 1}"], params[f"sum_fc2_{layer - 1}"]
    lead = nbr_emb.shape[:-1]
    nbr_in = torch.cat([nbr_emb.float(),
                        te_nbr.expand(lead + te_nbr.shape[-1:]),
                        ef.expand(lead + ef.shape[-1:])], dim=-1)
    h = add_bias(matmul(nbr_in, p1["w"]), p1["b"])
    h = torch.where(valid[..., None], h, 0.0)
    nbr_sum = torch.relu(h.sum(-2))                           # [.., Q, D]
    src_in = torch.cat([nbr_sum, feats.float(),
                        te_src.expand(feats.shape[:-1]
                                      + te_src.shape[-1:])], dim=-1)
    return add_bias(matmul(src_in, p2["w"]), p2["b"])


def tree_embed(cfg: Config, params, mem: MemoryState,
               edge_feats: torch.Tensor, tree: Sequence[Hop], train: bool,
               offs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`combine_tree` over the rows of ``mem`` (lazily updated in
    train mode)."""
    return combine_tree(cfg, params, edge_feats, tree,
                        lambda ids: _rows(cfg, params, mem, ids, train, offs))


def recursive_embed(cfg: Config, params, mem: MemoryState,
                    edge_feats: torch.Tensor, nbr_index: NeighborIndex,
                    nodes: torch.Tensor, times: torch.Tensor, train: bool,
                    offs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """graph_attention / graph_sum embeddings of ``nodes`` [Q] at ``times``
    [Q] → [Q, node_dim] f32. Seed-parallel (``offs``, stacked params):
    ``nodes`` [S, Q] per lane or [Q] shared, ``times`` [Q] → [S, Q, D].
    The hop tree is one ``zebra.hops`` span."""
    with span(HOPS):
        tree = hop_tree(cfg, nbr_index, nodes, times)
    return tree_embed(cfg, params, mem, edge_feats, tree, train, offs)


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
