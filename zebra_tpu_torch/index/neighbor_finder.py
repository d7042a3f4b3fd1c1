"""Padded-CSR temporal adjacency index, in PyTorch (counterpart of
``zebra_tpu/index/neighbor_finder.py``).

One flat arena of every node's interactions, grouped by node and sorted by
time within a node, plus an offsets vector: node v owns slots
[offsets[v], offsets[v+1]). The adjacency is undirected (both directions of
each event are inserted), and entries with equal timestamps keep stream
order. It is built on the host with numpy, exactly as the JAX package
builds it, and uploaded once.

Temporal lookups are sorted searches, not a loop: each arena slot carries
the int64 key ``owner·2^32 + rank(ts)``, where ``rank`` is the position of
its f32 time among the arena's sorted distinct times U. A slot's time is
below a cut exactly when its rank is below ``searchsorted(U, cut)``, so
the count of a node's interactions before a cut is
``searchsorted(keys, v·2^32 + searchsorted(U, cut)) − offsets[v]``: two
searches per lookup, the exact count of the JAX package's bounded binary
search."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from zebra_tpu_torch.device import resolve_device


class NeighborIndex(NamedTuple):
    arena: torch.Tensor    # i32 [T, 3]: neighbor id, edge id, the f32 time's
                           # bits; grouped by node, time-sorted
    offsets: torch.Tensor  # i64 [N+1]: node v owns [offsets[v], offsets[v+1])
    keys: torch.Tensor     # i64 [T]: owner·2^32 + rank of the slot's time
    times: torch.Tensor    # f32 [U]: the arena's distinct times, ascending
    max_degree: int        # the most slots one node owns

    @property
    def nbr(self) -> torch.Tensor:
        """i32 [T] neighbor ids."""
        return self.arena[:, 0]

    @property
    def eidx(self) -> torch.Tensor:
        """i32 [T] edge ids."""
        return self.arena[:, 1]

    @property
    def ts(self) -> torch.Tensor:
        """f32 [T] edge timestamps."""
        return self.arena[:, 2].view(torch.float32)

    @property
    def n_nodes(self) -> int:
        return self.offsets.shape[0] - 1

    def to(self, device) -> "NeighborIndex":
        """The same index on ``device``."""
        return self._replace(arena=self.arena.to(device),
                             offsets=self.offsets.to(device),
                             keys=self.keys.to(device),
                             times=self.times.to(device))


def build_neighbor_index(sources, destinations, timestamps, edge_idxs,
                         n_nodes: int, device=None) -> NeighborIndex:
    """Build on the host (``zebra_tpu/index/neighbor_finder.py:44-73``: both
    directions, ``np.lexsort((ts, owner))`` on the f64 times), then upload
    once to ``device`` (``None`` → CUDA). Node ids outside [0, n_nodes)
    raise ``ValueError``."""
    dev = resolve_device(device)
    sources = np.asarray(sources, np.int64)
    destinations = np.asarray(destinations, np.int64)
    timestamps = np.asarray(timestamps, np.float64)
    edge_idxs = np.asarray(edge_idxs, np.int64)

    owner = np.concatenate([sources, destinations])
    if len(owner) and (owner.min() < 0 or owner.max() >= n_nodes):
        raise ValueError(f"node ids must lie in [0, {n_nodes}), got "
                         f"[{owner.min()}, {owner.max()}]")
    nbr = np.concatenate([destinations, sources])
    ts = np.concatenate([timestamps, timestamps])
    eidx = np.concatenate([edge_idxs, edge_idxs])
    order = np.lexsort((ts, owner))
    owner, nbr, ts, eidx = owner[order], nbr[order], ts[order], eidx[order]

    offsets = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(np.bincount(owner, minlength=n_nodes), out=offsets[1:])
    ts32 = ts.astype(np.float32)
    times, rank = np.unique(ts32, return_inverse=True)
    keys = (owner << 32) + rank.reshape(-1)
    if not len(owner):
        # one slot that no offset range holds, so a lookup gathers in bounds
        nbr, eidx, ts32 = (np.zeros(1, a.dtype) for a in (nbr, eidx, ts32))
        keys = np.full(1, n_nodes << 32, np.int64)
    arena = np.stack([nbr.astype(np.int32), eidx.astype(np.int32),
                      ts32.view(np.int32)], axis=1)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return NeighborIndex(arena=up(arena), offsets=up(offsets), keys=up(keys),
                         times=up(times),
                         max_degree=int(np.diff(offsets).max(initial=0)))


def count_before(index: NeighborIndex, nodes: torch.Tensor,
                 cuts: torch.Tensor) -> torch.Tensor:
    """For each (node, f32 cut) pair, one past the last slot of the node
    with ts < cut: ``offsets[v] + |{ts < cut}|`` (i64 [Q])."""
    rank = torch.searchsorted(index.times,
                              cuts.to(torch.float32).contiguous())
    return torch.searchsorted(index.keys, (nodes.to(torch.int64) << 32) + rank)


def most_recent_neighbors(index: NeighborIndex, nodes: torch.Tensor,
                          cuts: torch.Tensor, n: int
                          ) -> Tuple[torch.Tensor, ...]:
    """The ``n`` most recent interactions of each node strictly before its
    cut, newest first: (nbr i32, eidx i32, ts f32, valid, n_before i64),
    each [Q, n] but ``n_before`` [Q], the unclipped count of earlier
    interactions. Invalid slots hold zeros."""
    nodes = nodes.to(torch.int64)
    end = count_before(index, nodes, cuts)
    start = index.offsets[nodes]
    pos = end[:, None] - 1 - torch.arange(n, device=end.device)
    valid = pos >= start[:, None]
    got = torch.where(valid[..., None], index.arena[torch.where(valid, pos, 0)],
                      0)
    return (got[..., 0], got[..., 1], got[..., 2].view(torch.float32), valid,
            end - start)
