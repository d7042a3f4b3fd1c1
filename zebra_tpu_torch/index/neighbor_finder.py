"""Padded-CSR temporal adjacency index, in PyTorch (counterpart of
``zebra_tpu/index/neighbor_finder.py``).

One flat arena of every node's interactions, grouped by node and sorted by
time within a node, plus an offsets vector: node v owns slots
[offsets[v], offsets[v+1]). The adjacency is undirected (both directions of
each event are inserted), and entries with equal timestamps keep stream
order. It is built on the host with numpy, exactly as the JAX package
builds it, and uploaded once.

Events observed later in time fold in on the index's device
(:func:`append_events`): each new slot goes to the end of its owner's run,
the old slots shift up by the new slots of the owners before theirs, and
new distinct times append to U, so no old rank moves. The result is
bit-equal to a rebuild over every event wherever appending keeps the
build's order; elsewhere it returns None and the caller rebuilds.

Temporal lookups are sorted searches, not a loop: each arena slot carries
the int64 key ``owner·2^32 + rank(ts)``, where ``rank`` is the position of
its f32 time among the arena's sorted distinct times U. A slot's time is
below a cut exactly when its rank is below ``searchsorted(U, cut)``, so
the count of a node's interactions before a cut is
``searchsorted(keys, v·2^32 + searchsorted(U, cut)) − offsets[v]``: two
searches per lookup, the exact count of the JAX package's bounded binary
search."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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
    # host bookkeeping of append_events (None on an index built elsewhere)
    degree: Optional[np.ndarray] = None      # i64 [N]: slots each node owns
    newest: float = float("-inf")            # the newest f64 time held
    newest_dst: Optional[np.ndarray] = None  # i64: the nodes that own a
                                             # destination-direction slot
                                             # at ``newest``, ascending

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
    _check_owners(owner, n_nodes)
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
    arena = _arena_rows(nbr, eidx, ts32)
    degree = np.diff(offsets)
    newest = float(timestamps.max()) if len(timestamps) else float("-inf")
    return NeighborIndex(arena=_up(arena, dev), offsets=_up(offsets, dev),
                         keys=_up(keys, dev), times=_up(times, dev),
                         max_degree=int(degree.max(initial=0)), degree=degree,
                         newest=newest, newest_dst=np.unique(
                             destinations[timestamps == newest]))


def append_events(index: NeighborIndex, sources, destinations, timestamps,
                  edge_idxs) -> Optional[NeighborIndex]:
    """A new index holding ``index``'s events and these, bit-equal to
    :func:`build_neighbor_index` over both streams concatenated, built on
    ``index``'s device from the new slots alone (``index`` is left as it
    is). None where appending would not keep the build's order (owner, f64
    time, then position in ``[sources ‖ destinations]``), and the caller
    must rebuild: ``index`` holds no events or no bookkeeping, a new time
    lies below ``index.newest``, or a new source-direction slot at
    ``index.newest`` belongs to a node with a destination-direction slot
    there already (the build puts the new slot first)."""
    if index.degree is None or not index.degree.any():
        return None
    sources = np.asarray(sources, np.int64)
    destinations = np.asarray(destinations, np.int64)
    timestamps = np.asarray(timestamps, np.float64)
    edge_idxs = np.asarray(edge_idxs, np.int64)
    n_nodes = index.n_nodes
    owner = np.concatenate([sources, destinations])
    _check_owners(owner, n_nodes)
    if not len(timestamps):
        return index
    # written so that a NaN time rebuilds too
    if not (timestamps >= index.newest).all():
        return None
    if np.isin(sources[timestamps == index.newest], index.newest_dst).any():
        return None

    # the new slots in the build's order among themselves
    ts = np.concatenate([timestamps, timestamps])
    order = np.lexsort((ts, owner))
    owner, ts = owner[order], ts[order]
    nbr = np.concatenate([destinations, sources])[order]
    eidx = np.concatenate([edge_idxs, edge_idxs])[order]
    # every new f32 time is at least the newest held, times[-1]: it takes
    # that rank or a new one above it
    ts32 = ts.astype(np.float32)
    new_times = np.unique(ts32)
    held = new_times[0] == np.float32(index.newest)
    u = index.times.shape[0] - int(held)
    keys = (owner << 32) + u + np.searchsorted(new_times, ts32)

    degree = index.degree + np.bincount(owner, minlength=n_nodes)
    newest = max(index.newest, float(timestamps.max()))
    at_newest = np.unique(destinations[timestamps == newest])
    if newest == index.newest:
        at_newest = np.union1d(index.newest_dst, at_newest)

    dev = index.arena.device
    new_keys = _up(keys, dev)
    new_owner = new_keys >> 32
    # slots of the owners before each node's run: old runs shift by them
    shift = torch.searchsorted(new_owner,
                               torch.arange(n_nodes + 1, device=dev))
    n_old, n_new = index.keys.shape[0], len(keys)
    old_pos = torch.arange(n_old, device=dev) + shift[index.keys >> 32]
    # a new slot j of owner o lands past o's old run, at old offsets[o+1]
    # + j (j counts the new slots of owners up to o)
    new_pos = (index.offsets[new_owner + 1]
               + torch.arange(n_new, device=dev))
    arena = index.arena.new_empty((n_old + n_new, 3))
    arena.index_copy_(0, old_pos, index.arena)
    arena.index_copy_(0, new_pos, _up(_arena_rows(nbr, eidx, ts32), dev))
    all_keys = index.keys.new_empty(n_old + n_new)
    all_keys.index_copy_(0, old_pos, index.keys)
    all_keys.index_copy_(0, new_pos, new_keys)
    times = new_times[1:] if held else new_times
    return NeighborIndex(
        arena=arena, offsets=index.offsets + shift, keys=all_keys,
        times=(torch.cat([index.times, _up(times, dev)]) if len(times)
               else index.times),
        max_degree=max(index.max_degree, int(degree[owner].max())),
        degree=degree, newest=newest, newest_dst=at_newest)


def _check_owners(owner: np.ndarray, n_nodes: int) -> None:
    if len(owner) and (owner.min() < 0 or owner.max() >= n_nodes):
        raise ValueError(f"node ids must lie in [0, {n_nodes}), got "
                         f"[{owner.min()}, {owner.max()}]")


def _arena_rows(nbr, eidx, ts32) -> np.ndarray:
    """i32 [T, 3] arena rows: neighbor id, edge id, the f32 time's bits."""
    return np.stack([nbr.astype(np.int32), eidx.astype(np.int32),
                     ts32.view(np.int32)], axis=1)


def _up(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


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
