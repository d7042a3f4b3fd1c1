"""The two layouts of a mesh (counterpart of
``zebra_tpu/parallel/sharding.py``): whole seeds per rank, or the node rows
of one seed split over the ranks.

Seed-sharded (S > 1 seeds): rank r of D owns the seed lanes ``[r·S/D,
(r+1)·S/D)`` (:func:`local_lanes`, JAX's ``seed_base``). Its params, Adam
state, dropout generators, negative bases and memory rows are those lanes'
alone; the index and the adjacency need no replication, since every rank
builds them from the same stream.

Row-sharded (one seed): rank r owns the node rows ``[r·N/D, (r+1)·N/D)``
of the memory tables and the T-PPR index (:func:`owner`, :func:`local_rows`:
JAX's ``PartitionSpec('data')`` on ``[N, ·]``, and the wave scheduler's
``rows_per_shard``); params and Adam's state are replicated. Rows cross
ranks on the device, in the row exchange (``parallel/exchange.py``).
:func:`interleave_permutation` relabels node ids round-robin over the
ranks for owner-aligned waves.

What crosses ranks besides, small and on the host:

- the per-batch metrics of a phase, gathered to all S lanes on every rank
  (:func:`all_gather_lanes`) so every rank's early stopping decides alike;
- a state file's lanes or rows, gathered to rank 0, which writes one file
  in the one-process layout (:func:`gather_blocks`); a restore keeps each
  rank's lanes (:func:`take_lanes`) or rows (:func:`take_rows`) of it, so
  any D that divides S, or N, reads it;
- flags every rank must agree on: a stop request, a compaction overflow
  (:func:`agree_max`).

Every function is the identity, or a no-op, on a mesh of one."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from zebra_tpu_torch.parallel.mesh import Mesh


def local_lanes(n_seeds: int, world: int, rank: int) -> range:
    """The global seed lanes rank ``rank`` of ``world`` owns."""
    if n_seeds % world:
        raise ValueError(
            f"parallel_runs ({n_seeds}) must be a multiple of the mesh size "
            f"({world}): the seed axis shards whole seeds per device")
    per = n_seeds // world
    return range(rank * per, (rank + 1) * per)


def all_gather_lanes(mesh: Mesh, a: np.ndarray, axis: int = 1) -> np.ndarray:
    """Per-lane host values ``a`` (this rank's lanes on ``axis``) → every
    lane's, in global order, on every rank."""
    if mesh.size == 1:
        return a
    t = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=axis).numpy()


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def gather_blocks(mesh: Mesh, t: torch.Tensor) -> Optional[torch.Tensor]:
    """This rank's block of the leading axis of ``t`` (its seed lanes, or
    its node rows; the same shape on every rank) → every rank's, in rank
    order, on the CPU at rank 0, None elsewhere. Any dtype (bf16 tables, a
    generator's bytes): the bytes cross."""
    if mesh.size == 1:
        return t.detach().cpu()
    b = _bytes(t)
    parts = ([torch.empty_like(b) for _ in range(mesh.size)] if mesh.lead
             else None)
    dist.gather(b, parts, dst=0)
    if not mesh.lead:
        return None
    shape = (t.shape[0] * mesh.size,) + tuple(t.shape[1:])
    return torch.cat(parts).view(t.dtype).reshape(shape)


def all_gather_blocks(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """:func:`gather_blocks` onto every rank, on ``t``'s device."""
    if mesh.size == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def take_lanes(t: torch.Tensor, lanes: range) -> torch.Tensor:
    """A restore's side of :func:`gather_blocks`: this rank's lanes of every
    lane's ``t``."""
    return t[lanes.start: lanes.stop]


# ------------------------------------------------------------- node rows

def rows_per_rank(n_nodes: int, world: int) -> int:
    """The node rows each rank of a row-sharded mesh holds: N / D. The
    Trainer pads N to a multiple of 128, so D = 2, 4, 8, … divide it; a D
    that does not is refused rather than padded (every rank must hold
    tables of one shape for the exchange and the state file)."""
    if n_nodes % world:
        raise ValueError(
            f"the padded node count ({n_nodes}) must be a multiple of the "
            f"mesh size ({world}): the row-sharded tables split node rows "
            "evenly over the devices")
    return n_nodes // world


def owner(ids, rows: int):
    """The rank that holds each node id of ``ids`` (numpy or torch):
    ``v // rows``, contiguous blocks of ``rows`` ids."""
    return ids // rows


def local_rows(rank: int, rows: int) -> range:
    """The global node ids rank ``rank`` holds."""
    return range(rank * rows, (rank + 1) * rows)


def take_rows(t: torch.Tensor, rank: int, rows: int) -> torch.Tensor:
    """A restore's side of :func:`gather_blocks`: this rank's node rows of
    every row's ``t``."""
    return t[rank * rows: (rank + 1) * rows]


def interleave_permutation(n_nodes: int, n_shards: int) -> np.ndarray:
    """Round-robin relabeling of node ids for owner-aligned waves (a copy of
    ``zebra_tpu/parallel/sharding.py:interleave_permutation``):
    ``new_id = perm[old_id]`` sends old id i to shard i % n_shards under the
    contiguous-row owner layout, ``owner(v) = v // (n_nodes / n_shards)``.
    JODIE-style bipartite numbering puts every user (every src) in one
    contiguous block, so the aligned scheduler would pack every edge into
    shard 0's lane block; interleaving spreads the sources over the blocks.

    A bijection on [0, n_nodes) with the padding id 0 fixed; deterministic
    in (n_nodes, n_shards), so a state file records only the shard count
    (``Config.interleave_shards``) for serving to rebuild it."""
    if n_nodes % n_shards:
        raise ValueError(
            f"n_nodes ({n_nodes}) must be a multiple of n_shards "
            f"({n_shards}) — the Trainer pads N to a multiple of 128")
    i = np.arange(n_nodes, dtype=np.int64)
    rows = n_nodes // n_shards
    return ((i % n_shards) * rows + i // n_shards).astype(np.int32)


def interleave_inverse(n_nodes: int, n_shards: int) -> np.ndarray:
    """The inverse of :func:`interleave_permutation`: ``old_id =
    inv[new_id]``, ``inv[j] = (j % rows) · n_shards + j // rows``."""
    j = np.arange(n_nodes, dtype=np.int64)
    rows = n_nodes // n_shards
    return ((j % rows) * n_shards + j // rows).astype(np.int32)


def agree_max(mesh: Mesh, x: float) -> float:
    """The largest of every rank's ``x``: a flag any rank raised."""
    if mesh.size == 1:
        return float(x)
    t = torch.tensor([float(x)], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (after rank 0 wrote a file the others read)."""
    if mesh.size > 1:
        dist.barrier()
