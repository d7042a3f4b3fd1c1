"""The seed axis over a mesh (counterpart of the seed layout of
``zebra_tpu/parallel/sharding.py``): whole seeds per rank.

Rank r of D owns the seed lanes ``[r·S/D, (r+1)·S/D)`` (:func:`local_lanes`,
JAX's ``seed_base``). Its params, Adam state, dropout generators, negative
bases and memory rows are those lanes' alone; the index and the adjacency
need no replication, since every rank builds them from the same stream.
What crosses ranks is small and on the host:

- the per-batch metrics of a phase, gathered to all S lanes on every rank
  (:func:`all_gather_lanes`) so every rank's early stopping decides alike;
- a state file's lanes, gathered to rank 0, which writes one file in the
  one-process layout (:func:`gather_lanes`); a restore keeps each rank's
  lanes of it (:func:`take_lanes`);
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


def gather_lanes(mesh: Mesh, t: torch.Tensor) -> Optional[torch.Tensor]:
    """This rank's lanes of ``t`` (leading axis, the same shape on every
    rank) → every lane's on the CPU at rank 0, None elsewhere. Any dtype
    (bf16 tables, a generator's bytes): the bytes cross."""
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


def take_lanes(t: torch.Tensor, lanes: range) -> torch.Tensor:
    """A restore's side of :func:`gather_lanes`: this rank's lanes of every
    lane's ``t``."""
    return t[lanes.start: lanes.stop]


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
