"""The port's device mesh (counterpart of ``zebra_tpu/parallel/mesh.py``):
one process per device, so a mesh of D devices is a process group of D
ranks, and a rank's part of it is the world size, its rank, its local rank
and its device.

``make_mesh``'s rules are the JAX package's: ``n_devices`` 0 means every
device of the run (every rank of the group; one without a group), and a
request for more devices than exist raises. ``n_devices`` 1 is this process
alone, whatever group exists."""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.parallel.distributed import rank, world_size


@dataclass(frozen=True)
class Mesh:
    size: int             # D ranks, one device each
    rank: int
    local_rank: int       # this rank's place on its host
    device: torch.device  # this rank's device

    @property
    def lead(self) -> bool:
        """Whether this rank writes the run's files and log (rank 0)."""
        return self.rank == 0


def local_rank() -> int:
    """This process's place on its host: ``LOCAL_RANK`` (the launcher and
    torchrun set it; a multi-host run started by hand must), else the
    rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank_device(device, local: int) -> torch.device:
    """A rank's device: ``device`` as given when it names one card
    (``cuda:0``: every rank on it) or the CPU, else ``cuda:{local}``.
    Raises where that card does not exist: a rank is never moved to
    another card, nor to the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"local rank {local} would run on cuda:{local}, but {n} CUDA "
            f"device(s) are visible; pass --device cuda:0 (device="
            "'cuda:0') to put every rank on one card")
    return torch.device("cuda", local)


def make_mesh(n_devices: int = 1, device=None) -> Mesh:
    """This rank's part of a mesh of ``n_devices`` devices (module
    docstring) on ``device`` (see :func:`rank_device`)."""
    world = world_size()
    d = world if n_devices <= 0 else int(n_devices)
    if d == 1:
        return Mesh(1, 0, 0, resolve_device(device))
    if d > world:
        raise ValueError(
            f"requested {d} devices, have {world}: a mesh of D devices is a "
            "process group of D ranks (python -m zebra_tpu_torch.train "
            "--n_devices D starts them; --dist_* or ZEBRA_* join a group "
            "started by hand)")
    if d < world:
        raise ValueError(
            f"requested {d} devices, but the process group has {world} "
            "ranks: one process per device (--n_devices 0 takes them all)")
    local = local_rank()
    return Mesh(d, rank(), local, rank_device(device, local))
