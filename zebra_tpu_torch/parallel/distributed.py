"""The process group of a sharded run (counterpart of
``zebra_tpu/parallel/distributed.py``).

One process per device: a mesh of D devices is a ``torch.distributed``
group of D ranks. The group's backend is Gloo: the host arrays a run
exchanges (a phase's metrics, stop flags, a state file's lanes or rows)
cross it as CPU tensors, on the CPU and on the card alike. The row
exchange of a row-sharded run moves device tensors, over this group or an
NCCL group of its own where every rank has a card
(``parallel/exchange.py``).

The group comes from flags or the JAX package's environment variables
(``ZEBRA_COORDINATOR``, ``ZEBRA_NUM_PROCESSES``, ``ZEBRA_PROCESS_ID``):
:func:`initialize_distributed`. ``python -m zebra_tpu_torch.train
--n_devices D`` without them starts D local ranks itself
(:mod:`zebra_tpu_torch.parallel.launch`)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the Gloo group at ``tcp://{coordinator}`` when more than one
    process is asked for; returns True if a group was brought up. A no-op
    (False) for one process. The environment variables fill in values the
    command line left at their single-process defaults (the CLI always
    passes ints: "unset" means ``num_processes`` ≤ 1, ``process_id`` 0)."""
    coordinator = coordinator or os.environ.get("ZEBRA_COORDINATOR")
    env_np = os.environ.get("ZEBRA_NUM_PROCESSES")
    if (num_processes is None or num_processes <= 1) and env_np:
        num_processes = int(env_np)
    env_pid = os.environ.get("ZEBRA_PROCESS_ID")
    if (process_id is None or process_id == 0) and env_pid:
        process_id = int(env_pid)
    if num_processes is None or num_processes <= 1:
        return False
    if not coordinator:
        raise ValueError(
            "multi-process run needs a coordinator address "
            "(--dist_coordinator or ZEBRA_COORDINATOR)"
        )
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id or 0))
    return True


def world_size() -> int:
    """Ranks of the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def broadcast_one_to_all(x) -> np.ndarray:
    """Rank 0's value of the array ``x`` (the same shape and dtype on every
    rank) on every rank; ``x`` itself without a group. Under
    ``--enable_random`` the ranks draw different negative bases, and rank
    0's must win, or their negatives and wave plans would differ."""
    a = np.ascontiguousarray(x)
    if world_size() == 1:
        return a
    t = torch.from_numpy(a.copy())
    dist.broadcast(t, src=0)
    return t.numpy()
