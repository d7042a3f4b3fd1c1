"""Start D local ranks of a sharded run: ``launch(fn, D, args)`` runs
``fn(*args)`` in D spawned processes, each a rank of one Gloo group that
meets at a ``FileStore`` in a fresh temporary directory (no port to pick,
so two runs on one host never collide), with ``LOCAL_RANK`` set and
``threads`` intra-op threads. It returns when every rank has returned, and
raises if any rank failed (the others are then ended), so a command built
on it exits non-zero. ``fn`` must be importable by name: the ranks start
from a fresh interpreter.

While it waits, a SIGTERM to this process goes on to every rank (the
training CLI's ranks stop at the next superchunk and write a state file),
and SIGINT is left to the ranks, which a terminal's Ctrl-C reaches
directly."""

from __future__ import annotations

import os
import signal
import tempfile
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world: int, store: str,
               threads: Optional[int], args: Sequence) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, args: Sequence = (),
           threads: Optional[int] = None) -> None:
    """Run ``fn(*args)`` on ``n_ranks`` local ranks (module docstring)."""
    with tempfile.TemporaryDirectory(prefix="zebra_ranks_") as tmp:
        ranks = mp.start_processes(
            _rank_main, args=(fn, n_ranks, os.path.join(tmp, "store"),
                              threads, tuple(args)),
            nprocs=n_ranks, join=False, start_method="spawn")

        def forward(signum, frame):
            for p in ranks.processes:
                if p.is_alive():
                    os.kill(p.pid, signum)

        prev = {}
        try:
            prev[signal.SIGTERM] = signal.signal(signal.SIGTERM, forward)
            prev[signal.SIGINT] = signal.signal(signal.SIGINT,
                                                signal.SIG_IGN)
        except ValueError:  # not the main thread: signals stay as they are
            prev.clear()
        try:
            while not ranks.join():
                pass
        finally:
            for sig, handler in prev.items():
                signal.signal(sig, handler)
