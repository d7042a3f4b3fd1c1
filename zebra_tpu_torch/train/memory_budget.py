"""The device-memory guard (counterpart of the JAX Trainer's
``_check_hbm_budget``, ``zebra_tpu/train/loop.py:573-668``): before any
epoch, whether a rank's node tables fit its card through validate() and
test(), and with which backup protocol.

The tables of S_local seed lanes of N rows each take ``S_local · N ·
per_row`` bytes (:func:`row_bytes`: the memory row, the pending-message row
with its flag column, three f32 columns), and the streaming index ``N ·
M(4k+1) · 4`` more (:func:`index_bytes`). validate() and test() hold
several copies of the tables at their peak:

- the device protocol: the train-end tables beside the flushed ones, then
  the val-end tables beside the test leg's copy;
- the host protocol (``host_backup``): the backups wait in host memory, so
  the device holds the working tables alone, flushed in place.

The constants come from ``torch.cuda.max_memory_allocated`` over
validate() + test() on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py``
phase 13, the flagship's widths: bs 200, two members, top-20, dims 100):
the peak's growth per seed, at two seed counts on two streams of different
node counts, splits into each protocol's table copies
(:data:`DEVICE_COPIES`, :data:`HOST_COPIES`, the resident tables included)
and a seed's batch activations (:data:`LANE_BATCH_BYTES`, which do not
grow with N); the flush's scratch grows with the rows, not the seeds (it
flushes one seed at a time): :data:`FLUSH_ROW_BYTES` per node row, the
peak of one seed's flush; the usable share of the card's free memory
(:data:`USABLE_SHARE`) is the allocated bytes over the allocator's
reserved bytes at the host protocol's peak. The index is counted twice in
both protocols (the train-end index beside the val leg's copy).

A rank of a row-sharded run (one seed over D ranks) holds N/D rows of
the tables and of the index, and the guard counts those (as the JAX guard
counts ``ceil(N/D)``, ``zebra_tpu/train/loop.py:607-622``); a batch block
of b/D events holds about 1/D of a seed's batch activations, which the
guard still counts whole (not measured per block). Besides, every rank
holds whole what the caller counts as ``extra`` bytes: the adjacency
indices of the pruning strategy and the recursive towers
(:func:`adjacency_bytes`, one process too), a row-sharded recursive
tower's per-batch fetch at the largest batch (:func:`fetch_bytes`), and
``--task node``'s replay at full N (:func:`replay_bytes`).

``host_backup`` None picks the host protocol when only it fits; a
protocol that does not fit raises "HBM budget exceeded" (the JAX
package's words). On the CPU there is no accounting, and nothing is
checked."""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import torch

from zebra_tpu_torch.config import RECURSIVE, Config, torch_dtype

logger = logging.getLogger("zebra_tpu_torch")

# two runs measured 2.545 and 2.539 copies, 0.954 and 0.967 (the resident
# copy alone: taken as 1), 71,180,325 and 70,977,106 B, 5,786 and 5,794 B,
# 0.843 and 0.822; each rounded away from the risky side
DEVICE_COPIES = 2.6
HOST_COPIES = 1.0
LANE_BATCH_BYTES = 72_000_000
FLUSH_ROW_BYTES = 5_800
INDEX_COPIES = 2
USABLE_SHARE = 0.82


def row_bytes(cfg: Config) -> int:
    """Bytes of one node row of the memory tables."""
    size = lambda name: torch.empty((), dtype=torch_dtype(name)).element_size()
    return (cfg.memory_dim * size(cfg.memory_dtype)
            + (cfg.msg_table_dim + 1) * size(cfg.message_dtype)
            + 3 * 4)    # last_update, msg_ts, msg_count


def index_bytes(cfg: Config, n_rows: Optional[int] = None) -> int:
    """Bytes of the streaming index, [N, M(4k+1)] f32, or of ``n_rows`` of
    its rows (0 where none is kept)."""
    if not cfg.keeps_tppr_index:
        return 0
    rows = cfg.n_nodes if n_rows is None else n_rows
    return rows * cfg.n_tppr * (4 * cfg.topk + 1) * 4


def adjacency_bytes(*indices) -> int:
    """Device bytes of adjacency indices (``NeighborIndex``; None counts
    0)."""
    return sum(x.numel() * x.element_size() for ix in indices
               if ix is not None
               for x in (ix.arena, ix.offsets, ix.keys, ix.times))


def fetch_bytes(cfg: Config, world: int) -> int:
    """A row-sharded recursive tower's fetch of one batch at its largest:
    the packed request and the received rows, D·L rows each, where a block
    names at most L = 3b/D·(1 + n + … + n^L) distinct ids (0 for one rank
    or another tower)."""
    if world <= 1 or cfg.embedding_module not in RECURSIVE:
        return 0
    ids = 3 * cfg.bs * sum(cfg.n_degree ** h for h in range(cfg.n_layer + 1))
    return 2 * ids * row_bytes(cfg)


def replay_bytes(cfg: Config, world: int) -> int:
    """``--task node`` on a row-sharded rank: the replay's fresh tables and
    index at full N (0 for one rank or link prediction)."""
    if world <= 1 or cfg.task != "node":
        return 0
    return cfg.n_nodes * row_bytes(cfg) + index_bytes(cfg)


class Budget(NamedTuple):
    tables: int       # S_local · rows · per_row
    device: float     # the device protocol's estimate
    host: float       # the host protocol's estimate
    usable: float     # USABLE_SHARE of the free bytes

    def decide(self, host_backup: Optional[bool]) -> str:
        """"device", "host" or "refused" for a ``host_backup`` setting."""
        if host_backup is None:
            host_backup = self.device > self.usable >= self.host
        est = self.host if host_backup else self.device
        if est > self.usable:
            return "refused"
        return "host" if host_backup else "device"


def budget(cfg: Config, s_local: int, free_bytes: int,
           n_rows: Optional[int] = None, extra: int = 0) -> Budget:
    """The estimates of ``s_local`` lanes of ``n_rows`` rows each (all
    ``cfg.n_nodes``; a row-sharded rank's N/D), with ``extra`` bytes held
    throughout, against ``free_bytes`` of device memory."""
    rows = cfg.n_nodes if n_rows is None else n_rows
    tables = s_local * rows * row_bytes(cfg)
    rest = (INDEX_COPIES * index_bytes(cfg, rows) + LANE_BATCH_BYTES * s_local
            + FLUSH_ROW_BYTES * rows + extra)
    return Budget(tables, DEVICE_COPIES * tables + rest,
                  HOST_COPIES * tables + rest, USABLE_SHARE * free_bytes)


def check_memory_budget(cfg: Config, s_local: int, device,
                        n_rows: Optional[int] = None,
                        extra: int = 0) -> bool:
    """Whether validate() and test() keep their table backups in host
    memory: ``cfg.host_backup``, or where it is None, whether only the host
    protocol fits. Raises where the protocol chosen does not fit the free
    memory of ``device``; on the CPU returns ``bool(cfg.host_backup)``.
    ``n_rows`` is the node rows of a lane on this device (a row-sharded
    rank's N/D; all N by default), ``extra`` the bytes held whole besides
    (module docstring)."""
    device = torch.device(device)
    if device.type != "cuda":
        return bool(cfg.host_backup)
    free, total = torch.cuda.mem_get_info(device)
    rows = cfg.n_nodes if n_rows is None else n_rows
    b = budget(cfg, s_local, free, rows, extra)
    decision = b.decide(cfg.host_backup)
    gib = lambda x: x / 2**30
    if decision == "refused":
        # auto falls back to the host protocol only where it fits
        copies, est = ((HOST_COPIES, b.host) if cfg.host_backup
                       else (DEVICE_COPIES, b.device))
        raise ValueError(
            f"node-table HBM budget exceeded: ~{gib(est):.1f} GiB estimated "
            f"on {device} ({s_local} seed(s) × {rows} rows × "
            f"{row_bytes(cfg)} B, ×{copies} for the val/test backup "
            f"protocol, + the batches' activations, a flush's scratch and "
            f"the index ×{INDEX_COPIES}, {gib(extra):.2f} GiB held whole: "
            f"adjacency, fetch, replay)"
            f" against a usable "
            f"~{gib(b.usable):.1f} GiB of {gib(free):.1f} GiB free "
            f"({gib(total):.1f} GiB on the card). Reduce --parallel_runs, "
            "shard seeds or node rows over more devices (--n_devices), or "
            "shrink --memory_dim/--topk.")
    if decision == "host" and cfg.host_backup is None:
        logger.info(
            "val/test table backups will live in host memory (--host_backup "
            "auto: the device protocol needs ~%.1f GiB of the usable ~%.1f "
            "GiB, the host protocol ~%.1f GiB; --no_host_backup forces the "
            "device protocol)", gib(b.device), gib(b.usable), gib(b.host))
    return decision == "host"
