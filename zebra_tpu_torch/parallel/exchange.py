"""The row exchange of the row-sharded layout: node rows of the memory
tables and the T-PPR index moved between ranks as device tensors, through
``torch.distributed`` collectives (the port's counterpart of the
all-to-alls that XLA's SPMD inserts into the JAX package's row-sharded
phases, ``docs/SCALING.md``, "How the collectives arise").

Rank r holds the rows ``[r·N/D, (r+1)·N/D)`` (``sharding.owner``). The
exchange offers:

- :meth:`RowExchange.fetch`: the rows of node ids, exact. Every rank fills
  the rows it owns of every requested id into a fixed buffer (any row for
  an id it does not own), one collective moves the buffers, and each row
  is picked from its owner's part. Ids the same on every rank (a wave's)
  take an ``all_gather``; ids that differ by rank (a batch block's; every
  rank knows every rank's) an ``all_to_all``. Nothing is read back to the
  host and nothing is summed: the packed index rows carry ids as f32 bits,
  which a sum with zeros could change.
- :meth:`RowExchange.send`: rows written at their owners. Every rank's
  rows cross in one ``all_gather`` (:meth:`RowExchange.gather_rows`); each
  owner copies in the ones it owns, which the caller names (the write set
  is known on the host).
- :meth:`RowExchange.all_reduce_` of the gradients, and
  :meth:`RowExchange.all_gather` of a phase's scores.

A row of several tables crosses as one row of bytes (bf16 and f32 columns
unchanged). The backend follows from the layout, decided once when the
exchange is made: NCCL where every rank has a card of its own, Gloo where
ranks share a card (``--device cuda:0``) or run on the CPU (NCCL refuses
two ranks on one device). Gloo takes the CUDA tensors as they are (torch
2.11 stages them through the host itself). Neither form is tried and then
replaced by the other.

Every call counts its bytes (the collective's output on this rank) and its
host seconds by kind (:attr:`RowExchange.stats`), and a fetch the ids it
moved beside the ids they stand for where the caller made them distinct
(:attr:`RowExchange.ids`). A collective on CUDA
tensors waits for the device work queued before it, and for the slowest
rank, so those seconds hold both besides the transfer."""

from __future__ import annotations

import logging
import socket
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from zebra_tpu_torch.parallel.mesh import Mesh
from zebra_tpu_torch.parallel.sharding import owner, rows_per_rank

logger = logging.getLogger("zebra_tpu_torch")

# ``all_gather_into_tensor`` became ``all_gather_single`` after torch 2.11
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def _pack(tables: Sequence[torch.Tensor], idx=None) -> torch.Tensor:
    """Rows ``idx`` (all rows when None) of tables with one leading row axis
    → uint8 [n, bytes per row]."""
    parts = []
    for t in tables:
        x = t if idx is None else t.index_select(0, idx)
        parts.append(x.reshape(x.shape[0], -1).contiguous().view(torch.uint8))
    return torch.cat(parts, dim=1)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    """uint8 rows [n, B] → one tensor per table of ``like`` ([n, ...] in its
    dtype)."""
    out, at = [], 0
    for t in like:
        width = t[:1].numel() * t.element_size()
        # a fresh buffer: a column slice (of one row, say) need not meet
        # the alignment a view as a wider dtype asks for
        part = torch.empty((buf.shape[0], width), dtype=torch.uint8,
                           device=buf.device).copy_(buf[:, at: at + width])
        out.append(part.view(t.dtype).reshape((buf.shape[0],) + t.shape[1:]))
        at += width
    return out


class RowExchange:
    """The row exchange of one rank (module docstring). Every rank makes
    it at the same point, with the same ``n_nodes``: it joins a collective
    (the ranks' hosts and devices) and, for NCCL, makes a group."""

    def __init__(self, mesh: Mesh, n_nodes: int):
        self.mesh = mesh
        self.rows = rows_per_rank(n_nodes, mesh.size)
        self.lo = mesh.rank * self.rows
        layout = [None] * mesh.size
        dist.all_gather_object(layout, (socket.gethostname(),
                                        str(mesh.device)))
        self.hosts = len({host for host, _ in layout})
        own_cards = (mesh.device.type == "cuda"
                     and len(set(layout)) == mesh.size)
        self.backend = "nccl" if own_cards else "gloo"
        if own_cards:
            torch.cuda.set_device(mesh.device)
            self.group = dist.new_group(backend="nccl")
        elif dist.get_backend() != "gloo":
            self.group = dist.new_group(backend="gloo")
        else:
            self.group = None
        # kind → [calls, bytes, seconds]
        self.stats: Dict[str, List[float]] = {}
        # a fetch's kind → [ids fetched, ids they stand for]
        self.ids: Dict[str, List[int]] = {}
        logger.info("row exchange: %d ranks on %d host(s), %s backend, "
                    "%d node rows per rank", mesh.size, self.hosts,
                    self.backend, self.rows)

    def reset_stats(self) -> None:
        self.stats, self.ids = {}, {}

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        s = self.stats.setdefault(kind, [0, 0, 0.0])
        s[0] += 1
        s[1] += int(nbytes)
        s[2] += time.perf_counter() - t0

    def fetch(self, tables: Sequence[torch.Tensor], ids: torch.Tensor,
              kind: str, named: Optional[int] = None) -> List[torch.Tensor]:
        """This rank's rows of the global node ids ``ids`` from every
        table of ``tables`` (this rank's shards, [N/D, ...] each): ``ids``
        [L] the same on every rank, or [D, L] with rank j's ids in row j
        (this rank's are row ``rank``). Returns one [L, ...] tensor per
        table. ``named``, where the caller made ``ids`` distinct, is the
        count of ids it stands for (:attr:`ids`)."""
        t0 = time.perf_counter()
        d = self.mesh.size
        same = ids.dim() == 1
        n = ids.shape[-1]
        idx = (ids.reshape(-1) - self.lo).clamp(0, self.rows - 1)
        buf = _pack(tables, idx)                  # [L or D·L, B]
        out = torch.empty((d * n, buf.shape[1]), dtype=torch.uint8,
                          device=buf.device)
        if same:
            _all_gather(out, buf, group=self.group)
        else:
            # block j of buf goes to rank j; block s of out came from rank s
            dist.all_to_all_single(out, buf, group=self.group)
        mine = ids if same else ids[self.mesh.rank]
        pick = owner(mine, self.rows) * n + torch.arange(
            n, device=ids.device)
        rows = _unpack(out.index_select(0, pick), tables)
        self._count(kind, out.numel(), t0)
        counts = self.ids.setdefault(kind, [0, 0])
        counts[0] += ids.numel()
        counts[1] += ids.numel() if named is None else int(named)
        return rows

    def gather_rows(self, values: Sequence[torch.Tensor],
                    kind: str) -> List[torch.Tensor]:
        """Every rank's rows ``values`` ([n, ...] per table, n the same on
        every rank) → [D·n, ...] per table, in rank order."""
        t0 = time.perf_counter()
        buf = _pack(values)
        out = torch.empty((self.mesh.size * buf.shape[0], buf.shape[1]),
                          dtype=torch.uint8, device=buf.device)
        _all_gather(out, buf, group=self.group)
        self._count(kind, out.numel(), t0)
        return _unpack(out, values)

    def send(self, tables: Sequence[torch.Tensor],
             values: Sequence[torch.Tensor], take: torch.Tensor,
             rows: torch.Tensor, kind: str) -> None:
        """Write rows at their owners: ``values`` holds this rank's rows,
        [n, ...] per table (n the same on every rank); ``take`` [m] the
        entries of every rank's rows, flat in rank order (D·n), that this
        rank owns, and ``rows`` [m] their local row ids in ``tables``
        (copied in place, each row once)."""
        got = self.gather_rows(values, kind)
        for t, v in zip(tables, got):
            t.index_copy_(0, rows, v.index_select(0, take))

    def all_reduce_(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same
        bits."""
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.group)
        self._count(kind, t.numel() * t.element_size(), t0)
        return t

    def all_gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each, at least one axis) →
        [D, ...] in rank order."""
        t0 = time.perf_counter()
        t = t.contiguous()
        out = torch.empty((self.mesh.size * t.shape[0],) + t.shape[1:],
                          dtype=t.dtype, device=t.device)
        _all_gather(out, t, group=self.group)
        self._count(kind, out.numel() * out.element_size(), t0)
        return out.view((self.mesh.size,) + t.shape)
