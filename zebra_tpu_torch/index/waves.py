"""Wave-parallel streaming T-PPR scan (counterpart of
``zebra_tpu/index/waves.py``).

The SANTA recurrence is sequential per node, not per edge: an edge depends
only on earlier edges that touched its src, dst (rows it writes) or neg (a
row it reads for extraction). The host scheduler (``csrc/wave_schedule.cc``,
a copy of the JAX package's C++ one) cuts a chunk of the stream into waves
of pairwise node-disjoint edges, at most ``cap`` each, such that every
dependency crosses a wave boundary. Within a wave all reads precede all
writes, so the wave scan is bit-equal to the sequential scan
(``streaming_scan``).

Per chunk the host turns the schedule into a :class:`WavePlan`: the stream
positions of the scheduled events in wave order, each event's place in that
order, where each wave starts, and the redirect list (:func:`redirects`:
each negative that a lane reads from a row its wave writes, and the lane
that writes it), uploaded in one copy. On the card the whole chunk is one
launch of ``csrc/santa_waves.cu`` (``wave_kernel.SANTA_WAVES``), as the
JAX package runs it as one XLA program: one thread-block cluster whose
lanes take a wave's events; a redirected negative's pre-wave row comes from
its writer, so the merge writes straight into the table, and one cluster
barrier per wave orders its writes before the next wave's reads; the
extraction rows come out in stream order. On the CPU,
:func:`wave_scan_reference` runs the waves one by one (gather → merge →
scatter, ``scan.step``): the columns gathered into wave order once, each
wave a contiguous slice. Only the real waves run: the JAX package pads the
wave count to few distinct values so that XLA compiles few programs.

Row-sharded (``zebra_tpu_torch/parallel/``), each rank holds a block of
the index's rows and the waves stay a loop, since a host exchange separates
them: a wave's W·R rows come through one fetch of the row exchange, every
rank merges every lane (one ``santa_merge`` launch on the card), and each
rank writes the new rows it owns, which its plan lists (``WavePlan.own_*``,
from the host columns). Every rank then holds the whole chunk's extraction
rows. With ``n_shards`` > 1 the scheduler aligns the lanes to the owners
of the sources (``csrc/wave_schedule.cc``); a wave's lanes are laid out
compact either way, so an aligned wave with an empty block is a narrower
launch."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from zebra_tpu_torch import build
from zebra_tpu_torch.index.layout import TpprParams
from zebra_tpu_torch.index.scan import sharded_step, step
from zebra_tpu_torch.index.streaming import TpprState, _columns
from zebra_tpu_torch.index.wave_kernel import SANTA_WAVES


@functools.lru_cache(maxsize=None)
def _scheduler():
    """``zt_wave_schedule_multi`` of the host library, built at first use."""
    i32p = ctypes.POINTER(ctypes.c_int32)
    fn = build.load("wave_schedule").zt_wave_schedule_multi
    fn.argtypes = [i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p, i32p]
    fn.restype = ctypes.c_int64
    return fn


def wave_schedule(src, dst, neg, n_nodes: int, cap: int,
                  n_shards: int = 1) -> Tuple[np.ndarray, np.ndarray, int]:
    """Greedy dependency-respecting waves of at most ``cap`` edges: returns
    (wave [E] i32, slot [E] i32, n_waves). ``neg`` is [E], or [S, E] for
    the seed-parallel trainer's one scan that extracts every seed's
    negative ([1, E] gives the schedule of [E]). ``n_shards`` > 1 aligns
    the lanes to the sources' owners (module docstring): slot s of a wave
    lies in the block of shard s // (cap / n_shards), and ``cap`` must be a
    multiple of ``n_shards``. Refuses node ids outside [0, n_nodes)."""
    if n_shards > 1 and cap % n_shards:
        raise ValueError(
            f"wave_cap {cap} must be a multiple of n_shards {n_shards}")
    src, dst = (np.ascontiguousarray(c, np.int32) for c in (src, dst))
    negs = np.ascontiguousarray(np.atleast_2d(np.asarray(neg, np.int32)))
    n = len(src)
    if len(dst) != n or negs.ndim != 2 or negs.shape[1] != n:
        raise ValueError(
            f"src, dst and neg must cover the same edges, got {len(src)}, "
            f"{len(dst)} and neg {negs.shape}")
    wave, slot = np.empty(n, np.int32), np.empty(n, np.int32)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    n_waves = _scheduler()(ptr(src), ptr(dst), ptr(negs), negs.shape[0], n,
                           int(n_nodes), int(cap), max(1, int(n_shards)),
                           ptr(wave), ptr(slot))
    if n_waves < 0:
        raise ValueError(
            f"wave_schedule: node id out of range [0, {n_nodes})" if n_waves == -1
            else f"wave_schedule: wave cap must be positive, got {cap}")
    return wave, slot, int(n_waves)


def wave_flat_index(src, dst, neg, n_nodes: int, cap: int = 64,
                    n_shards: int = 1) -> Tuple[np.ndarray, int]:
    """The schedule as one slot per edge, ``wave·cap + lane`` [E] i32, and
    the real wave count (no padding of the count)."""
    wave, slot, n_waves = wave_schedule(src, dst, neg, n_nodes, cap,
                                        n_shards)
    return wave.astype(np.int32) * cap + slot, n_waves


class WavePlan(NamedTuple):
    """One chunk's schedule, laid out for the device."""

    order: torch.Tensor        # i64 [E'] stream positions of the scheduled
                               # events, wave after wave, lanes in order
    inv: torch.Tensor          # i64 [E] each event's place in ``order``;
                               # E' for an unscheduled (invalid) event
    bounds: Tuple[int, ...]    # wave w is order[bounds[w]:bounds[w + 1]]
    order32: torch.Tensor      # ``order`` and ``bounds`` as i32 on the
    bounds32: torch.Tensor     # device: what santa_waves reads
    # the redirect list (:func:`redirects`), what santa_waves reads too:
    # i32 [n, 4] rows (writer's place in ``order``, reader's stream
    # position, negative slot, 0 if the writer's src row is the one read
    # or 1 for its dst row) sorted by writer; i32 [E' + 1] where each
    # writer's rows start; u8 [E', S] 1 where the reader at that place
    # skips the negative
    redirect: Optional[torch.Tensor] = None
    redirect_start: Optional[torch.Tensor] = None
    redirect_mask: Optional[torch.Tensor] = None
    # row-sharded only (None otherwise): the written rows this rank owns,
    # as entries of the [2E'] rows the waves write (src, dst per lane, in
    # order), their local row ids, and wave w's part of both,
    # [own_bounds[w], own_bounds[w + 1])
    own_pos: Optional[torch.Tensor] = None
    own_rows: Optional[torch.Tensor] = None
    own_bounds: Optional[Tuple[int, ...]] = None

    @property
    def n_waves(self) -> int:
        return len(self.bounds) - 1

    @property
    def width(self) -> int:
        """The widest wave's lanes (0 without waves)."""
        return int(np.diff(self.bounds).max()) if self.n_waves else 0


def _upload(arrays, device) -> list:
    """The numpy ``arrays`` on ``device`` through one host-to-device copy:
    packed into one byte buffer at 8-byte offsets, then sliced and viewed
    back as their dtypes and shapes."""
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 8) * 8
    buf = np.zeros(max(total, 8), np.uint8)
    for a, o in zip(arrays, offsets):
        buf[o: o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
            np.uint8)
    on_dev = torch.from_numpy(buf).to(device)
    return [on_dev[o: o + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .view(a.shape) for a, o in zip(arrays, offsets)]


@functools.lru_cache(maxsize=None)
def _redirect_lister():
    """``zt_wave_redirects`` of the host library, built at first use."""
    i32p, i64p = (ctypes.POINTER(t) for t in (ctypes.c_int32, ctypes.c_int64))
    fn = build.load("wave_schedule").zt_wave_redirects
    fn.argtypes = [i32p, i32p, i32p, ctypes.c_int32, i64p, ctypes.c_int64,
                   i64p, ctypes.c_int32, ctypes.c_int64, i32p, i32p,
                   ctypes.POINTER(ctypes.c_uint8)]
    fn.restype = ctypes.c_int64
    return fn


def redirects(src, dst, neg, order, bounds, n_nodes: int):
    """Every same-wave write after read of a schedule: a negative that a
    lane reads from a row which a lane of its wave writes (a later lane, or
    the lane itself; the schedule forbids an earlier one). Host columns
    (``neg`` [E] or [E, S]), ``order`` and ``bounds`` as :class:`WavePlan`
    holds them. Returns (list [n, 4] i32: writer's place in ``order``,
    reader's stream position, negative slot, 0 for the writer's src row or
    1 for its dst row (src for a self-loop), sorted by writer, then reader,
    then slot; start [E' + 1] i32, where each writer's rows start; mask
    [E', S] u8, 1 where the reader at that place skips the negative).
    Built by ``zt_wave_redirects`` (``csrc/wave_schedule.cc``) in one pass
    over the waves."""
    src, dst = (np.ascontiguousarray(c, np.int32) for c in (src, dst))
    negs = np.ascontiguousarray(np.asarray(neg, np.int32).reshape(len(src),
                                                                  -1))
    order = np.ascontiguousarray(order, np.int64)
    bounds = np.ascontiguousarray(bounds, np.int64)
    n_sched, n_neg = len(order), negs.shape[1]
    rows = np.empty((n_sched * n_neg, 4), np.int32)
    start = np.empty(n_sched + 1, np.int32)
    mask = np.empty((n_sched, n_neg), np.uint8)
    ptr = lambda a, t=ctypes.c_int32: a.ctypes.data_as(ctypes.POINTER(t))
    n = _redirect_lister()(
        ptr(src), ptr(dst), ptr(negs), n_neg, ptr(order, ctypes.c_int64),
        n_sched, ptr(bounds, ctypes.c_int64), len(bounds) - 1, int(n_nodes),
        ptr(rows), ptr(start), ptr(mask, ctypes.c_uint8))
    if n < 0:
        raise ValueError(f"redirects: node id out of range [0, {n_nodes})")
    return rows[:n].copy(), start, mask


def plan_waves(src, dst, neg, valid, n_nodes: int, cap: int, device,
               n_shards: int = 1, rows: Optional[range] = None) -> WavePlan:
    """Schedule the valid events of a chunk (host numpy columns; ``neg``
    [E], or [E, S] with one negative per seed) and lay the schedule out as
    a :class:`WavePlan` on ``device``, in one upload. ``n_shards`` aligns
    the lanes to the sources' owners; ``rows``, the global ids a rank of a
    row-sharded index holds, adds the rows it writes (``own_*``)."""
    valid = np.asarray(valid, bool)
    pos = np.flatnonzero(valid)
    flat, n_waves = wave_flat_index(np.asarray(src)[pos], np.asarray(dst)[pos],
                                    np.asarray(neg)[pos].T, n_nodes, cap,
                                    n_shards)
    by_slot = np.argsort(flat, kind="stable")
    order = pos[by_slot]
    counts = np.bincount(flat[by_slot] // cap, minlength=n_waves)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    inv = np.full(len(valid), len(pos), np.int64)
    inv[order] = np.arange(len(pos))
    host = [order.astype(np.int64), inv, order.astype(np.int32),
            bounds.astype(np.int32),
            *redirects(src, dst, neg, order, bounds, n_nodes)]
    own_bounds = None
    if rows is not None:
        written = np.stack([np.asarray(src)[order], np.asarray(dst)[order]],
                           axis=1).reshape(-1).astype(np.int64)
        own_pos = np.flatnonzero((written >= rows.start)
                                 & (written < rows.stop))
        host += [own_pos.astype(np.int64),
                 written[own_pos] - rows.start]
        own_bounds = tuple(int(b) for b in np.searchsorted(own_pos,
                                                           2 * bounds))
    d_order, d_inv, order32, bounds32, *rest = _upload(host, device)
    return WavePlan(d_order, d_inv, tuple(int(b) for b in bounds), order32,
                    bounds32, *rest[:3], *(rest[3:] or (None, None)),
                    own_bounds)


def _wave_layout(data, src, dst, neg, t, eidx, plan: WavePlan):
    """The chunk's columns gathered into wave order once, for a loop over
    the waves (wave w is the slice ``plan.bounds[w]:plan.bounds[w + 1]``):
    the row ids [E', 2+S] of each lane (src, dst, negatives), the written
    rows' ids [2E'], the [E' + 1, 2+S, F] extraction buffer whose last row
    is the zero row of the unscheduled events, and (src, dst, eidx, t)."""
    order = plan.order
    w_src, w_dst, w_neg, w_t, w_eidx = (
        c.index_select(0, order) for c in (src, dst, neg, t, eidx))
    ids = torch.cat([w_src[:, None], w_dst[:, None],
                     w_neg.view(order.shape[0], -1)], dim=1).to(torch.int64)
    n_sched, f = order.shape[0], data.shape[1]
    rows = torch.empty((n_sched + 1, ids.shape[1], f), dtype=data.dtype,
                       device=data.device)
    rows[n_sched] = 0.0
    return ids, ids[:, :2].reshape(-1), rows, (w_src, w_dst, w_eidx, w_t)


def _waves(plan: WavePlan):
    """(w, lo, hi) of each non-empty wave."""
    bounds = plan.bounds
    return [(w, lo, hi) for w, (lo, hi) in enumerate(zip(bounds[:-1],
                                                          bounds[1:]))
            if hi > lo]


def wave_scan_reference(data: torch.Tensor, params: TpprParams, src, dst,
                        neg, t, eidx, plan: WavePlan,
                        merge=None) -> torch.Tensor:
    """The plain wave scan, one ``scan.step`` per wave, on the CPU or the
    card: updates ``data`` [N, F] in place and returns the pre-edge rows
    [E, 2+S, F] in stream order, zero for unscheduled events. Columns as
    ``_columns`` gives them. ``merge`` is the step's merge: ``None`` for
    ``merge.merge_both`` (the plain merge for a CPU tensor, one
    ``santa_merge`` launch per wave for a CUDA one), or
    ``merge.merge_both_reference``."""
    ids, write_ids, rows, cols = _wave_layout(data, src, dst, neg, t, eidx,
                                              plan)
    kw = {} if merge is None else dict(merge=merge)
    for _, lo, hi in _waves(plan):
        step(data, ids[lo:hi], rows[lo:hi], *(c[lo:hi] for c in cols), None,
             params, write_ids=write_ids[2 * lo: 2 * hi], **kw)
    return rows.index_select(0, plan.inv)


def _wave_scan_sharded(data: torch.Tensor, params: TpprParams, src, dst,
                       neg, t, eidx, plan: WavePlan,
                       exchange) -> torch.Tensor:
    """:func:`wave_scan_reference` on a row-sharded index: one
    :func:`~zebra_tpu_torch.index.scan.sharded_step` per wave."""
    ids, _, rows, cols = _wave_layout(data, src, dst, neg, t, eidx, plan)
    for w, lo, hi in _waves(plan):
        a, b = plan.own_bounds[w], plan.own_bounds[w + 1]
        sharded_step(data, ids[lo:hi], rows[lo:hi],
                     *(c[lo:hi] for c in cols), params, exchange,
                     plan.own_pos[a:b] - 2 * lo, plan.own_rows[a:b])
    return rows.index_select(0, plan.inv)


def wave_scan_chunk(state: TpprState, params: TpprParams, src, dst, neg, t,
                    eidx, valid, plan: WavePlan, exchange=None
                    ) -> Tuple[TpprState, torch.Tensor]:
    """Scan a chunk wave by wave. ``neg`` is [E], or [E, S] for the
    seed-parallel trainer, whose plan must then come from all S columns.
    Updates ``state`` in place; returns it and the pre-edge rows
    [E, 2+S, F] in stream order (src, dst, then one negative per seed;
    [E, 3, F] for one negative), zero for unscheduled events. The merge
    reads rows 0-1 of each edge and leaves the negatives' rows to the
    extraction.

    The columns are checked once (``_columns``: one host read). A CUDA
    tensor is one ``santa_waves`` launch for the chunk; a CPU tensor runs
    :func:`wave_scan_reference` (no fallback). With the row ``exchange``
    (a row-sharded index: ``state`` holds this rank's rows, the plan its
    writes) each wave runs :func:`~zebra_tpu_torch.index.scan.sharded_step`
    and every rank returns the whole chunk's rows."""
    data = state.data
    n_nodes = None if exchange is None else exchange.rows * exchange.mesh.size
    src, dst, neg, t, eidx, valid = _columns(data, src, dst, neg, t, eidx,
                                             valid, n_nodes)
    if exchange is not None:
        return state, _wave_scan_sharded(data, params, src, dst, neg, t,
                                         eidx, plan, exchange)
    if data.device.type == "cpu":
        return state, wave_scan_reference(data, params, src, dst, neg, t,
                                          eidx, plan)
    if data.device.type == "cuda":
        n_neg = 1 if neg.dim() == 1 else neg.shape[1]
        ext = torch.empty((src.shape[0], 2 + n_neg, data.shape[1]),
                          dtype=data.dtype, device=data.device)
        return state, SANTA_WAVES(data, params, src, dst, neg, t, eidx,
                                  valid, plan, ext)
    raise ValueError(f"the wave scan runs on cpu or cuda tensors, not "
                     f"{data.device}")
