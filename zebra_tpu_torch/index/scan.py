"""The streaming scan of a chunk of events in stream order: the CUDA kernel
``csrc/santa_scan.cu`` (one launch of one thread-block cluster per chunk)
and its plain PyTorch version (counterpart of the ``lax.scan`` in
``zebra_tpu/index/streaming.py``).

Per event the scan reads the pre-edge rows of src and dst (and neg when it
extracts them for queries), merges them (``merge.py``) and, for a valid
event, writes both new rows back into ``data`` in place. :func:`scan`
dispatches: a CPU tensor runs :func:`scan_reference`, a CUDA tensor launches
the kernel once (:data:`SANTA_SCAN` counts the launches) or raises. The
kernel runs the events of a chunk in levels of events that share no row
one of them writes; :func:`scan_levels` is the plain version of the levels
it computes, :func:`geometry` sizes its cluster."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from zebra_tpu_torch.build import Kernel
from zebra_tpu_torch.index.layout import TpprParams, row_width
from zebra_tpu_torch.index.merge import (
    check_limits,
    host_coefficients,
    merge_both,
    merge_both_reference,
)
from zebra_tpu_torch.index.wave_kernel import MAX_CLUSTER, MAX_THREADS


def step(data, ids, rows, src, dst, e_idx, e_ts, valid, params,
         merge=merge_both, write_ids=None):
    """One batched SANTA step on W node-disjoint edges: gather the rows
    ``ids`` [W, R≥2] (src, dst, then any rows to extract) into ``rows``
    [W, R, F], merge, scatter the two new rows per edge back into ``data``
    in place. ``valid`` None means all valid. ``write_ids`` is
    ``ids[:, :2].reshape(-1)`` made ahead by a caller that steps through
    many waves (the reshape copies).

    A self-loop (src == dst) computes two identical rows, so its duplicate
    index in ``index_copy_`` writes one value whichever copy lands last."""
    f = data.shape[1]
    torch.index_select(data, 0, ids.reshape(-1), out=rows.view(-1, f))
    new_rows = merge(rows, src, dst, e_idx, e_ts, params)  # [W, 2, F]
    if valid is not None:
        new_rows = torch.where(valid[:, None, None], new_rows, rows[:, :2])
    if write_ids is None:
        write_ids = ids[:, :2].reshape(-1)
    data.index_copy_(0, write_ids, new_rows.view(-1, f))


def sharded_step(data, ids, rows, src, dst, e_idx, e_ts, params, exchange,
                 own_pos, own_rows) -> None:
    """:func:`step` on a row-sharded index (``data`` holds this rank's
    rows): the W·R rows ``ids`` come through one ``exchange.fetch`` (the
    ids are the same on every rank), every rank merges every lane (one
    ``santa_merge`` launch on the card; the same inputs, so the same bits
    on every rank), and this rank writes the new rows it owns: the entries
    ``own_pos`` of the [2W] written rows, at its local rows ``own_rows``."""
    f = data.shape[1]
    rows.view(-1, f).copy_(exchange.fetch((data,), ids.reshape(-1),
                                          "wave")[0])
    new_rows = merge_both(rows, src, dst, e_idx, e_ts, params)  # [W, 2, F]
    data.index_copy_(0, own_rows, new_rows.view(-1, f).index_select(
        0, own_pos))


def scan_reference(data: torch.Tensor, params: TpprParams, src, dst, neg,
                   e_ts, e_idx, valid,
                   extract: bool = True) -> Optional[torch.Tensor]:
    """Plain PyTorch scan, one :func:`step` with ``merge_both_reference``
    per event, on the CPU or the card. Updates ``data`` [N, F] in place;
    returns the pre-edge (src, dst, neg) rows [E, 3, F] when ``extract``,
    else None (neg is then not read). Columns: i32 ids, f32 times, bool
    valid, all on ``data``'s device."""
    n_in = 3 if extract else 2
    cols = (src, dst, neg)[:n_in]
    ids = torch.stack(cols, dim=1).to(torch.int64)
    rows = torch.empty((src.shape[0], n_in, data.shape[1]), dtype=data.dtype,
                       device=data.device)
    all_valid = bool(valid.all())
    for i in range(src.shape[0]):
        j = slice(i, i + 1)
        step(data, ids[j], rows[j], src[j], dst[j], e_idx[j], e_ts[j],
             None if all_valid else valid[j], params, merge_both_reference)
    return rows if extract else None


MAX_TILE = 2_000       # events per tile: 6,000 touches in 8,192 hash slots
LANE_ROWS = 3          # a lane's rows in shared memory: src, dst, neg
# what a traced launch's stamps end: a tile's plan (the prologue), a level's
# rows in shared memory (first pass), its merges (last pass), the cluster
# barrier's arrive and its wait
TRACE_PARTS = ("plan", "rows_in", "merge", "arrive", "wait")


def scan_levels(src, dst, neg, valid, extract: bool = True,
                tile: int = MAX_TILE) -> np.ndarray:
    """The level of each event in the kernel's order, numbered across the
    chunk's tiles of ``tile`` events (i64 [E]; -1 for an invalid event
    without extraction, which does nothing). Within a tile, an event's level
    is one more than the largest level of the earlier events that write a
    row it reads or writes (src, dst, and neg when ``extract``), and, when
    it writes (valid), of the earlier events that read a row it writes; a
    tile's levels follow the previous tile's. Running the levels in order,
    the events of a level in any order, equals the stream order."""
    cols = [np.asarray(torch.as_tensor(c).cpu()) for c in (src, dst, neg,
                                                            valid)]
    s, d, n = (c.astype(np.int64).tolist() for c in cols[:3])
    v = cols[3].astype(bool).tolist()
    levels = np.full(len(s), -1, np.int64)
    base = 0
    for lo in range(0, len(s), tile):
        wrote, read = {}, {}  # row -> (last write's, highest read's) level+1
        depth = 0
        for e in range(lo, min(lo + tile, len(s))):
            if not (extract or v[e]):
                continue
            rows = (s[e], d[e], n[e]) if extract else (s[e], d[e])
            up = max(wrote.get(r, 0) for r in rows)
            if v[e]:
                up = max(up, read.get(s[e], 0), read.get(d[e], 0))
            up += 1
            for r in rows:
                read[r] = max(read.get(r, 0), up)
            if v[e]:
                wrote[s[e]] = wrote[d[e]] = up
            levels[e] = base + up - 1
            depth = max(depth, up)
        base += depth
    return levels


class ScanGeometry(NamedTuple):
    """One launch's shape: ``cluster`` blocks of ``lanes`` lanes (a lane is
    2M warps), tiles of ``tile`` events, a hash table of ``hash`` slots,
    ``smem_bytes`` of shared memory per block."""

    cluster: int
    lanes: int
    tile: int
    hash: int
    smem_bytes: int

    @property
    def per_pass(self) -> int:
        """The events of a level the cluster runs at once."""
        return self.cluster * self.lanes


def smem_bytes(lanes: int, f: int, tile: int, hash_slots: int) -> int:
    """``santa_scan.cu:smem_size``: per lane its rows; the plan's hash keys
    and touch and write keys, five i32 columns of the tile, its level
    bounds, i16 touch slots and u8 valid flags."""
    return (4 * (lanes * LANE_ROWS * f + 3 * hash_slots + 6 * tile + 1)
            + 2 * 3 * tile + tile)


def geometry(n_events: int, m: int, k: int) -> ScanGeometry:
    """The cluster for a chunk of ``n_events`` events with ``m`` members and
    top-``k`` rows: tiles of up to :data:`MAX_TILE` events, a hash of the
    next power of two of at least four slots per event (three touches per
    event, at most three quarters full), one block per SM up to 16 and as
    many lanes per block as a level of the chunk could fill, up to 512
    threads. A chunk of E events has no level wider than E, so a small
    chunk takes min(16, E) blocks: every block computes the plan and the
    cluster barrier waits for the slowest, so a block without lanes would
    only add to each barrier (a 1-event chunk runs on one block)."""
    check_limits("santa_scan", m, k)
    n = max(int(n_events), 1)
    tile = min(MAX_TILE, n)
    hash_slots = 1 << (4 * tile - 1).bit_length()
    cluster = min(MAX_CLUSTER, n)
    lanes = min(MAX_THREADS // (64 * m), -(-n // cluster))
    return ScanGeometry(cluster, lanes, tile, hash_slots,
                        smem_bytes(lanes, row_width(m, k), tile, hash_slots))


class SantaScanKernel(Kernel):
    """ctypes binding of ``csrc/santa_scan.cu``: builds at first call,
    launches one cluster (:func:`geometry`) on the current stream, does not
    synchronise, counts its launches (``launches``) and among them those
    that extract the pre-edge rows (``extracting``), and keeps the last
    launch's geometry (``geom``)."""

    def __init__(self):
        p, i = ctypes.c_void_p, ctypes.c_int
        super().__init__("santa_scan", [p, p, p, p, p, p, p, p, p, p,
                                        ctypes.c_longlong, i, i, p,
                                        i, i, i, i, i, p, p])
        self.extracting = 0
        self.geom: Optional[ScanGeometry] = None

    def __call__(self, data, params: TpprParams, src, dst, neg, e_ts, e_idx,
                 valid, ext: Optional[torch.Tensor] = None,
                 levels: Optional[torch.Tensor] = None,
                 trace: Optional[torch.Tensor] = None
                 ) -> Optional[torch.Tensor]:
        """Scan the events into ``data`` in place; fills ``ext``
        [E, 3, F] with the pre-edge rows when given and returns it.
        ``levels``, an i32 [E] tensor, receives each event's level
        (:func:`scan_levels`); ``trace``, a zeroed i64 [E + 1, 5] tensor,
        runs the traced build, which stamps a tile's plan and each level's
        parts (:data:`TRACE_PARTS`) in SM clock cycles."""
        m, k = len(params.alpha), params.k
        check_limits(self.name, m, k)
        f = row_width(m, k)
        dev = data.device
        if (data.dtype != torch.float32 or data.dim() != 2
                or data.shape[1] != f or not data.is_contiguous()):
            raise ValueError(
                f"data must be a contiguous f32 [N, {f}], got {data.dtype} "
                f"{tuple(data.shape)} strides {data.stride()}"
            )
        n = src.shape[0] if src.dim() == 1 else -1
        for name, t, dt in (("src", src, torch.int32), ("dst", dst, torch.int32),
                            ("neg", neg, torch.int32),
                            ("e_idx", e_idx, torch.int32),
                            ("e_ts", e_ts, torch.float32),
                            ("valid", valid, torch.bool)):
            if (t.dtype != dt or t.shape != (n,) or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous {dt} [E] on {dev} like src, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
        if ext is not None and (
                ext.dtype != torch.float32 or ext.shape != (n, 3, f)
                or ext.device != dev or not ext.is_contiguous()):
            raise ValueError(
                f"ext must be a contiguous f32 [{n}, 3, {f}] on {dev}, got "
                f"{ext.dtype} {tuple(ext.shape)} on {ext.device}"
            )
        for name, t, dt, shape in (
                ("levels", levels, torch.int32, (n,)),
                ("trace", trace, torch.int64, (n + 1, len(TRACE_PARTS)))):
            if t is not None and (t.dtype != dt or tuple(t.shape) != shape
                                  or t.device != dev
                                  or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous {dt} {list(shape)} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if dev.type != "cuda":
            raise ValueError(f"santa_scan runs on cuda tensors, not {dev}")
        if n == 0:
            return ext
        geom = geometry(n, m, k)
        alpha, beta = host_coefficients(params)
        ptr = lambda t: None if t is None else t.data_ptr()
        with torch.cuda.device(dev):
            self.launch(
                data.data_ptr(), src.data_ptr(), dst.data_ptr(),
                neg.data_ptr(), e_idx.data_ptr(), e_ts.data_ptr(),
                valid.data_ptr(), ctypes.addressof(alpha),
                ctypes.addressof(beta), ptr(ext), n, m, k,
                torch.cuda.current_stream(dev).cuda_stream, *geom,
                ptr(levels), ptr(trace))
        self.extracting += ext is not None
        self.geom = geom
        return ext


SANTA_SCAN = SantaScanKernel()


def scan(data: torch.Tensor, params: TpprParams, src, dst, neg, e_ts, e_idx,
         valid, extract: bool = True) -> Optional[torch.Tensor]:
    """The scan of a chunk: the plain version for a CPU tensor, one kernel
    launch for a CUDA tensor (no fallback). Returns the pre-edge rows
    [E, 3, F] when ``extract``, else None."""
    if data.device.type == "cpu":
        return scan_reference(data, params, src, dst, neg, e_ts, e_idx, valid,
                              extract)
    if data.device.type == "cuda":
        ext = None
        if extract:
            ext = torch.empty((src.shape[0], 3, data.shape[1]),
                              dtype=data.dtype, device=data.device)
        return SANTA_SCAN(data, params, src, dst, neg, e_ts, e_idx, valid,
                          ext)
    raise ValueError(f"the scan runs on cpu or cuda tensors, not {data.device}")
