"""The ctypes binding of ``csrc/santa_waves.cu``: a whole superchunk's wave
scan in one launch of one thread-block cluster (counterpart of the
``lax.scan`` over waves in ``zebra_tpu/index/waves.py``).
``waves.wave_scan_chunk`` calls it for a CUDA tensor; its plain version is
``waves.wave_scan_reference``. :data:`SANTA_WAVES` counts the launches;
:func:`geometry` sizes the cluster."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from zebra_tpu_torch.build import Kernel
from zebra_tpu_torch.index.layout import TpprParams, row_width
from zebra_tpu_torch.index.merge import check_limits, host_coefficients

MAX_CLUSTER = 16       # blocks of a non-portable cluster on Hopper
MAX_THREADS = 512      # the kernel's __launch_bounds__: ≤ 128 registers
MAX_SMEM = 232_448     # bytes of shared memory a block may use (227 KB)
META_FIELDS = 8        # i32 fields of a lane's record before its negatives
# what each of a traced launch's stamps ends: the lane's rows in shared
# memory, its merge (its negatives' rows and next record in), the cluster
# barrier's arrive with the negatives' stores after it, the barrier's wait
TRACE_PARTS = ("rows_in", "merge", "arrive", "wait")


class WaveGeometry(NamedTuple):
    """One launch's shape: ``cluster`` blocks of ``lanes`` lanes (a lane is
    2M warps); per lane, its 2 + S rows and two metadata records (this
    pass's and the next one's) in shared memory, ``smem_bytes`` in all."""

    cluster: int
    lanes: int
    smem_bytes: int

    @property
    def per_pass(self) -> int:
        """The lanes of a wave the cluster runs at once."""
        return self.cluster * self.lanes


def geometry(width: int, m: int, k: int, n_neg: int) -> WaveGeometry:
    """The cluster for waves of at most ``width`` lanes with ``m`` members,
    top-``k`` rows and ``n_neg`` negatives per lane: as many blocks as
    lanes up to 16 (one per SM: the lanes spread over SMs first), then as
    many lanes per block as a wave needs, up to 512 threads and as many as
    227 KB of shared memory holds (a lane's 2 + S rows and two records of
    8 + S i32); a wider wave takes several passes. Refuses S so large that
    one lane does not fit."""
    check_limits("santa_waves", m, k)
    lane_bytes = 4 * ((2 + n_neg) * row_width(m, k)
                      + 2 * (META_FIELDS + n_neg))
    if lane_bytes > MAX_SMEM:
        raise ValueError(f"santa_waves: a lane of {n_neg} negatives needs "
                         f"{lane_bytes} bytes of shared memory, over "
                         f"{MAX_SMEM}")
    width = max(int(width), 1)
    cluster = min(MAX_CLUSTER, width)
    lanes = min(MAX_THREADS // (64 * m), MAX_SMEM // lane_bytes,
                -(-width // cluster))
    return WaveGeometry(cluster, lanes, lanes * lane_bytes)


def lane_schedule(geom: WaveGeometry, width: int) -> np.ndarray:
    """[passes, cluster, lanes] the lane of a wave of ``width`` lanes that
    slot l of block b takes in each pass, -1 where none: lane = pass·C·L +
    l·C + b, as santa_waves.cu computes it."""
    passes = -(-width // geom.per_pass)
    p, b, l = np.meshgrid(np.arange(passes), np.arange(geom.cluster),
                          np.arange(geom.lanes), indexing="ij")
    lane = p * geom.per_pass + l * geom.cluster + b
    return np.where(lane < width, lane, -1)


class SantaWavesKernel(Kernel):
    """Builds at first call, launches on the current stream without
    synchronising, counts its launches (``launches``) and keeps the
    geometry of the last one (``geom``)."""

    def __init__(self):
        p, i = ctypes.c_void_p, ctypes.c_int
        super().__init__("santa_waves", [p, p, p, p, i, p, p, p, p, p, i, p,
                                         p, p, p, p, p, p, ctypes.c_longlong,
                                         i, i, i, i, i, p, p])
        self.geom: Optional[WaveGeometry] = None

    def __call__(self, data, params: TpprParams, src, dst, neg, e_ts, e_idx,
                 valid, plan, ext: torch.Tensor,
                 trace: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scan the chunk's waves (``plan``, a ``waves.WavePlan`` of the
        valid events) into ``data`` in place; fills ``ext`` [E, 2+S, F]
        with the pre-edge rows in stream order (zero rows for the invalid
        events) and returns it. ``neg`` is [E] or [E, S]. ``trace``, an i64
        [n_waves, 4] tensor, runs the traced build, which stamps each wave's
        parts (:data:`TRACE_PARTS`) in SM clock cycles."""
        m, k = len(params.alpha), params.k
        check_limits(self.name, m, k)
        f = row_width(m, k)
        dev = data.device
        if (data.dtype != torch.float32 or data.dim() != 2
                or data.shape[1] != f or not data.is_contiguous()):
            raise ValueError(
                f"data must be a contiguous f32 [N, {f}], got {data.dtype} "
                f"{tuple(data.shape)} strides {data.stride()}")
        n = src.shape[0] if src.dim() == 1 else -1
        if neg.dim() not in (1, 2) or neg.shape[0] != n:
            raise ValueError(f"neg must be [E] or [E, S] with E = {n}, got "
                             f"{tuple(neg.shape)}")
        n_neg = 1 if neg.dim() == 1 else neg.shape[1]
        n_sched, n_waves = len(plan.order), plan.n_waves
        n_red = -1 if plan.redirect is None else plan.redirect.shape[0]
        checks = [
            ("src", src, torch.int32, (n,)),
            ("dst", dst, torch.int32, (n,)),
            ("neg", neg, torch.int32, tuple(neg.shape)),
            ("e_idx", e_idx, torch.int32, (n,)),
            ("e_ts", e_ts, torch.float32, (n,)),
            ("valid", valid, torch.bool, (n,)),
            ("plan.order32", plan.order32, torch.int32, (n_sched,)),
            ("plan.bounds32", plan.bounds32, torch.int32, (n_waves + 1,)),
            ("plan.redirect", plan.redirect, torch.int32, (n_red, 4)),
            ("plan.redirect_start", plan.redirect_start, torch.int32,
             (n_sched + 1,)),
            ("plan.redirect_mask", plan.redirect_mask, torch.uint8,
             (n_sched, n_neg))]
        if trace is not None:
            checks.append(("trace", trace, torch.int64,
                           (n_waves, len(TRACE_PARTS))))
        for name, t, dt, shape in checks:
            if (t is None or t.dtype != dt or tuple(t.shape) != shape
                    or t.device != dev or not t.is_contiguous()):
                got = (None if t is None
                       else f"{t.dtype} {tuple(t.shape)} on {t.device}")
                raise ValueError(f"{name} must be a contiguous {dt} "
                                 f"{list(shape)} on {dev}, got {got}")
        if n_sched > n or plan.bounds[-1] != n_sched:
            raise ValueError(f"the plan schedules {n_sched} of {n} events "
                             f"and its waves end at {plan.bounds[-1]}")
        r = 2 + n_neg
        if (ext.dtype != torch.float32 or tuple(ext.shape) != (n, r, f)
                or ext.device != dev or not ext.is_contiguous()):
            raise ValueError(
                f"ext must be a contiguous f32 [{n}, {r}, {f}] (R = 2 + S) "
                f"on {dev}, got {ext.dtype} {tuple(ext.shape)} on "
                f"{ext.device}")
        if dev.type != "cuda":
            raise ValueError(f"santa_waves runs on cuda tensors, not {dev}")
        if n == 0:
            return ext
        geom = geometry(plan.width, m, k, n_neg)
        records = torch.empty((n_sched, META_FIELDS + n_neg),
                              dtype=torch.int32, device=dev)
        alpha, beta = host_coefficients(params)
        with torch.cuda.device(dev):
            self.launch(
                data.data_ptr(), src.data_ptr(), dst.data_ptr(),
                neg.data_ptr(), n_neg, e_idx.data_ptr(), e_ts.data_ptr(),
                valid.data_ptr(), plan.order32.data_ptr(),
                plan.bounds32.data_ptr(), n_waves,
                plan.redirect_start.data_ptr(), plan.redirect.data_ptr(),
                plan.redirect_mask.data_ptr(), ctypes.addressof(alpha),
                ctypes.addressof(beta), ext.data_ptr(), records.data_ptr(),
                n, m, k, *geom,
                None if trace is None else trace.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        self.geom = geom
        return ext


SANTA_WAVES = SantaWavesKernel()
