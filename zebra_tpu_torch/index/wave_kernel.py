"""The ctypes binding of ``csrc/santa_waves.cu``: a whole superchunk's wave
scan in one cooperative launch (counterpart of the ``lax.scan`` over waves
in ``zebra_tpu/index/waves.py``). ``waves.wave_scan_chunk`` calls it for a
CUDA tensor; its plain version is ``waves.wave_scan_reference``.
:data:`SANTA_WAVES` counts the launches."""

from __future__ import annotations

import ctypes

import torch

from zebra_tpu_torch.build import Kernel
from zebra_tpu_torch.index.layout import TpprParams, row_width
from zebra_tpu_torch.index.merge import check_limits, host_coefficients


class SantaWavesKernel(Kernel):
    """Builds at first call, launches on the current stream without
    synchronising, counts its launches (``launches``) and keeps the grid of
    the last one (``grid``: resident blocks, each taking every grid-th lane
    of a wave)."""

    def __init__(self):
        p, i = ctypes.c_void_p, ctypes.c_int
        super().__init__("santa_waves", [p, p, p, p, i, p, p, p, p, p, i, i,
                                         p, p, p, p, p, ctypes.c_longlong, i,
                                         i, p, p])
        self.grid = 0

    def __call__(self, data, params: TpprParams, src, dst, neg, e_ts, e_idx,
                 valid, plan, ext: torch.Tensor) -> torch.Tensor:
        """Scan the chunk's waves (``plan``, a ``waves.WavePlan`` of the
        valid events) into ``data`` in place; fills ``ext`` [E, 2+S, F]
        with the pre-edge rows in stream order (zero rows for the invalid
        events) and returns it. ``neg`` is [E] or [E, S]."""
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
        for name, t, dt, shape in (
                ("src", src, torch.int32, (n,)),
                ("dst", dst, torch.int32, (n,)),
                ("neg", neg, torch.int32, tuple(neg.shape)),
                ("e_idx", e_idx, torch.int32, (n,)),
                ("e_ts", e_ts, torch.float32, (n,)),
                ("valid", valid, torch.bool, (n,)),
                ("plan.order32", plan.order32, torch.int32, (n_sched,)),
                ("plan.bounds32", plan.bounds32, torch.int32,
                 (n_waves + 1,))):
            if (t.dtype != dt or tuple(t.shape) != shape or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous {dt} {list(shape)} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
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
        width = plan.width
        stage = torch.empty((max(width, 1), 2, f), dtype=torch.float32,
                            device=dev)
        counter = torch.empty(1, dtype=torch.int64, device=dev)
        alpha, beta = host_coefficients(params)
        grid = ctypes.c_int(0)
        with torch.cuda.device(dev):
            self.launch(
                data.data_ptr(), src.data_ptr(), dst.data_ptr(),
                neg.data_ptr(), n_neg, e_idx.data_ptr(), e_ts.data_ptr(),
                valid.data_ptr(), plan.order32.data_ptr(),
                plan.bounds32.data_ptr(), n_waves, width,
                ctypes.addressof(alpha), ctypes.addressof(beta),
                ext.data_ptr(), stage.data_ptr(), counter.data_ptr(), n, m,
                k, ctypes.addressof(grid),
                torch.cuda.current_stream(dev).cuda_stream)
        self.grid = grid.value
        return ext


SANTA_WAVES = SantaWavesKernel()
