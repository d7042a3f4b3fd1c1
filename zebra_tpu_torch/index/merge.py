"""The SANTA merge: the CUDA kernel ``csrc/santa_merge.cu`` and its plain
PyTorch version (counterpart of ``zebra_tpu/index/pallas_merge.py``).

Both work on packed rows: they read the gathered rows [W, R, F] of W edges
(row 0 = src, row 1 = dst, further rows such as the negative are not read)
and return the two new rows per edge [W, 2, F], which the caller scatters
back (``scan.step``). The row layout is ``layout.py``'s.

``merge_both`` is the wrapper a wave step calls (``scan.step``): a tensor
on the CPU goes to :func:`merge_both_reference`; a CUDA tensor launches the
kernel or raises. :data:`SANTA_MERGE` counts the kernel's launches. The
serving scan runs the same merge body inside its own kernel
(``scan.py``)."""

from __future__ import annotations

import ctypes
import functools

import torch

from zebra_tpu_torch.build import Kernel
from zebra_tpu_torch.index.layout import (
    TpprParams,
    pack_rows,
    row_width,
    split_rows,
)

MAX_K = 64
MAX_M = 4


@functools.lru_cache(maxsize=None)
def _coefficients(alpha, beta, device: torch.device):
    """α and β as f32 tensors on ``device``, made once: a host-to-card copy
    per call would wait for the stream to drain."""
    as_t = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return as_t(alpha), as_t(beta)


def merge_both_reference(rows: torch.Tensor, src, dst, e_idx, e_ts,
                         params: TpprParams) -> torch.Tensor:
    """Plain PyTorch SANTA merge of both update directions of W edges
    (``zebra_tpu/index/streaming.py:_merge_both`` batched over W).

    rows [W, R≥2, F] f32, src/dst/e_idx [W] int, e_ts [W] f32 → [W, 2, F].
    Lane (w, dir, member) updates row ``dir`` from its partner row
    ``1-dir``. Eager elementwise ops round once per op, so this equals the
    kernel bit for bit, on the CPU and on the card."""
    m, k = len(params.alpha), params.k
    n_w = rows.shape[0]
    dev = rows.device
    fields, norm1 = split_rows(rows[:, :2], m, k)      # [W,2,M,4,k], [W,2,M]
    partner = fields.flip(1)
    alpha, beta = _coefficients(params.alpha, params.beta, dev)

    new_norm = norm1 * beta + beta
    scale1 = norm1 / new_norm * beta                   # → 0 when norm1 == 0
    scale2 = beta / new_norm * (1.0 - alpha)           # → 1-α when norm1 == 0

    w1r, n1, e1, t1 = fields.unbind(3)                 # each [W,2,M,k]
    w2r, n2, e2, t2 = partner.unbind(3)
    valid1, valid2 = w1r > 0, w2r > 0
    w2 = w2r * scale2[..., None]
    # dedup on (eidx, nbr): an s2 entry matching an s1 entry folds its
    # weight into the s1 entry
    match = ((e1[..., :, None] == e2[..., None, :])
             & (n1[..., :, None] == n2[..., None, :])
             & valid1[..., :, None] & valid2[..., None, :])   # [W,2,M,k,k]
    w1 = w1r * scale1[..., None] + torch.where(
        match, w2[..., None, :], 0.0).sum(-1)
    w2 = torch.where(valid2 & ~match.any(-2), w2, 0.0)

    # the fresh entry (e_idx, partner node, e_ts)
    new_w = torch.where(alpha != 0, scale2 * alpha, scale2)
    one = (n_w, 2, m, 1)
    new_node = torch.stack([dst, src], 1).to(torch.float32)[:, :, None, None]
    new_e = e_idx.to(torch.float32)[:, None, None, None]
    new_t = e_ts[:, None, None, None]
    cw = torch.cat([w1, w2, new_w[..., None]], -1)     # [W,2,M,2k+1]
    cn = torch.cat([n1, n2, new_node.expand(one)], -1)
    ce = torch.cat([e1, e2, new_e.expand(one)], -1)
    ct = torch.cat([t1, t2, new_t.expand(one)], -1)

    # canonical order (weight desc, eidx asc, nbr asc, then position):
    # torch has no multi-key sort, so stable sorts run in reverse key order
    order = torch.sort(cn, dim=-1, stable=True).indices
    order = order.gather(-1, torch.sort(ce.gather(-1, order), dim=-1,
                                        stable=True).indices)
    order = order.gather(-1, torch.sort(cw.gather(-1, order), dim=-1,
                                        descending=True, stable=True).indices)
    top = order[..., :k]
    top_w = cw.gather(-1, top)
    live = top_w > 0
    pick = lambda x: torch.where(live, x.gather(-1, top), 0.0)
    new_fields = torch.stack(
        [torch.where(live, top_w, 0.0), pick(cn), pick(ce), pick(ct)], dim=3
    )                                                  # [W,2,M,4,k]
    return pack_rows(new_fields, new_norm)


def check_limits(kernel: str, m: int, k: int) -> None:
    """Raise before any build when M or k exceed the kernels' static
    limits."""
    if not (1 <= m <= MAX_M and 1 <= k <= MAX_K):
        raise ValueError(
            f"{kernel} supports M ≤ {MAX_M} members and k ≤ {MAX_K} "
            f"(got M={m}, k={k})"
        )


def host_coefficients(params: TpprParams):
    """α and β as C float arrays: the kernels take them by value."""
    m = len(params.alpha)
    return (ctypes.c_float * m)(*params.alpha), (ctypes.c_float * m)(*params.beta)


class SantaMergeKernel(Kernel):
    """ctypes binding of ``csrc/santa_merge.cu``: builds at first call,
    launches on the current stream, counts its launches."""

    def __init__(self):
        p, i = ctypes.c_void_p, ctypes.c_int
        super().__init__("santa_merge", [p, ctypes.c_longlong, p, p, p, p, p,
                                         p, p, i, i, i, p])

    def __call__(self, rows, src, dst, e_idx, e_ts,
                 params: TpprParams) -> torch.Tensor:
        m, k = len(params.alpha), params.k
        check_limits(self.name, m, k)
        f = row_width(m, k)
        dev = rows.device
        if (rows.dtype != torch.float32 or rows.dim() != 3
                or rows.shape[1] < 2 or rows.shape[2] != f
                or rows.stride(2) != 1 or rows.stride(1) != f):
            raise ValueError(
                f"rows must be f32 [W, R≥2, {f}] with contiguous rows, got "
                f"{rows.dtype} {tuple(rows.shape)} strides {rows.stride()}"
            )
        n_w = rows.shape[0]
        for name, t, dt in (("src", src, torch.int32), ("dst", dst, torch.int32),
                            ("e_idx", e_idx, torch.int32),
                            ("e_ts", e_ts, torch.float32)):
            if (t.dtype != dt or t.shape != (n_w,) or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"{name} must be a contiguous {dt} [{n_w}] on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}"
                )
        out = torch.empty((n_w, 2, f), dtype=torch.float32, device=dev)
        if n_w == 0:
            return out
        alpha, beta = host_coefficients(params)
        self.launch(
            rows.data_ptr(), rows.stride(0), src.data_ptr(), dst.data_ptr(),
            e_idx.data_ptr(), e_ts.data_ptr(), ctypes.addressof(alpha),
            ctypes.addressof(beta), out.data_ptr(), n_w, m, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        return out


SANTA_MERGE = SantaMergeKernel()


def merge_both(rows: torch.Tensor, src, dst, e_idx, e_ts,
               params: TpprParams) -> torch.Tensor:
    """The merge on packed rows [W, R≥2, F] → [W, 2, F]: the plain version
    for a CPU tensor, the CUDA kernel for a CUDA tensor (no fallback)."""
    if rows.device.type == "cpu":
        return merge_both_reference(rows, src, dst, e_idx, e_ts, params)
    if rows.device.type == "cuda":
        return SANTA_MERGE(rows, src, dst, e_idx, e_ts, params)
    raise ValueError(f"santa merge runs on cpu or cuda tensors, not {rows.device}")


def merge_both_fields(fields3, norm_sd, src, dst, e_idx, e_ts,
                      params: TpprParams):
    """``merge_both_pallas``'s view: fields3 [W, 3, M, 4, k] (src, dst, neg
    rows), norm_sd [W, 2, M] → (new fields [W, 2, M, 4, k], new norms
    [W, 2, M])."""
    m, k = len(params.alpha), params.k
    rows = pack_rows(fields3[:, :2], norm_sd).contiguous()
    new_fields, new_norm = split_rows(
        merge_both(rows, src, dst, e_idx, e_ts, params), m, k)
    return new_fields, new_norm
