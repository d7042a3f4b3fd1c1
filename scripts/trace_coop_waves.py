"""Trace santa_waves' cooperative-grid design with clock64 stamps, on the
chunks ``chip_smoke.py`` holds santa_waves on, for a comparison with the
cluster design in one call.

    python3 scripts/trace_coop_waves.py [--parent archive_parent]

``--parent`` is an unpacked ``git archive`` of a commit whose
``zebra_tpu_torch/csrc/santa_waves.cu`` is that design (d8574d3): a
cooperative grid of up to the widest wave's blocks, two software grid
barriers per wave, and a global stage between the merge and the writes.
The script adds a ``Trace`` instantiation to a copy of that source (thread
0 of block 0 stamps each wave at the end of five parts: rows in, merge
done, barrier 1 out, writes done, barrier 2 out), builds it with the
port's nvcc flags, checks it bit for bit against the plain wave loop, and
prints one JSON line per chunk: its time untraced and traced (CUDA
events), the SM clock nvidia-smi reads under load, and µs per wave of
each part. Needs a CUDA device."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from zebra_tpu_torch import build  # noqa: E402
from zebra_tpu_torch.index import merge  # noqa: E402
from zebra_tpu_torch.index.merge import host_coefficients  # noqa: E402
from zebra_tpu_torch.index.waves import wave_scan_reference  # noqa: E402
from zebra_tpu_torch.utils.profiling import device_ms  # noqa: E402

PARTS = ("rows_in", "merge", "barrier_1", "writes", "barrier_2")

# (anchor in the cooperative source, its replacement): each anchor occurs
# once
EDITS = (
    ("template <int Q, int P>\n__global__",
     "template <int Q, int P, bool Trace>\n__global__"),
    ("int n_waves, int n_neg, int m, int k) {",
     "int n_waves, int n_neg, int m, int k, long long* trace) {"),
    ("  unsigned long long target = 0;\n",
     "  unsigned long long target = 0;\n"
     "  auto stamp = [&](int w, int i) {\n"
     "    if (Trace && blockIdx.x == 0 && tid == 0)\n"
     "      trace[(long long)w * 5 + i] = clock64();\n"
     "  };\n"),
    ("      __syncthreads();  // the lane's rows are in\n",
     "      __syncthreads();  // the lane's rows are in\n"
     "      if (j == lo) stamp(w, 0);\n"),
    ("      __syncthreads();  // in_rows are free for the block's next lane\n"
     "    }\n"
     "    if (hi - lo > 1) {\n"
     "      grid_sync(counter, target += g);\n"
     "    }\n",
     "      __syncthreads();  // in_rows are free for the block's next lane\n"
     "    }\n"
     "    stamp(w, 1);\n"
     "    if (hi - lo > 1) {\n"
     "      grid_sync(counter, target += g);\n"
     "    }\n"
     "    stamp(w, 2);\n"),
    ("    if (w + 1 < n_waves) grid_sync(counter, target += g);\n",
     "    stamp(w, 3);\n"
     "    if (w + 1 < n_waves) grid_sync(counter, target += g);\n"
     "    stamp(w, 4);\n"),
    ("int m, int k, int* grid_out, void* stream) {",
     "int m, int k, int* grid_out, void* stream, long long* trace) {"),
    ("    auto kernel = santa_waves_kernel<decltype(q)::value, "
     "decltype(p)::value>;",
     "    auto kernel =\n"
     "        trace ? santa_waves_kernel<decltype(q)::value, "
     "decltype(p)::value, true>\n"
     "              : santa_waves_kernel<decltype(q)::value, "
     "decltype(p)::value, false>;"),
    ("&n_neg, &m,      &k};", "&n_neg, &m,      &k,       &trace};"),
)


def traced_source(parent: Path) -> str:
    src = (parent / "zebra_tpu_torch/csrc/santa_waves.cu").read_text()
    for old, new in EDITS:
        assert src.count(old) == 1, f"anchor not found once: {old!r}"
        src = src.replace(old, new)
    return src


def load(parent: Path, out: Path):
    """Build the traced copy next to the parent's sources and bind it."""
    csrc = parent / "zebra_tpu_torch/csrc"
    cu = csrc / "santa_waves_coop_trace.cu"
    cu.write_text(traced_source(parent))
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libsanta_waves_coop_trace.so"
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(lib), str(cu)], check=True)
    fn = ctypes.CDLL(str(lib)).santa_waves
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, p, p, p, p, p, i, i, p, p, p, p, p,
                   ctypes.c_longlong, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def run(fn, data, params, cols, plan, ext, trace=None) -> int:
    src, dst, neg, t, eidx, valid = cols
    m, k, f = len(params.alpha), params.k, data.shape[1]
    n_neg = 1 if neg.dim() == 1 else neg.shape[1]
    stage = torch.empty((max(plan.width, 1), 2, f), device=data.device)
    counter = torch.empty(1, dtype=torch.int64, device=data.device)
    alpha, beta = host_coefficients(params)
    grid = ctypes.c_int(0)
    rc = fn(data.data_ptr(), src.data_ptr(), dst.data_ptr(), neg.data_ptr(),
            n_neg, eidx.data_ptr(), t.data_ptr(), valid.data_ptr(),
            plan.order32.data_ptr(), plan.bounds32.data_ptr(), plan.n_waves,
            plan.width, ctypes.addressof(alpha), ctypes.addressof(beta),
            ext.data_ptr(), stage.data_ptr(), counter.data_ptr(),
            src.shape[0], m, k, ctypes.addressof(grid),
            torch.cuda.current_stream().cuda_stream,
            None if trace is None else trace.data_ptr())
    if rc != 0:
        raise RuntimeError(f"cooperative santa_waves: cudaError {rc}")
    return grid.value


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="archive_parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_coop_waves: no CUDA device", file=sys.stderr)
        return 2
    parent = Path(args.parent).resolve()
    fn = load(parent, parent / "_trace_build")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    for what, params, start, cols, plan in chip_smoke.waves_chunks():
        n, f = cols[0].shape[0], start.shape[1]
        r = 2 + (1 if cols[2].dim() == 1 else cols[2].shape[1])
        want = start.clone()
        want_rows = wave_scan_reference(want, params, *cols[:5], plan,
                                        merge=merge.merge_both_reference)
        trace = torch.zeros((plan.n_waves, len(PARTS)), dtype=torch.int64,
                            device="cuda")
        for tr in (None, trace):
            got, ext = start.clone(), torch.empty((n, r, f), device="cuda")
            grid = run(fn, got, params, cols, plan, ext, tr)
            torch.cuda.synchronize()
            chip_smoke._equal(got, want, f"{what} data")
            chip_smoke._equal(ext, want_rows, f"{what} rows")
        work, ext = start.clone(), torch.empty((n, r, f), device="cuda")
        ms = device_ms(lambda: run(fn, work, params, cols, plan, ext),
                       n=20, per_round=5, warmup=3)
        traced_ms = device_ms(
            lambda: run(fn, work, params, cols, plan, ext, trace),
            n=20, per_round=5, warmup=3)
        mhz = chip_smoke.sm_clock_mhz(
            lambda: run(fn, work, params, cols, plan, ext, trace),
            max(50, int(2000 / traced_ms)))
        cycles = float(trace[-1, -1] - trace[0, 0])
        print("coop " + json.dumps(dict(
            shape=what, E=n, R=r, M=len(params.alpha), k=params.k,
            waves=plan.n_waves, widest_wave=plan.width, grid=grid, ms=ms,
            traced_ms=traced_ms, sm_mhz=mhz,
            stamped_mhz_by_events=cycles / traced_ms / 1e3,
            us_per_wave=chip_smoke.trace_split(trace, mhz, PARTS),
            card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
