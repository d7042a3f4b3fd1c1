"""Drive the PyTorch port (zebra_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel from zebra_tpu_torch/csrc (nvcc, sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card, at the
   shapes the serving path and the training wave give it, with its time, the
   plain version's time and the least time the card could take;
4. serve: the flagship serving configuration at full width (streaming T-PPR,
   top-20, two-member ensemble, diffusion tower, GRU, bf16 tables) on the
   bench stream, through ``LinkPredictor.observe``/``score`` on the card,
   replayed on the CPU and compared; the kernel launch counts of this phase;
5. one ``{"kernels": [...]}`` line;
6. last line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from zebra_tpu_torch import build
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index import merge
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    init_tppr_state,
    row_width,
    streaming_scan,
)
from zebra_tpu_torch.profile_serve import flagship
from zebra_tpu_torch.serve import LinkPredictor

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

ALPHA = (0.1, 0.1, 0.0)
BETA = (0.05, 0.95, 0.5)
# (what gives the kernel this shape, W edges, M members, top-k)
MERGE_SHAPES = [("serving observe", 1, 2, 20), ("training wave", 64, 2, 20),
                ("large k", 64, 3, 40)]

# The kernel rounds exactly like its plain version (same operation order,
# -fmad=false), so kernel results and the serve index are held bit-equal.
# Serve-phase bars, CUDA vs CPU run of the same requests:
# - index tables: bit-equal;
# - memory table (bf16): GRU outputs differ by matmul summation order
#   (cuBLAS vs the CPU BLAS, ~1e-6 relative), which moves a value by one
#   bf16 ulp (≤ 2^-8 relative, values |x| < 1) where it sits at a rounding
#   boundary, and later commits carry such ulps on;
# - scores: those ulps through the towers and the sigmoid.
MEMORY_ATOL, MEMORY_DIFF_SHARE = 2e-2, 0.01
SCORE_ATOL = 5e-3
WARM_EVENTS, OBSERVE_BS = 4000, 200
SCORE_BS = (1, 32, 256, 2048)
FINAL_OBSERVE_B = 256


def device_ms(fn, n: int = 100, per_round: int = 100, warmup: int = 10) -> float:
    """Median device time of ``fn()`` in ms over ``n`` calls (CUDA events).
    Calls run in rounds of ``per_round``; before each round a spin kernel
    holds the stream while the round is enqueued, so the events time the
    device's work and not the host's launch latency. A round must fit the
    device's queue of pending launches (about a thousand, events included):
    once it is full the host waits, and the calls after the spin would be
    timed at the host's enqueue rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 10
    times = []
    for lo in range(0, n, per_round):
        m = min(per_round, n - lo)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(m)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(m)]
        # ≥ 2 GHz·(2·enqueue time) cycles outlasts the enqueue at any clock
        torch.cuda._sleep(int(min(2 * m * host_s * 2e9, 2e10)))
        for s, e in zip(starts, ends):
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return float(np.median(times))


def merge_bound(rows: torch.Tensor, m: int, k: int):
    """Least time (ms) for one merge of these rows: the larger of the bytes
    the function must move (rows 0-1 of each edge and its 4 scalars in, the
    two new rows out) over the HBM rate, and the operations it needs over
    the f32 rate. For a lane (edge, direction, member) whose two rows hold
    L live entries that is a top-k selection over C = L + 1 candidates,
    at least C·⌈log2 C⌉ comparisons, 2L for the twin lookup and the weight
    scaling, and 8 for the scales. Returns (ms, 'bytes' | 'operations')."""
    w = rows.shape[0]
    f = row_width(m, k)
    nbytes = w * 2 * f * 4 + w * 16 + w * 2 * f * 4
    weights = rows[:, :2, : 4 * m * k].reshape(w, 2, m, 4, k)[:, :, :, 0]
    live = (weights > 0).sum((1, 3)).double()          # [W, M], both rows
    c = live + 1
    per_lane = c * torch.ceil(torch.log2(c.clamp(min=2))) + 2 * live + 8
    ops = 2 * float(per_lane.sum())                    # two directions
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def realistic_rows(w: int, m: int, k: int, seed: int):
    """Gathered rows [W, 3, F] on the card, taken after a plain (CPU)
    streaming_scan over a 1,500-event synthetic stream, for the W events
    that follow it, with their (src, dst, eidx, ts)."""
    data, _ = synthetic_stream(1500 + w, 150, 150, seed=seed)
    n_nodes = 301
    e = 1500
    params = TpprParams.create(ALPHA[:m], BETA[:m], k)
    rng = np.random.RandomState(seed)
    neg = rng.randint(1, n_nodes, 1500 + w).astype(np.int32)
    ts = data.timestamps.astype(np.float32)
    state = init_tppr_state(m, n_nodes, k, device="cpu")
    state, _ = streaming_scan(state, params, data.sources[:e],
                              data.destinations[:e], neg[:e], ts[:e],
                              data.edge_idxs[:e], np.ones(e, bool))
    sl = slice(e, e + w)
    sdn = np.stack([data.sources[sl], data.destinations[sl], neg[sl]], 1)
    cuda = lambda a: torch.as_tensor(a).cuda()
    rows = cuda(state.data[torch.from_numpy(sdn).long()])
    return (params, rows, cuda(data.sources[sl]), cuda(data.destinations[sl]),
            cuda(data.edge_idxs[sl]), cuda(ts[sl]))


def kernel_phase(card: str):
    results = []
    for what, w, m, k in MERGE_SHAPES:
        params, rows, src, dst, eidx, ts = realistic_rows(w, m, k, seed=w + k)
        kernel = lambda: merge.merge_both(rows, src, dst, eidx, ts, params)
        plain = lambda: merge.merge_both_reference(rows, src, dst, eidx, ts,
                                                   params)
        got, want = kernel(), plain()
        want_cpu = merge.merge_both_reference(
            rows.cpu(), src.cpu(), dst.cpu(), eidx.cpu(), ts.cpu(), params)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert torch.equal(got, want), f"santa_merge {what}: max abs err {err}"
        plain_cpu_same = bool(torch.equal(want.cpu(), want_cpu))
        # the plain version makes 70 device operations per call
        ms, plain_ms = device_ms(kernel), device_ms(plain, n=60, per_round=10)
        bound_ms, bound_by = merge_bound(rows, m, k)
        res = dict(shape=what, W=w, M=m, k=k, max_abs_err=err,
                   plain_cuda_equals_plain_cpu=plain_cpu_same, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=None, card=card)
        print("kernel santa_merge " + json.dumps(res), flush=True)
        results.append(res)
    return results


def _drive(pred: LinkPredictor, cols, timed: bool):
    """The serving sequence: warm-up observes, score requests at each batch
    size on the events that follow, one more observe. Returns scores per
    batch size and, when ``timed``, the timings."""
    sync = torch.cuda.synchronize if timed else (lambda: None)
    src, dst, ts, eidx = cols
    obs_s = []
    for lo in range(0, WARM_EVENTS, OBSERVE_BS):
        sl = slice(lo, lo + OBSERVE_BS)
        t0 = time.perf_counter()
        pred.observe(src[sl], dst[sl], ts[sl], eidx[sl])
        sync()
        obs_s.append(time.perf_counter() - t0)
    scores, score_s = {}, {}
    for b in SCORE_BS:
        sl = slice(WARM_EVENTS, WARM_EVENTS + b)
        scores[b] = pred.score(src[sl], dst[sl], ts[sl])
        if timed:
            lat = []
            for _ in range(20):
                t0 = time.perf_counter()
                pred.score(src[sl], dst[sl], ts[sl])      # returns on the host
                lat.append(time.perf_counter() - t0)
            score_s[b] = float(np.median(lat))
    sl = slice(WARM_EVENTS, WARM_EVENTS + FINAL_OBSERVE_B)
    t0 = time.perf_counter()
    pred.observe(src[sl], dst[sl], ts[sl], eidx[sl])
    sync()
    final_s = time.perf_counter() - t0
    return scores, dict(observe_warm_s=float(np.median(obs_s)),
                        score_s=score_s, observe_final_s=final_s)


def serve_phase(card: str):
    cfg, params, mem, index, edge_feats, cols = flagship(seed=0)
    gpu = LinkPredictor(cfg, params, mem, index, edge_feats, device="cuda")
    cpu = LinkPredictor(cfg, params, mem, index, edge_feats, device="cpu")

    torch.cuda.reset_peak_memory_stats()
    merge.SANTA_MERGE.launches = 0
    t0 = time.perf_counter()
    gpu_scores, timing = _drive(gpu, cols, timed=True)
    main_s = time.perf_counter() - t0
    launches = merge.SANTA_MERGE.launches
    observed = WARM_EVENTS + FINAL_OBSERVE_B
    assert launches == observed > 0, (launches, observed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    cpu_scores, _ = _drive(cpu, cols, timed=False)

    got = gpu.index_state.data.cpu().numpy()
    want = cpu.index_state.data.numpy()
    index_bitwise = bool(np.array_equal(got, want))
    assert index_bitwise, (
        f"serve index, CUDA vs CPU: {int((got != want).any(1).sum())} rows "
        "differ")
    mem_diff = (gpu.mem.memory.cpu().float() - cpu.mem.memory.float()).abs()
    mem_err = float(mem_diff.max())
    mem_share = float((mem_diff > 0).float().mean())
    assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, (
        mem_err, mem_share)
    assert torch.equal(gpu.mem.last_update.cpu(), cpu.mem.last_update)
    assert float(gpu.mem.memory.float().abs().max()) > 0
    score_err = 0.0
    for b in SCORE_BS:
        g, c = gpu_scores[b], cpu_scores[b]
        assert g.shape == (b,) and np.isfinite(g).all(), b
        score_err = max(score_err, float(np.abs(g - c).max()))
    assert score_err <= SCORE_ATOL, score_err

    for b in SCORE_BS:
        s = timing["score_s"][b]
        print(f"serve score   b={b:5d}: {s * 1e3:.3f} ms/call  "
              f"{b / s:.1f} scores/s  ({card})", flush=True)
    s = timing["observe_warm_s"]
    print(f"serve observe b={OBSERVE_BS:5d}: {s * 1e3:.3f} ms/call  "
          f"{OBSERVE_BS / s:.1f} events/s  (median of "
          f"{WARM_EVENTS // OBSERVE_BS} warm-up calls; {card})", flush=True)
    s = timing["observe_final_s"]
    print(f"serve observe b={FINAL_OBSERVE_B:5d}: {s * 1e3:.3f} ms/call  "
          f"{FINAL_OBSERVE_B / s:.1f} events/s  (one call; {card})",
          flush=True)
    res = dict(n_nodes=cfg.n_nodes, n_edges=cfg.n_edges,
               observed_events=observed, santa_merge_launches=launches,
               launches_per_observed_event=launches / observed,
               main_path_s=main_s, peak_device_gib=peak_gib,
               index_bitwise_cuda_vs_cpu=index_bitwise,
               memory_max_abs_err=mem_err, memory_diff_share=mem_share,
               score_max_abs_err=score_err, card=card)
    print("serve " + json.dumps(res), flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {count} visible)", flush=True)
    card = f"{kind}, {smi.splitlines()[0].split(',')[-1].strip()}"

    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(build.SOURCES)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    shapes = kernel_phase(card)
    launches = serve_phase(card)

    main = shapes[0]
    print(json.dumps({"kernels": [{
        "name": "santa_merge",
        "route": "cuda",
        "source": "zebra_tpu_torch/csrc/santa_merge.cu",
        "replaces": "zebra_tpu/index/pallas_merge.py:43",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in shapes),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
