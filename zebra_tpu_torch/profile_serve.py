"""Where ``LinkPredictor.observe``'s time goes on the card.

    python3 -m zebra_tpu_torch.profile_serve [--aggregator mean]
        [--message_function mlp] [--use_source_embedding_in_message]
        [--use_destination_embedding_in_message] [--lazy_unique_cap C]

Builds the flagship serving configuration at full width (the one
``chip_smoke.py`` serves), with the model options given (the training
command line's flags), warms it with 2,000 observed events, then splits
one b = 200 observe into its two parts, timed apart with the host clock
around synchronized calls:
- the index scan (one ``santa_scan`` launch: ``fill_scan``, or
  ``streaming_scan`` with extraction under a message-source flag), the
  chunk's levels (``scan.scan_levels``) and the kernel's cluster, and the
  host cost of one scan-wrapper call (``SANTA_SCAN``, no
  synchronisation);
- the memory protocol (``LinkPredictor._updated_mem``: under a
  message-source flag the eval forward first, then the fused store and
  commit under ``last``, store then commit under ``mean``);
and traces one more observe with ``torch.profiler`` for the device-busy
share and the kernels that take the device time. ``paced_by`` names the
larger of the two parts (host clock); ``device_share_of_observe`` is the
traced device time over the untraced observe time, so well under 1 means
the host sets the pace. Prints one JSON line. Needs a
CUDA device."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index import scan as index_scan
from zebra_tpu_torch.index.streaming import (
    TpprQueries,
    fill_scan,
    init_tppr_state,
    streaming_scan,
)
from zebra_tpu_torch.models.memory import MemoryState, init_memory
from zebra_tpu_torch.models.tgn import init_tgn_params
from zebra_tpu_torch.serve import LinkPredictor
from zebra_tpu_torch.utils.profiling import add_option_args, option_overrides

B, WARM = 200, 2000


def _median_s(fn, n=10):
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def device_ops(prof) -> dict:
    """Device-side work of a ``torch.profiler`` trace by name: {name:
    (count, µs)} over kernels and copies, leaving out the annotations of
    ranges (an optimizer's step) that the profiler also puts on the
    device."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def flagship(seed: int = 0, **overrides):
    """The flagship serving configuration at full width (``bench.py:93-104``,
    ``scripts/serve_bench.py:54-59``) on the bench stream of 120,000 events:
    returns (cfg, params, mem, index, edge_feats, cols), all on the CPU:
    params drawn from ``seed``, bf16 memory tables and an index that are
    empty, and cols the (src, dst, ts f32, eidx) numpy columns.
    ``overrides`` replace config fields (the model options, say)."""
    data, edge_feats = synthetic_stream(120_000, 20_000, 20_000,
                                        edge_dim=172, seed=seed)
    cfg = Config(
        node_dim=100, time_dim=100, memory_dim=100, topk=20,
        alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95),
        n_nodes=int(max(data.sources.max(), data.destinations.max())) + 1,
        n_edges=int(data.edge_idxs.max()) + 1, edge_dim=172, **overrides,
    )
    params = init_tgn_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    mem = init_memory(cfg.n_nodes, cfg.memory_dim, cfg.msg_table_dim,
                      torch.bfloat16, torch.bfloat16, device="cpu")
    index = init_tppr_state(cfg.n_tppr, cfg.n_nodes, cfg.topk, device="cpu")
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs)
    return cfg, params, mem, index, edge_feats, cols


def main() -> None:
    ap = argparse.ArgumentParser("zebra_tpu_torch.profile_serve")
    add_option_args(ap)
    options = option_overrides(ap.parse_args())
    cfg, params, mem, index, edge_feats, cols = flagship(**options)
    pred = LinkPredictor(cfg, params, mem, index, edge_feats, device="cuda")
    for lo in range(0, WARM, B):
        pred.observe(*(c[lo: lo + B] for c in cols))
    dev = pred.device
    sl = slice(WARM, WARM + B)
    src, dst, eidx = (torch.as_tensor(c[sl]).to(dev)
                      for c in (cols[0], cols[1], cols[3]))
    t = torch.as_tensor(cols[2][sl]).to(dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)

    # the parts are timed on throw-away copies of the state
    def scan():
        state = pred.index_state._replace(data=pred.index_state.data.clone())
        if not cfg.need_emb:
            fill_scan(state, pred._tppr, src, dst, t, eidx, valid)
            return None
        _, q = streaming_scan(state, pred._tppr, src, dst, dst, t, eidx,
                              valid)
        return TpprQueries(*(x.permute(1, 2, 0, 3).reshape(
            cfg.n_tppr, -1, cfg.topk) for x in q))

    q = scan()

    def protocol():
        live = pred.mem
        pred.mem = MemoryState(*(x.clone() for x in live))
        with torch.no_grad():
            pred._updated_mem(q, src, dst, t, eidx, valid)
        pred.mem = live

    def clone_only():
        pred.index_state.data.clone()
        for f in pred.mem._fields:
            getattr(pred.mem, f).clone()

    # the wrapper alone, on a scratch table: argument checks, the ctypes
    # call and the launch, never a synchronisation
    scratch = pred.index_state.data.clone()
    wrapper = lambda: index_scan.SANTA_SCAN(scratch, pred._tppr, src, dst,
                                            src, t, eidx, valid)
    wrapper()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        wrapper()
    scan_host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()

    observe = lambda: pred.observe(*(c[sl] for c in cols))
    res = dict(
        b=B, **options,
        message_table_bytes=pred.mem.messages.numel()
        * pred.mem.messages.element_size(),
        observe_ms=_median_s(observe) * 1e3,
        scan_ms=_median_s(scan) * 1e3,
        protocol_ms=_median_s(protocol) * 1e3,
        state_clone_ms=_median_s(clone_only) * 1e3,
        scan_wrapper_host_us=scan_host_us,
        scan_depth=int(index_scan.scan_levels(
            src, dst, dst if cfg.need_emb else src, valid,
            cfg.need_emb).max()) + 1,
        scan_cluster=index_scan.SANTA_SCAN.geom._asdict(),
    )
    parts = {"scan": res["scan_ms"], "protocol": res["protocol_ms"]}
    res["paced_by"] = max(parts, key=parts.get)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        observe()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # one stream, so device-side events do not overlap
    per_kernel = device_ops(prof)
    busy_us = sum(us for _, us in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    scan_us = sum(us for name, (_, us) in per_kernel.items()
                  if "santa_scan" in name)
    res.update(
        traced_observe_wall_us=wall_us,
        device_busy_us=busy_us,
        device_busy_share=busy_us / wall_us,
        scan_kernel_us=scan_us,
        # the device's share of an untraced observe call
        device_share_of_observe=busy_us / (1e3 * res["observe_ms"]),
        top_device_ops=[(name[:60], n, round(us, 1))
                        for name, (n, us) in top],
        card=torch.cuda.get_device_name(0),
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
