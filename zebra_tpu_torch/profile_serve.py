"""Where ``LinkPredictor.observe``'s time goes on the card.

    python3 -m zebra_tpu_torch.profile_serve [--aggregator mean]
        [--message_function mlp] [--use_source_embedding_in_message]
        [--use_destination_embedding_in_message] [--lazy_unique_cap C]

Builds the flagship serving configuration at full width (the one
``chip_smoke.py`` serves), with the model options given (the training
command line's flags), warms it with 2,000 observed events, times one
b = 200 observe with the host clock around synchronized calls, then
traces ``TRACED`` more with ``torch.profiler`` and splits them by the
program's spans (``utils/profiling.py``): per call, each part's host ms
and the device ms of the work it launched (``zebra.request``: the id
check and uploads; ``zebra.scan``: the index scan, one ``santa_scan``
launch, ``fill_scan`` or ``streaming_scan`` with extraction under a
message-source flag, with ``zebra.read_ids``, its id check's host read,
inside; ``zebra.protocol``: the memory protocol, under a message-source
flag the eval forward first). ``scan_wrapper_host_us`` is the scan's host
µs less the id read's. ``paced_by`` names the part with the most host
time; ``device_busy_share`` is the traced calls' device time over their
wall time, so well under 1 means the host sets the pace. Also the chunk's
levels (``scan.scan_levels``) and the kernel's cluster, and how many
observes captured, replayed or ran eagerly their protocol's CUDA graph
(``protocol_graphs``). Prints one JSON line. Needs a CUDA device."""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index import scan as index_scan
from zebra_tpu_torch.index.streaming import init_tppr_state
from zebra_tpu_torch.models.memory import init_memory
from zebra_tpu_torch.models.tgn import init_tgn_params
from zebra_tpu_torch.serve import LinkPredictor
from zebra_tpu_torch.utils.profiling import (
    OBSERVE,
    PROTOCOL,
    READ_IDS,
    REQUEST,
    SCAN,
    add_option_args,
    option_overrides,
    span_table,
)

B, WARM, TRACED = 200, 2000, 20


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
    sl = slice(WARM, WARM + B)
    observe = lambda: pred.observe(*(c[sl] for c in cols))
    res = dict(
        b=B, **options,
        message_table_bytes=pred.mem.messages.numel()
        * pred.mem.messages.element_size(),
        observe_ms=_median_s(observe) * 1e3)
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            observe()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / TRACED
    table = span_table(prof)
    n = table[OBSERVE]["calls"]
    parts = {name.split(".", 1)[1]: dict(
        host_ms=table[name]["host_ms"] / n,
        device_ms=table[name]["device_ms"] / n)
        for name in (REQUEST, SCAN, READ_IDS, PROTOCOL)}
    # one stream, so device-side events do not overlap
    per_kernel = device_ops(prof)
    busy_us = sum(us for _, us in per_kernel.values()) / TRACED
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:6]
    src, dst = (torch.as_tensor(c[sl]) for c in cols[:2])
    res.update(
        traced_observe_wall_us=wall_us,
        parts=parts,
        observe_host_ms=table[OBSERVE]["host_ms"] / n,
        scan_wrapper_host_us=1e3 * (parts["scan"]["host_ms"]
                                    - parts["read_ids"]["host_ms"]),
        paced_by=max(("request", "scan", "protocol"),
                     key=lambda k: parts[k]["host_ms"]),
        scan_kernel_us=sum(us for name, (_, us) in per_kernel.items()
                           if "santa_scan" in name) / TRACED,
        device_busy_us=busy_us,
        device_busy_share=busy_us / wall_us,
        # the device's share of an untraced observe call
        device_share_of_observe=busy_us / (1e3 * res["observe_ms"]),
        scan_depth=int(index_scan.scan_levels(
            src, dst, dst if cfg.need_emb else src,
            torch.ones(B, dtype=torch.bool), cfg.need_emb).max()) + 1,
        scan_cluster=index_scan.SANTA_SCAN.geom._asdict(),
        top_device_ops=[(name[:60], k, round(us / TRACED, 1))
                        for name, (k, us) in top],
        protocol_graphs=dict(captures=pred.protocol_captures,
                             replays=pred.protocol_replays,
                             eager=pred.protocol_eager),
        card=torch.cuda.get_device_name(0),
    )
    print(json.dumps(res))


if __name__ == "__main__":
    main()
