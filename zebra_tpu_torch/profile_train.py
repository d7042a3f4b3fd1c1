"""Where a training epoch's time goes on the card.

    python3 -m zebra_tpu_torch.profile_train [--parallel_runs S]

Builds the flagship training configuration at full width on the bench
stream (the one ``chip_smoke.py`` trains), with S seeds in one pass when
``--parallel_runs`` is given, runs a warm-up epoch, then:
- one epoch with CUDA events between its parts, read after the epoch: the
  device timeline split into the index wave loop ("index"), the towers'
  forward with the loss ("forward"), "backward", "adam", the memory
  protocol ("protocol") and the per-batch metrics ("metrics"), each the
  sum of the gaps that end at its marks. Where the host enqueues slower
  than the device runs, a gap is the host's enqueue time of that part;
- one epoch without events, for the epoch's seconds;
- one epoch under ``torch.profiler``: the device-busy share and the
  kernels that take the device time.
Prints one JSON line; train events/s count every seed's events. Needs a
CUDA device."""

from __future__ import annotations

import argparse
import json
import time

import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index import merge
from zebra_tpu_torch.profile_serve import device_ops
from zebra_tpu_torch.train.loop import Trainer


def bench_stream(seed: int = 0):
    """The bench stream of ``bench.py``: 120,000 events on 40,000 nodes,
    edge_dim 172 → (Data, edge_feats with the zero row 0)."""
    return synthetic_stream(120_000, 20_000, 20_000, edge_dim=172, seed=seed)


def flagship_training(seed: int = 0, n_events: int = 120_000, **overrides):
    """The flagship training configuration of ``bench.py:85-104`` at full
    width: streaming T-PPR top-20 with α (0.1, 0.1), β (0.05, 0.95), the
    diffusion tower, GRU, ``last`` aggregator, identity messages, dims 100,
    bs 200, bf16 tables, on the first ``n_events`` of the bench stream
    (:func:`bench_stream`). Returns (cfg, splits, edge_feats) on the host;
    ``overrides`` replace config fields (dropout=0.0, say)."""
    data, edge_feats = bench_stream(seed)
    cfg = Config(bs=200, node_dim=100, time_dim=100, memory_dim=100, topk=20,
                 alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), seed=seed,
                 **overrides)
    cols = (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels)
    splits = split_data(*(c[:n_events] for c in cols))
    return cfg, splits, edge_feats[: n_events + 1]


def split_marks(marks) -> dict:
    """Seconds of device time per part: each gap between consecutive marks
    goes to the part of the mark that ends it."""
    out: dict = {}
    for (_, a), (name, b) in zip(marks[:-1], marks[1:]):
        out[name] = out.get(name, 0.0) + a.elapsed_time(b) / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser("zebra_tpu_torch.profile_train")
    ap.add_argument("--parallel_runs", type=int, default=1)
    args = ap.parse_args()
    cfg, splits, edge_feats = flagship_training(
        parallel_runs=args.parallel_runs)
    trainer = Trainer(cfg, splits, edge_feats, device="cuda")
    n_train = splits.train.n_interactions * cfg.n_seeds
    trainer.train_epoch()                               # warm-up
    torch.cuda.synchronize()

    marks: list = []
    t0 = time.perf_counter()
    marked = trainer.train_epoch(marks=marks)
    torch.cuda.synchronize()
    marked_s = time.perf_counter() - t0
    parts = split_marks(marks)

    merge.SANTA_MERGE.launches = 0
    t0 = time.perf_counter()
    plain = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = merge.SANTA_MERGE.launches

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    per_kernel = device_ops(prof)
    busy_s = sum(us for _, us in per_kernel.values()) / 1e6
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    merge_s = sum(us for name, (_, us) in per_kernel.items()
                  if "santa_merge" in name) / 1e6

    mean = lambda x: float(torch.as_tensor(x, dtype=torch.float64).mean())
    print(json.dumps(dict(
        parallel_runs=cfg.n_seeds,
        train_events=n_train, batches=int(plain.per_batch.shape[0]),
        waves=plain.waves, santa_merge_launches=launches,
        epoch_s=epoch_s, train_events_per_s=n_train / epoch_s,
        index_host_s=plain.index_seconds,
        marked_epoch_s=marked_s, marked_parts_s=parts,
        marked_parts_share={k: v / sum(parts.values())
                            for k, v in parts.items()},
        traced_epoch_s=traced_s, device_busy_s=busy_s,
        device_busy_share_traced=busy_s / traced_s,
        device_busy_share_of_epoch=busy_s / epoch_s,
        santa_merge_device_s=merge_s,
        device_kernels=sum(n for n, _ in per_kernel.values()),
        top_device_ops=[(name[:60], n, round(us / 1e3, 3))
                        for name, (n, us) in top],
        loss=mean(plain.loss), ap=mean(plain.ap),
        marked_loss=mean(marked.loss),
        peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
        card=torch.cuda.get_device_name(0),
    )))


if __name__ == "__main__":
    main()
