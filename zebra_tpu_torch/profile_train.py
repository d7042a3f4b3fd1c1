"""Where a training epoch's time goes on the card.

    python3 -m zebra_tpu_torch.profile_train [--parallel_runs S]
        [--n_devices D] [--device cuda|cuda:0] [--host_backup]
        [--tppr_strategy pruning [--n_degree W] [--n_layer D]]
        [--embedding_module graph_attention|graph_sum|identity|time]
        [--aggregator mean] [--message_function mlp]
        [--use_source_embedding_in_message]
        [--use_destination_embedding_in_message] [--lazy_unique_cap C]

Builds the flagship training configuration at full width on the bench
stream (the one ``chip_smoke.py`` trains), or with ``--tppr_strategy
pruning`` the MOOC pruning run on its MOOC-shaped stream
(:func:`mooc_pruning`, BFS width ``--n_degree`` and depth ``--n_layer``),
or with ``--embedding_module`` the Wikipedia TGN run of that tower on its
Wikipedia-shaped stream (:func:`wikipedia_attention`, neighbors per hop
``--n_degree``, hops ``--n_layer``), with S seeds in one pass when
``--parallel_runs`` is given, and the model options given (the training
command line's flags), runs a warm-up epoch, then:
- one epoch untraced, for the epoch's seconds (and, under pruning, the
  BFS calls' host time per batch);
- one epoch under ``torch.profiler``: the device-busy share, the kernels
  that take the device time and the santa kernels' device seconds (with
  the epoch's santa_waves and santa_merge launches), and the epoch split
  by the program's spans (``utils/profiling.py``): ``spans`` holds each
  span's calls, host ms and the device ms of the work launched inside it
  (``zebra.wave_plan`` and ``zebra.wave_scan`` under streaming diffusion,
  then per batch ``zebra.query``, the BFS under pruning, ``zebra.forward``,
  for the recursive towers with the hop tree's neighbor lookups
  (``zebra.hops``), the lazy GRU over every gathered row
  (``zebra.rows``) and the attention or sum layers
  (``zebra.attention``) inside it, ``zebra.backward``,
  ``zebra.adam``, ``zebra.protocol`` and ``zebra.metrics``);
  ``parts_device_share`` is each part's device ms over the busy ms;
- under pruning, one train batch's BFS alone: its device time (CUDA
  events) and the aten operations it enqueues; for a recursive tower, one
  train batch's neighbor lookups (one per hop) alone: their host time,
  their device time and their aten operations; for any tower but
  diffusion, the aten operations of one whole train batch.
- ``validate()`` + ``test()`` after a ``torch.cuda.reset_peak_memory_stats``:
  their seconds, the peak device bytes (``max_memory_allocated``) and the
  bytes allocated before them, the host copies' seconds under
  ``--host_backup``; then a ``save_state``'s seconds and bytes.
- the train batch's CUDA-graph counters over the three epochs
  (``train/graphs.py``): ``graph_captures``, ``graph_batches`` (full
  batches replayed) and ``eager_batches`` (train batches run eagerly).
Prints one JSON line; train events/s count every seed's events. Needs a
CUDA device.

With ``--n_devices D`` the S seeds are sharded over D local ranks (rank r
on ``cuda:r``, every rank on one card under ``--device cuda:0``), or with
one seed (no ``--parallel_runs``) its node rows, and each rank prints one
JSON line of its own: a warm-up and a timed epoch's seconds and waves, the
metrics gather's host ms per phase, validate() + test() as above, and the
state file's gather and write (``save_state``'s seconds: rank 0 gathers
and writes, the others send and wait). A row-sharded rank adds its row
exchange's calls, bytes and seconds per kind (``parallel/exchange.py``:
the waves' fetches, the batches' fetches and sends, the gradients' sum,
the scores' gather) for the timed epoch and for validate() + test(): host
seconds inside the calls, which wait for the device work queued before
them and for the other ranks."""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index import merge
from zebra_tpu_torch.index.neighbor_finder import most_recent_neighbors
from zebra_tpu_torch.index.queries import ensemble_tensors, pruned_queries
from zebra_tpu_torch.index.streaming import TpprState
from zebra_tpu_torch.index.wave_kernel import SANTA_WAVES
from zebra_tpu_torch.index.waves import plan_waves, wave_scan_chunk
from zebra_tpu_torch.parallel.launch import launch
from zebra_tpu_torch.profile_serve import device_ops
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.graphs import Bound
from zebra_tpu_torch.train.phase import Stream, run_phase
from zebra_tpu_torch.utils.profiling import (
    PARENTS,
    add_option_args,
    count_ops,
    device_ms,
    option_overrides,
    span_table,
)

# MOOC (BASELINE.md:66): 7,144 nodes, 411,749 events, 4 edge features
MOOC_USERS, MOOC_ITEMS = 7047, 97
# Wikipedia (BASELINE.md:67): 9,227 nodes, 157,474 events, 172 edge features
WIKI_USERS, WIKI_PAGES = 8227, 1000


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


def mooc_pruning(seed: int = 0, n_events: int = 120_000, **overrides):
    """The MOOC pruning run of ``scripts/run_baselines.sh:40`` (with the
    shared flags of ``:23-25``) at full width: pruning T-PPR with BFS width
    10 and depth 2, top-20, α (0.1, 0.1), β (0.5, 0.95), the diffusion
    tower, GRU, ``last`` aggregator, identity messages, dims 100, bs 200,
    lr 1e-4, bf16 tables; on a MOOC-shaped synthetic stream, 7,047 users ×
    97 items (MOOC's 7,144 nodes), edge_dim 4, cut from MOOC's 411,749
    events to the first ``n_events``. Returns (cfg, splits, edge_feats) on
    the host; ``overrides`` replace config fields."""
    data, edge_feats = synthetic_stream(n_events, MOOC_USERS, MOOC_ITEMS,
                                        edge_dim=4, seed=seed)
    cfg = Config(**{**dict(
        bs=200, node_dim=100, time_dim=100, memory_dim=100, topk=20,
        alpha_list=(0.1, 0.1), beta_list=(0.5, 0.95),
        tppr_strategy="pruning", n_degree=10, n_layer=2, seed=seed),
        **overrides})
    splits = split_data(data.sources, data.destinations, data.timestamps,
                        data.edge_idxs, data.labels)
    return cfg, splits, edge_feats


def wikipedia_attention(seed: int = 0, n_events: int = 120_000,
                        **overrides):
    """The repo's TGN attention run, ``python train.py -d wikipedia
    --embedding_module graph_attention`` (README.md:44-45), at the JAX
    package's defaults: graph_attention with n_degree 10, n_layer 2 and
    n_head 2, dims 100, GRU, ``last`` aggregator, identity messages, bf16
    tables, bs 200, lr 1e-4; on a Wikipedia-shaped synthetic stream, 8,227
    users × 1,000 pages (Wikipedia's 9,227 nodes), edge_dim 172, cut from
    Wikipedia's 157,474 events to the first ``n_events``. Returns (cfg,
    splits, edge_feats) on the host; ``overrides`` replace config fields
    (another tower, say)."""
    data, edge_feats = synthetic_stream(n_events, WIKI_USERS, WIKI_PAGES,
                                        edge_dim=172, seed=seed)
    cfg = Config(**{**dict(embedding_module="graph_attention", seed=seed),
                    **overrides})
    splits = split_data(data.sources, data.destinations, data.timestamps,
                        data.edge_idxs, data.labels)
    return cfg, splits, edge_feats


def tower_lookups(trainer: Trainer, i: int = 0):
    """A call that runs the recursive tower's neighbor lookups of train
    batch ``i`` as its forward does: one ``most_recent_neighbors`` per hop,
    over the batch's roots [src, dst, neg_s] of every seed lane (epoch 0's
    negatives), then over the neighbors found, at their edge times."""
    cfg = trainer.cfg
    (src, dst, *negs), t = bfs_roots(trainer, i)
    roots = torch.cat([torch.cat([src, dst, neg]) for neg in negs])
    times = t.repeat(3 * len(negs))
    index = trainer.train_nbr_index

    def call():
        nodes, cuts = roots, times
        for _ in range(cfg.n_layer):
            nbr, _, nts, _, _ = most_recent_neighbors(index, nodes, cuts,
                                                      cfg.n_degree)
            nodes, cuts = nbr.reshape(-1), nts.reshape(-1)
        return nodes

    return call


def train_batch(trainer: Trainer, i: int = 0):
    """A call that runs train batch ``i`` through ``run_phase`` on the
    trainer's state (an Adam step and the memory protocol included), with
    its T-PPR queries: under the streaming strategy the extraction rows of
    a wave scan of the batch's superchunk on a copy of the trainer's index
    (made here, once), under pruning the BFS over the train graph."""
    cfg, b = trainer.cfg, trainer.cfg.bs
    ps = trainer._streams["train"]
    negs = np.ascontiguousarray(trainer._draw_train_negs(0).T)
    stream = ps.stream._replace(neg=torch.from_numpy(negs).to(trainer.device))
    s = Stream(*(x[i * b: (i + 1) * b] for x in stream))
    queries = trainer.train_nbr_index if cfg.uses_tppr else None
    if cfg.keeps_tppr_index:
        chunk = len(ps.host["src"]) // ps.n_chunks
        sl = slice(i * b // chunk * chunk, (i * b // chunk + 1) * chunk)
        plan = plan_waves(ps.host["src"][sl], ps.host["dst"][sl], negs[sl],
                          ps.host["valid"][sl], cfg.n_nodes, cfg.wave_cap,
                          trainer.device)
        index = TpprState(trainer.index_state.data.clone())
        _, rows = wave_scan_chunk(index, trainer._tppr,
                                  *(x[sl] for x in stream), plan)
        queries = rows[i * b - sl.start: i * b - sl.start + b]
    bound = Bound(cfg, trainer.params, trainer.mem, trainer.edge_feats,
                  trainer._dropout, trainer._offs)
    return lambda: run_phase(bound, True, trainer.optimizer, s, queries, [b],
                             nbr_index=trainer.train_nbr_index)


def bfs_roots(trainer: Trainer, i: int = 0):
    """The roots of train batch ``i``'s BFS as ``run_phase`` queries them
    (epoch 0's negatives, one block per seed): (id blocks, times) on the
    trainer's device."""
    b = trainer.cfg.bs
    s = trainer._streams["train"].stream
    sl = slice(i * b, (i + 1) * b)
    negs = trainer._draw_train_negs(0).reshape(-1, s.src.shape[0])[:, sl]
    return ([s.src[sl], s.dst[sl],
             *torch.from_numpy(negs).to(trainer.device)], s.t[sl])


def eval_and_state(trainer: Trainer, path: str) -> dict:
    """validate() + test() from the trainer's train-end state, then a
    ``save_state`` to ``path``: seconds, device bytes and the gathers."""
    dev = trainer.device
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    trainer.host_copy_seconds = 0.0
    t0 = time.perf_counter()
    phases = (*trainer.validate(), *trainer.test())
    torch.cuda.synchronize(dev)
    eval_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    trainer.save_state(path)
    state_s = time.perf_counter() - t0
    return dict(
        eval_s=eval_s, eval_peak_bytes=peak, eval_base_bytes=base,
        eval_peak_reserved_bytes=torch.cuda.max_memory_reserved(dev),
        host_backup=trainer.host_backup,
        host_copy_s=trainer.host_copy_seconds,
        gather_ms={name: 1e3 * r.gather_seconds for name, r in zip(
            ("val", "nn_val", "test", "nn_test"), phases)},
        state_s=state_s,
        state_bytes=os.path.getsize(path) if trainer.mesh.lead else None)


def build(args) -> tuple:
    """(cfg, splits, edge_feats) of the run the flags choose."""
    options = option_overrides(args)
    common = dict(parallel_runs=args.parallel_runs, n_devices=args.n_devices,
                  host_backup=args.host_backup, **options)
    if args.embedding_module != "diffusion":
        return wikipedia_attention(
            embedding_module=args.embedding_module,
            tppr_strategy=args.tppr_strategy, n_degree=args.n_degree,
            n_layer=args.n_layer, **common)
    if args.tppr_strategy == "pruning":
        return mooc_pruning(n_degree=args.n_degree, n_layer=args.n_layer,
                            **common)
    return flagship_training(**common)


def exchange_stats(trainer: Trainer) -> Optional[dict]:
    """A row-sharded rank's exchange counts since their last reset, per
    kind: calls, bytes, seconds and bytes/s; None for other layouts."""
    if trainer.exchange is None:
        return None
    return {kind: dict(calls=n, bytes=b, seconds=sec,
                       gb_per_s=b / max(sec, 1e-12) / 1e9)
            for kind, (n, b, sec) in trainer.exchange.stats.items()}


def sharded_rank(args) -> None:
    """One rank of ``--n_devices D``: prints its JSON line."""
    cfg, splits, edge_feats = build(args)
    rows = cfg.n_seeds == 1
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg.replace(checkpoint_dir=tmp), splits,
                          edge_feats, device=args.device)
        epochs = []
        for _ in range(2):                     # a warm-up, a timed epoch
            merge.SANTA_MERGE.launches = SANTA_WAVES.launches = 0
            if rows:
                trainer.exchange.reset_stats()
            torch.cuda.synchronize(trainer.device)
            t0 = time.perf_counter()
            r = trainer.train_epoch()
            torch.cuda.synchronize(trainer.device)
            epochs.append(dict(seconds=time.perf_counter() - t0,
                               waves=r.waves,
                               santa_merge_launches=merge.SANTA_MERGE
                               .launches,
                               santa_waves_launches=SANTA_WAVES.launches,
                               gather_ms=1e3 * r.gather_seconds,
                               ap=np.atleast_1d(r.ap).tolist(),
                               exchange=exchange_stats(trainer)))
        if rows:
            trainer.exchange.reset_stats()
        out = eval_and_state(trainer, os.path.join(tmp, "state.ckpt"))
        out["eval_exchange"] = exchange_stats(trainer)
    print(json.dumps(dict(
        rank=trainer.mesh.rank, ranks=trainer.mesh.size,
        device=str(trainer.device), lanes=list(trainer._lanes),
        parallel_runs=cfg.n_seeds, epochs=epochs,
        backend=None if trainer.exchange is None else trainer.exchange
        .backend,
        local_node_rows=trainer.mem.memory.shape[0] // len(trainer._lanes),
        train_events_per_s_rank=(1 if rows else len(trainer._lanes))
        * splits.train.n_interactions / epochs[1]["seconds"], **out,
        card=torch.cuda.get_device_name(trainer.device))), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser("zebra_tpu_torch.profile_train")
    ap.add_argument("--parallel_runs", type=int, default=1)
    ap.add_argument("--n_devices", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--host_backup", action="store_true", default=None)
    ap.add_argument("--tppr_strategy", default="streaming",
                    choices=["streaming", "pruning"])
    ap.add_argument("--n_degree", type=int, default=10)
    ap.add_argument("--n_layer", type=int, default=2)
    ap.add_argument("--embedding_module", default="diffusion",
                    choices=["diffusion", "graph_attention", "graph_sum",
                             "identity", "time"])
    add_option_args(ap)
    args = ap.parse_args()
    if args.n_devices > 1:
        launch(sharded_rank, args.n_devices, (args,))
        return
    options = option_overrides(args)
    tower = args.embedding_module != "diffusion"
    pruning = args.tppr_strategy == "pruning" and not tower
    cfg, splits, edge_feats = build(args)
    trainer = Trainer(cfg, splits, edge_feats, device=args.device)
    n_train = splits.train.n_interactions * cfg.n_seeds
    trainer.train_epoch()                               # warm-up
    torch.cuda.synchronize()

    merge.SANTA_MERGE.launches = SANTA_WAVES.launches = 0
    t0 = time.perf_counter()
    plain = trainer.train_epoch()
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    launches = merge.SANTA_MERGE.launches
    wave_launches = SANTA_WAVES.launches

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    per_kernel = device_ops(prof)
    busy_s = sum(us for _, us in per_kernel.values()) / 1e6
    spans = span_table(prof)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    merge_s, waves_s = (sum(us for name, (_, us) in per_kernel.items()
                            if kernel in name) / 1e6
                        for kernel in ("santa_merge", "santa_waves"))

    batches = int(plain.per_batch.shape[0])
    extra = {}
    if pruning:
        blocks, t = bfs_roots(trainer, batches // 2)
        ab = ensemble_tensors(cfg, trainer.device)
        call = lambda: pruned_queries(cfg, trainer.train_nbr_index, ab,
                                      blocks, t)
        extra = dict(
            bfs_host_ms_per_batch=1e3 * plain.index_seconds / batches,
            bfs_device_ms_per_call=device_ms(call, n=20, per_round=5),
            bfs_ops_per_call=count_ops(call),
            bfs_roots_per_call=(2 + cfg.n_seeds) * cfg.bs)
    elif tower:
        if cfg.embedding_module in ("graph_attention", "graph_sum"):
            call = tower_lookups(trainer, batches // 2)
            host = []
            for _ in range(20):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                host.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            extra = dict(
                lookup_host_ms_per_batch=1e3 * sorted(host)[10],
                lookup_device_ms_per_batch=device_ms(call, n=20,
                                                     per_round=5),
                lookup_ops_per_batch=count_ops(call),
                gathered_rows_per_batch=sum(
                    3 * cfg.n_seeds * cfg.bs * cfg.n_degree ** h
                    for h in range(cfg.n_layer + 1)))
        extra["ops_per_train_batch"] = count_ops(
            train_batch(trainer, batches // 2))
    mean = lambda x: float(torch.as_tensor(x, dtype=torch.float64).mean())
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as tmp:
        extra.update(eval_and_state(trainer, os.path.join(tmp, "s.ckpt")))
    print(json.dumps(dict(
        embedding_module=cfg.embedding_module,
        tppr_strategy=cfg.tppr_strategy, n_degree=cfg.n_degree,
        n_layer=cfg.n_layer, parallel_runs=cfg.n_seeds, **options,
        train_events=n_train, batches=batches,
        waves=plain.waves, santa_merge_launches=launches,
        santa_waves_launches=wave_launches,
        epoch_s=epoch_s, train_events_per_s=n_train / epoch_s,
        index_host_s=plain.index_seconds,
        spans=spans,
        parts_device_share={name: row["device_ms"] / 1e3 / busy_s
                            for name, row in spans.items()
                            if name not in PARENTS},
        traced_epoch_s=traced_s, device_busy_s=busy_s,
        device_busy_share_traced=busy_s / traced_s,
        device_busy_share_of_epoch=busy_s / epoch_s,
        santa_merge_device_s=merge_s, santa_waves_device_s=waves_s,
        **extra,
        message_table_bytes=trainer.mem.messages.numel()
        * trainer.mem.messages.element_size(),
        device_kernels=sum(n for n, _ in per_kernel.values()),
        device_kernels_per_batch=sum(
            n for n, _ in per_kernel.values()) / batches,
        top_device_ops=[(name[:60], n, round(us / 1e3, 3))
                        for name, (n, us) in top],
        graph_captures=trainer.graph_captures,
        graph_batches=trainer.graph_batches,
        eager_batches=trainer.eager_batches,
        loss=mean(plain.loss), ap=mean(plain.ap),
        peak_device_gib=peak_gib,
        card=torch.cuda.get_device_name(0),
    )))


if __name__ == "__main__":
    main()
