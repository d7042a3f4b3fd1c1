"""Drive the PyTorch port (zebra_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent`` names an unpacked ``git archive`` of a commit with the serial
santa_scan (one block, the events in stream order): the scan and fill
phases then time it beside the cluster design, bit for bit too.

Phases, in order; any failure exits non-zero:
1. device: the card's name and power limit (nvidia-smi);
2. build: compile every CUDA kernel from zebra_tpu_torch/csrc, one nvcc per
   source, all started together (sm_90a);
3. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, with its time, the plain version's time and the least time the
   card could take:
   - santa_merge at the shapes a serving event and a training wave give it;
   - santa_scan on a b = 200 observe chunk of the bench stream and on
     chunks of a dense 301-node stream with self-loops, invalid events and
     rows shared with the previous event: 200 events at (M, k) = (2, 20),
     (3, 40) and (4, 20), one event, and 2,048 events across a tile
     boundary; untraced and traced, with and without extraction, its
     levels held equal to ``scan.scan_levels``; with the cluster, the
     depth, the widest level and the passes, ms per chunk, per event and
     per level, the traced µs of the plan and of each part of a level,
     the bound, and the serial design's time under ``--parent``;
   - santa_waves on the bench stream's first train superchunk (64,400
     events, 1,007 waves of at most 64 lanes) with one, five and two
     negatives per event (R = 3, 7, 4: one seed, phase 9's, a phase 13
     rank's) and planned at wave_cap 256 (730 waves of up to 256 lanes:
     several passes of the cluster per wave), and on 2,000 events of that
     dense stream cut into waves (self-loops, invalid events, lanes that
     write a row an earlier lane of their wave reads as a negative) at
     (M, k) = (2, 20) and (3, 40), against the per-wave santa_merge loop
     and the plain loop, untraced and traced; with the cluster's size, its
     lanes per block, the redirected negatives, the traced µs per wave of
     each part, the time beside the cooperative design's and the wave
     chain's time at santa_scan's measured µs per level beside its bound;
4. serve: the flagship serving configuration at full width (streaming T-PPR,
   top-20, two-member ensemble, diffusion tower, GRU, bf16 tables) on the
   bench stream, through ``LinkPredictor.observe``/``score`` on the card,
   replayed on the CPU and compared; one santa_scan launch per observe call;
5. waves: ``edge_step`` on waves of node-disjoint events of the same stream
   (the santa_merge path), against ``fill_scan`` of the same events;
6. fill: the whole 120,000-event bench stream through ``fill_scan`` in one
   launch: its seconds, the kernel's ms, depth and traced split, the index
   bit-equal to the stream in 200-event launches (and to the serial
   design's launch under ``--parent``), and the count of live weights that
   are subnormal;
7. train: the flagship training configuration at full width on the bench
   stream through ``Trainer`` on the card: two ``train_epoch``s (the first
   a warm-up), ``validate()`` and ``test()``, one santa_waves launch per
   superchunk scanned and no santa_merge or santa_scan launch; then the
   first 3,000 events
   replayed with dropout 0 on the card and on the CPU from the same
   params, one epoch and ``validate()``, and compared;
8. fit: the whole training run at full width on the bench stream, written
   as ``ml_bench.csv``/``.npy`` into a temporary directory:
   - the CLI (``zebra_tpu_torch.cli.main``): three epochs of ``fit`` with
     state files, the best checkpoint, ``test()``, then ``--task node``;
     one santa_waves launch per superchunk scanned in every phase, none
     of santa_merge or santa_scan;
   - preemption: ``fit`` stopped after its first superchunk by
     ``request_stop`` and resumed from its state file, against an
     uninterrupted ``fit``; the resumed index bit-equal;
   - deployment: ``LinkPredictor.from_checkpoint`` of a state file against
     ``LinkPredictor.from_trainer`` of a Trainer restored from it: scores
     bit-equal, one santa_scan launch per ``observe`` call, memory and
     index bit-equal after four calls;
9. seeds: the seed axis at full width, five seeds in one pass:
   - santa_merge at the shape a seed-parallel training wave gives it, rows
     of src, dst and five negatives (R = 7), bit for bit;
   - ``Trainer(parallel_runs=5)`` on the bench stream: a warm-up epoch, a
     timed epoch (aggregate train events/s), ``validate()`` and ``test()``
     per seed; one santa_waves launch per superchunk of the one shared
     scan, no santa_merge or santa_scan launch; the train-end index
     bit-equal to the single-seed
     Trainer's of phase 7;
   - lanes 0 and 4 of the first 3,000 events against single-seed Trainers
     with seeds 0 and 4 (dropout 0.1: the masks are the same);
   - ``EnsemblePredictor``: score is the mean of the members, member s
     agrees with ``from_checkpoint(run_index=s)``, ``from_checkpoint(
     ensemble=True)`` is bit-equal to ``from_trainer``, one santa_scan
     launch per observe call;
10. pruning: the MOOC pruning run (``scripts/run_baselines.sh:40``: BFS
    width 10, depth 2, top-20, α (0.1, 0.1), β (0.5, 0.95)) at full width
    on a MOOC-shaped stream (7,144 nodes, 120,000 events), with no santa
    kernel launched in the whole phase:
    - ``pruned_topk`` on one train batch's 600 roots on the card and on
      the CPU from the same index (the same entries, weights within 1e-5
      relative), the card's call twice (bit-equal) and with the sorted
      dedup forced (the same entries); its ms per call;
    - ``Trainer``: a warm-up epoch, a timed epoch (train events/s, the
      BFS's host ms per batch), ``validate()`` and ``test()``; the first
      3,000 events replayed with dropout 0 on the card and on the CPU, at
      the train phase's replay bars; lane 1 of ``parallel_runs=2`` against
      a single-seed Trainer with seed 1, at the seeds phase's lane bars;
    - ``LinkPredictor.from_trainer`` on the card and on the CPU: score at
      b ∈ {1, 32, 256, 2048}, four observe calls of 200 events (ms per
      call), a brand-new edge in the queries after its fold, and
      ``rebuild_every=1000`` deferring the fold until ``flush_index()``;
11. towers: README's ``--embedding_module graph_attention`` run (n_degree
    10, n_layer 2, 2 heads, dims 100, bf16 tables, bs 200, lr 1e-4) at
    full width on a Wikipedia-shaped stream (9,227 nodes, edge_dim 172,
    120,000 events), with no santa kernel launched in the whole phase:
    - ``recursive_embed`` on one train batch's 600 roots (66,600 gathered
      rows) in train and eval mode, graph_attention and graph_sum, on the
      card and on the CPU from the same params, memory with pending
      messages and adjacency index; its ms per call;
    - ``Trainer``: a warm-up and a timed epoch (train events/s), one
      train batch's device time by CUDA events (the device's busy share of
      the epoch), ``validate()``, ``test()``, peak memory;
    - the first 3,000 events replayed on the card and on the CPU at the
      train phase's bars, and 1,500 with graph_sum, identity and time;
      lane 1 of ``parallel_runs=2`` against a single-seed Trainer;
    - ``LinkPredictor.from_trainer`` on the card and on the CPU: score at
      b ∈ {1, 32, 256, 2048} (ms per call, memory at 2048), four observe
      calls of 200 events, and a brand-new edge whose id lies past the
      feature table, observed and scored;
12. options: the flagship training configuration with every single-device
    model option of the port, ``--aggregator mean --message_function mlp
    --use_source_embedding_in_message
    --use_destination_embedding_in_message`` (the TGN options of the
    reference CLI), at full width on the bench stream:
    - ``Trainer``: a warm-up and a timed epoch (train events/s, one train
      batch's device time by CUDA events: the busy share), ``validate()``
      and ``test()``; one santa_waves launch per superchunk and no
      santa_merge or santa_scan;
      the message table's bytes (872 columns and the flag) and peak
      memory;
    - the first 3,000 events replayed with dropout 0 on the card twice and
      on the CPU (losses, memory, messages, ``msg_count``, ``msg_ts``), and
      whether the two card runs are bit-equal; lane 1 of
      ``parallel_runs=2`` against a single-seed Trainer with seed 1;
    - ``LinkPredictor.from_trainer`` on the card and on the CPU: four
      observe calls of 200 events, exactly one extracting santa_scan launch
      each (the pre-edge queries feed the messages' embeddings), score at
      b ∈ {1, 32, 256, 2048}, compared;
    - the compaction on the plain flagship: ``lazy_unique_cap=-1`` (cap
      9,600), a warm-up and a timed epoch beside phase 7's per-position
      one, and a 3,000-event replay against per-position at JAX's bar
      (rtol 2e-4, atol 2e-5, f32 tables); a cap of 1,000 overflows, logs
      the warning, reruns the epoch per position, and the result is
      bit-equal to a per-position epoch from the same start;
    - ``debug_nans``: a NaN planted in an edge-feature row of the first
      train batch raises ``FloatingPointError`` in that batch;
13. seed sharding and host backup: the seed axis over two ranks that
    share the one card (``--device cuda:0``; no scaling figure), S = 4:
    - santa_merge at a rank's wave shape (64, 4, 2, 20), bit for bit;
    - (a) two ranks started by the CLI's launcher
      (``zebra_tpu_torch.parallel.launch``), the flagship, against a
      one-process ``parallel_runs=4`` Trainer on the card: the first 3,000
      events (an epoch and ``validate()``) with every lane's losses,
      params, bf16 memory and val metrics within phase 9's lane bars; then
      the bench stream, a warm-up and a timed epoch, ``validate()`` and
      ``test()``: the index bit-equal on both ranks and to the one
      process, each rank's epoch seconds and santa_waves launches (one per
      superchunk of its own scan), and how far the lanes drift from the one
      process's over the epochs (a product's summation order depends on
      the lane grouping; Adam carries it on);
    - (b) the CLI's form on two ranks: a 2-epoch ``fit`` with
      ``--state_every 1``, and a 1-epoch run resumed from its state file to
      2 epochs, bit-equal; the ``_par_4`` state file served as an
      ``EnsemblePredictor`` and lane 3 as a ``LinkPredictor``, against the
      predictors of a one-process Trainer restored from it, at the serve
      phase's bar;
    - (c) host backup: ``validate()`` + ``test()`` of the flagship at S = 5
      from one train-end state under both protocols, bit-equal, with each
      one's peak device bytes (the host protocol's lower), the host copies'
      seconds and the table copies the guard counts;
    - (d) the guard's decision at Wiki-Talk's 1,140,096 nodes for S = 1, 2,
      … from this card's free memory;
14. row sharding: one seed's node rows over two ranks that share the one
    card (``--device cuda:0``, the row exchange's Gloo form; no scaling
    figure), the flagship at full width:
    - (a) two ranks started by ``zebra_tpu_torch.parallel.launch`` against
      one process on the card: the first 3,000 events (an epoch and
      ``validate()``, dropout 0) at phase 9's lane bars; then the bench
      stream (dropout 0.1), a
      warm-up and a timed epoch (each rank's seconds, waves, santa_merge
      launches, one per wave of every rank's scan and no santa_waves
      launch, and the exchange's bytes
      and seconds per kind), ``validate()`` + ``test()`` under the device
      protocol and, from the saved train-end state, under host backups
      (bit-equal, each one's peak device bytes); the index bit-equal on
      both ranks and to the one process; the params bit-equal across ranks;
    - (b) the CLI's form, ``--n_devices 2`` with one seed, on the first
      10,000 events: a 2-epoch ``fit`` with ``--state_every 1``, a 1-epoch
      run resumed from its state file to 2 epochs, bit-equal; the state
      file served by a one-process ``LinkPredictor`` on the card, bit-equal
      to the predictor of a one-process Trainer restored from it;
    - (c) owner-aligned waves and the id interleave on the Wikipedia-shaped
      stream with the flagship's diffusion tower: the waves of a train
      epoch of the 120,000-event stream under the plain, aligned and
      aligned + interleaved schedules; one epoch and ``validate()`` of the
      plain and the interleaved run on its first 10,000 events, the
      interleaved index mapped back through the inverse permutation
      bit-equal to the plain one, and the interleaved run's state file
      served on external ids against the plain run's;
    - (d) the guard's decisions for one seed at 1,140,096 nodes over D = 1,
      2, 4 and 8 ranks, with the rows per rank;
    - (e)-(g), the ranks started once for all: the MOOC pruning run, the
      options (``OPTIONS``) and the compaction at the auto cap, at an
      overflowing cap (its rerun bit-equal to per-position training on the
      ranks) and per position, on the bench stream, and the Wikipedia
      graph_attention run, each cut to its first 10,000 events, and
      graph_sum, identity and time on 1,500; f32 tables and dropout 0. Each
      leg's train epoch, ``validate()`` and ``test()`` on two ranks against
      one process on the card (``ROWS_LEGS``' bars), with each rank's
      epoch seconds, the exchange's bytes and seconds per kind, the
      recursive towers' distinct fetch against the ids named, the peak of
      ``validate()`` + ``test()``, and santa_merge's launches per rank (the
      waves on the streaming legs, none under pruning and the towers);
    - (h) the CLI's ``--n_devices 2 --task node`` fit on the flagship's
      first 10,000 events: the node AUCs every rank replays at full N equal
      to one process's replay from the state file, which serves bit-equal
      to that process's predictor; each rank's replay scans a superchunk
      in one santa_waves launch (full N, no exchange);
15. one ``{"kernels": [...]}`` line;
16. last line ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result."""

from __future__ import annotations

import functools
import gc
import json
import logging
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from zebra_tpu_torch import build, cli
from zebra_tpu_torch.config import Config, torch_dtype
from zebra_tpu_torch.data.dataset import get_data, load_feat, split_data
from zebra_tpu_torch.data.preprocess import write_ml
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.index import merge, pruning, scan
from zebra_tpu_torch.index.wave_kernel import SANTA_WAVES, TRACE_PARTS
from zebra_tpu_torch.index.waves import (
    plan_waves,
    redirects,
    wave_scan_reference,
)
from zebra_tpu_torch.index.neighbor_finder import (
    build_neighbor_index,
    most_recent_neighbors,
)
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    TpprState,
    _columns,
    edge_step,
    fill_scan,
    init_tppr_state,
    row_width,
    streaming_scan,
)
from zebra_tpu_torch.models.embedding import recursive_embed
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.models.tgn import init_tgn_params, lane_params
from zebra_tpu_torch.parallel.launch import launch
from zebra_tpu_torch.parallel.sharding import (
    interleave_inverse,
    interleave_permutation,
)
from zebra_tpu_torch.profile_serve import flagship
from zebra_tpu_torch.profile_train import (
    bench_stream,
    bfs_roots,
    flagship_training,
    mooc_pruning,
    train_batch,
    wikipedia_attention,
)
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor
from zebra_tpu_torch.train import memory_budget as mb
from zebra_tpu_torch.train.checkpoint import load_checkpoint
from zebra_tpu_torch.train import phase as phase_mod
from zebra_tpu_torch.train.node_classification import run_node_classification
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.index.queries import ensemble_tensors, pruned_queries
from zebra_tpu_torch.train.step import flush_pending_
from zebra_tpu_torch.utils.profiling import device_ms

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

ALPHA = (0.1, 0.1, 0.0, 0.2)
BETA = (0.05, 0.95, 0.5, 0.8)
# (what gives the kernel this shape, W edges, M members, top-k)
MERGE_SHAPES = [("serving observe", 1, 2, 20), ("training wave", 64, 2, 20),
                ("large k", 64, 3, 40)]
# (what gives the scan this shape, E events, M members, top-k): chunks of
# the dense 301-node stress stream (scan_stream); the scan phase puts a
# b = 200 observe chunk of the bench stream first, its events
# [SCAN_BENCH_WARM, SCAN_BENCH_WARM + 200) with random negatives on the
# index a plain fill of the events before them leaves
SCAN_SHAPES = [("serving observe", 200, 2, 20), ("large k", 200, 3, 40),
               ("one event", 1, 2, 20), ("tile boundary", 2048, 2, 20),
               ("ensemble of four", 200, 4, 20)]
SCAN_BENCH_WARM = 2000
WAVE_EVENTS, WAVE_CAP = 2000, 64
FLT_MIN = 1.17549435e-38

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
# Train-replay bars, CUDA vs CPU from the same params with dropout 0:
# - index tables: bit-equal (the kernel equals its plain version, and the
#   index does not depend on the params);
# - memory table (bf16): the serve phase's bars above, for the same reason;
#   the params themselves differ by the products' summation order;
# - per-batch losses: that order through the towers and the BCE
#   (2.4e-7 measured between an H100 and the CPU of its host).
TRAIN_REPLAY_EVENTS = 3000
TRAIN_LOSS_ATOL = 1e-5
SCORE_BS = (1, 32, 256, 2048)
FINAL_OBSERVE_B = 256
# Fit phase: the CLI's flags for the flagship configuration, a superchunk
# size that cuts the train stream into 4 for the preemption leg, and the
# deployment's requests.
FIT_FLAGS = ["--bs", "200", "--topk", "20", "--alpha_list", "0.1", "0.1",
             "--beta_list", "0.05", "0.95", "--node_dim", "100",
             "--time_dim", "100", "--memory_dim", "100", "--n_epoch", "3",
             "--patience", "5", "--state_every", "1", "--save_best",
             "--task", "node"]
PREEMPT_CHUNK, PREEMPT_EPOCHS = 16384, 2
DEPLOY_SCORE_B, DEPLOY_CALLS, DEPLOY_OBSERVE_B = 2048, 4, 200
# Preemption bars, resumed against uninterrupted, if the two are not bit
# for bit equal: the index is held bit-equal (it depends only on the
# stream and the negatives); memory at the replay's bars; params and test
# metrics at 1e-5, an f32 summation order through two epochs.
RESUME_PARAM_ATOL, RESUME_METRIC_ATOL = 1e-5, 1e-5
# Seeds phase: five seeds in one pass (README's --parallel_runs 5), a merge
# of rows [W, R = 2 + 5, F], the replayed lanes and the ensemble's calls.
SEEDS = 5
SEED_MERGE = ("seed-parallel training wave", 64, 2 + SEEDS, 2, 20)
SEED_REPLAY_LANES = (0, 4)
ENSEMBLE_SCORE_B, ENSEMBLE_CALLS, ENSEMBLE_OBSERVE_B = 2048, 4, 200
# Lane replay bars, lane s of the seed-parallel Trainer against a
# single-seed Trainer with seed s on the same card: the masks, negatives
# and inits are the same, so the two differ only by the summation order of
# a batched product against a plain one:
# - per-batch losses at the CUDA-vs-CPU replay's 1e-5;
# - params within 2·lr per Adam step: where a gradient is near zero its
#   sign can follow the summation order, and Adam then steps that weight
#   by about ±lr either way;
# - memory at the serve phase's bars;
# - val AP, AUC and accuracy at 1e-3: they move in steps where two scores
#   swap.
LANE_LOSS_ATOL, LANE_METRIC_ATOL = 1e-5, 1e-3
# Ensemble bars: score against the mean of member_scores (one f32 mean in
# another order) and a member against its single-seed predictor (a batched
# product against a plain one).
ENSEMBLE_MEAN_ATOL, ENSEMBLE_MEMBER_ATOL = 1e-6, 1e-5
# Pruning phase: the BFS of this train batch, its bars (CUDA against CPU:
# the same live entries but those within 1e-4 of the k-th weight, the rule
# of tests/test_pruning_index.py:108-116, and weights within 1e-5 relative;
# the sorted dedup against the matrix on the card: the same, within 1e-6),
# the seed lanes, and the serve leg's observe calls; scores and memory at
# the serve phase's bars.
BFS_BATCH, BFS_REL, DEDUP_REL = 100, 1e-5, 1e-6
PRUNE_SEEDS, PRUNE_LANES = 2, (1,)
PRUNE_OBSERVE_CALLS, PRUNE_OBSERVE_B = 4, 200
# Towers phase: the repo's TGN attention run on a Wikipedia-shaped stream
# (profile_train.wikipedia_attention). One train batch's embeddings, card
# against CPU from the same params, memory and graph: the products'
# summation order (cuBLAS against the CPU's BLAS) through two hops and, in
# train mode, the lazy GRU of 66,600 rows, within 1e-4 of the result's
# largest entry. The replays, the seed lane and the serve leg keep the
# train, seeds and serve phases' bars; graph_sum, identity and time replay
# fewer events.
TOWER_BATCH, TOWER_ATOL = 100, 1e-4
TOWER_REPLAYS = (("graph_sum", 1500), ("identity", 1500), ("time", 1500))
TOWER_SEEDS, TOWER_LANES = 2, (1,)
# Options phase: every single-device model option of the port on the
# flagship; its serve leg's observe calls; the compaction leg's caps and
# JAX's bar for compacted against per-position training
# (tests/test_train_loop.py:186-210, f32 tables).
OPTIONS = dict(aggregator="mean", message_function="mlp",
               use_source_embedding_in_message=True,
               use_destination_embedding_in_message=True)
OPTIONS_OBSERVE_CALLS, OPTIONS_OBSERVE_B = 4, 200
OPTIONS_SEEDS, OPTIONS_LANES = 2, (1,)
AUTO_CAP, OVERFLOW_CAP = -1, 1000
LAZY_RTOL, LAZY_ATOL = 2e-4, 2e-5
# Replay bar of the message table, card against CPU: a bf16 row holds
# memory rows, embeddings (products in another summation order) and, under
# mean, sums of them, so an entry may round to the next bf16 value where
# its f32 value sits at a boundary: within two bf16 ulps of its size
# (2^-6 relative) plus the memory bar.
MESSAGE_REL = 2.0 ** -6
# Phase 13: the seed axis over two ranks that share one card (the machine
# has one): S = 4 seeds, two whole seeds per rank, so a rank's training wave
# merges rows [W, 2 + 2, F]; the CLI's flags for the flagship with them; the
# host-backup leg's seeds (phase 9's five); the guard's node count, that of
# Wiki-Talk (SNAP wiki-Talk, 1,140,096 once padded to a multiple of 128;
# no edge features, so edge_dim 1). The lanes keep phase 9's bars against
# the one-process run; the served scores the serve phase's.
SHARD_SEEDS, SHARD_RANKS = 4, 2
SHARD_MERGE = ("seed-sharded training wave (a rank's two lanes)", 64,
               2 + SHARD_SEEDS // SHARD_RANKS, 2, 20)
SHARD_FLAGS = ["--bs", "200", "--topk", "20", "--alpha_list", "0.1", "0.1",
               "--beta_list", "0.05", "0.95", "--node_dim", "100",
               "--time_dim", "100", "--memory_dim", "100", "--patience", "5",
               "--state_every", "1", "--parallel_runs", str(SHARD_SEEDS)]
BACKUP_SEEDS = SEEDS
# santa_waves: the negatives per event of the training superchunks it scans
# (one seed, phase 9's seeds, a phase 13 rank's); the wider cap the one-seed
# superchunk is planned at besides (waves wider than the cluster holds at
# once); the events of the dense stress chunk and its (M, k)
WAVES_SEEDS = (("train superchunk", 1),
               ("seed-parallel train superchunk", SEEDS),
               ("seed-sharded rank's train superchunk",
                SHARD_SEEDS // SHARD_RANKS))
WAVES_WIDE_CAP = 256
WAVES_STRESS_EVENTS = 2000
WAVES_STRESS_SHAPES = ((2, 20), (3, 40))
# santa_waves' device ms at those chunks in its cooperative-grid design (a
# grid of the widest wave's blocks, two software grid barriers per wave, a
# global stage): scripts/trace_coop_waves.py on an NVIDIA H100 80GB HBM3
# at 700.00 W
WAVES_COOP_MS = {
    "train superchunk": 7.937903881072998,
    "seed-parallel train superchunk": 10.209728240966797,
    "seed-sharded rank's train superchunk": 8.553823947906494,
    f"train superchunk at wave_cap {WAVES_WIDE_CAP}": 5.7934558391571045,
    "dense 301-node stress, M = 2, k = 20": 1.031711995601654,
    "dense 301-node stress, M = 3, k = 40": 1.7480159997940063,
}
GUARD_SEEDS = (2, BACKUP_SEEDS)
WIKI_TALK_NODES = 1_140_096
# Phase 14, row sharding: one seed over two ranks on the one card; the
# CLI's flags for the flagship with one seed; the cut streams of the CLI
# and the alignment legs; the mesh sizes the guard is asked about. The
# replay keeps phase 9's lane bars against one process, with dropout 0 as
# phase 7's replay: the gradient's sum over two blocks rounds in another
# order (and a block's products may run other kernels), and with dropout's
# 1/(1 - p) scaling such last-bit differences cross more bf16 rounding
# boundaries (on the CPU, 9 batches of the replay: 1.8e-5 with dropout 0.1,
# 3.7e-6 without; 1.2e-7 with f32 tables and dropout 0.1, the masks being
# the one process's). Served scores are held bit-equal.
ROWS_RANKS = 2
ROWS_REPLAY_DROPOUT = 0.0
ROWS_FLAGS = [f for f in SHARD_FLAGS[:-2]]
ROWS_CLI_EVENTS = ROWS_WIKI_EVENTS = 10_000
ROWS_GUARD_DEVICES = (1, 2, 4, 8)
ROWS_TPPR = dict(bs=200, topk=20, alpha_list=(0.1, 0.1),
                 beta_list=(0.05, 0.95), embedding_module="diffusion")
# Phase 14's legs (e)-(g): the options beyond the flagship's, each cell cut
# to its first ROWS_LEG_EVENTS events (the memory-only and sum towers'
# replays to ROWS_TOWER_EVENTS), on f32 tables with dropout 0 as the CPU
# tests run them (tests/test_torch_row_sharded_*.py): the per-batch loss
# within 1e-6 of 1 + |loss| and the params bit-equal across ranks, as
# there; every batch's probabilities and the memory within 1e-5, where the
# CPU tests' 16-wide runs hold 1e-6: at width 100 on the card the time
# tower's probabilities came 1.5e-6 from one process (its Δt·w factor
# scales a param's last bits) and the pruning leg's memory 1.6e-6 after 35
# batches (the gradient's sum over two blocks, carried by Adam: params
# 1.1e-6 apart). AP, AUC and accuracy are reported, not held: at bs 200
# ties come
# in groups (fresh rows embed alike), so an ulp may move a batch's AUC by
# more than one event's share (1.5e-2 seen on the CPU under the options).
# The compaction leg's cap is the auto rule's floor, which the cut's
# batches overflow. (h) holds the node AUCs of the CLI's run within 1e-6
# of one process's replay from its state file.
ROWS_LEG_EVENTS, ROWS_TOWER_EVENTS = 10_000, 1_500
ROWS_LEG_TABLES = dict(memory_dtype="float32", message_dtype="float32",
                       dropout=0.0)
ROWS_LEG_ATOL, ROWS_LEG_DRIFT_ATOL = 1e-6, 1e-5
ROWS_OVERFLOW_CAP = 256
ROWS_LEGS = {
    "pruning": (mooc_pruning, ROWS_LEG_EVENTS, {}),
    "options": (flagship_training, ROWS_LEG_EVENTS, OPTIONS),
    "lazy_auto": (flagship_training, ROWS_LEG_EVENTS,
                  dict(lazy_unique_cap=AUTO_CAP)),
    "lazy_overflow": (flagship_training, ROWS_LEG_EVENTS,
                      dict(lazy_unique_cap=ROWS_OVERFLOW_CAP)),
    "per_position": (flagship_training, ROWS_LEG_EVENTS,
                     dict(lazy_unique_cap=0)),
    "graph_attention": (wikipedia_attention, ROWS_LEG_EVENTS, {}),
    **{tower: (wikipedia_attention, ROWS_TOWER_EVENTS,
               dict(embedding_module=tower))
       for tower in ("graph_sum", "identity", "time")},
}


def merge_work(rows: torch.Tensor, m: int, k: int):
    """What one merge of these gathered rows [W, R, F] must do: bytes
    (rows 0-1 of each edge and its 4 scalars in, the two new rows out) and
    operations. For a lane (edge, direction, member) whose two rows hold L
    live entries that is a top-k selection over C = L + 1 candidates, at
    least C·⌈log2 C⌉ comparisons, 2L for the twin lookup and the weight
    scaling, and 8 for the scales."""
    w = rows.shape[0]
    f = row_width(m, k)
    nbytes = w * 2 * f * 4 + w * 16 + w * 2 * f * 4
    weights = rows[:, :2, : 4 * m * k].reshape(w, 2, m, 4, k)[:, :, :, 0]
    live = (weights > 0).sum((1, 3)).double()          # [W, M], both rows
    c = live + 1
    per_lane = c * torch.ceil(torch.log2(c.clamp(min=2))) + 2 * live + 8
    return nbytes, 2 * float(per_lane.sum())            # two directions


def scan_work(rows: torch.Tensor, cols, m: int, k: int, extract: bool):
    """What one scan of a chunk must do, from its pre-edge rows [E, 3, F]
    and its columns (src, dst, neg, ts, eidx, valid). Bytes: each distinct
    row whose pre-chunk value the chunk needs read once (src and dst of the
    valid events; of every event, and neg too, when extracting), each
    distinct row a valid event writes written once, the columns (4 bytes
    for each of src, dst, eidx, ts, 1 for valid, 4 for neg when
    extracting) and the extraction rows [E, 3, F]. A row that an event
    writes and a later one reads stays on the chip. Operations: the merges
    of the events whose result is used (:func:`merge_work`)."""
    src, dst, neg, _, _, valid = cols
    n, f = src.shape[0], row_width(m, k)
    distinct = lambda *ids: int(torch.unique(torch.cat(ids)).numel())
    used = slice(None) if extract else valid
    read = (distinct(src, dst, neg) if extract
            else distinct(src[valid], dst[valid]))
    written = distinct(src[valid], dst[valid])
    nbytes = ((read + written) * f * 4 + n * (17 + 4 * extract)
              + extract * n * 3 * f * 4)
    _, ops = merge_work(rows[used], m, k)
    return nbytes, ops


def bound(nbytes: float, ops: float):
    """Least time (ms) for this work on the card: the larger of bytes over
    the HBM rate and operations over the f32 rate. Returns (ms, 'bytes' |
    'operations')."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def warm_stream(m: int, k: int, seed: int, extra: int):
    """The index after a plain (CPU) streaming_scan over a 1,500-event
    synthetic stream on 301 nodes, and the (src, dst, neg, ts f32, eidx)
    numpy columns of the ``extra`` events that follow."""
    data, _ = synthetic_stream(1500 + extra, 150, 150, seed=seed)
    e = 1500
    params = TpprParams.create(ALPHA[:m], BETA[:m], k)
    rng = np.random.RandomState(seed)
    neg = rng.randint(1, 301, 1500 + extra).astype(np.int32)
    ts = data.timestamps.astype(np.float32)
    state = init_tppr_state(m, 301, k, device="cpu")
    state, _ = streaming_scan(state, params, data.sources[:e],
                              data.destinations[:e], neg[:e], ts[:e],
                              data.edge_idxs[:e], np.ones(e, bool))
    sl = slice(e, e + extra)
    cols = (data.sources[sl].copy(), data.destinations[sl].copy(),
            neg[sl].copy(), ts[sl], data.edge_idxs[sl])
    return params, state.data, cols


def realistic_rows(w: int, m: int, k: int, seed: int):
    """Gathered rows [W, 3, F] on the card of the W events that follow
    :func:`warm_stream`'s 1,500, with their (src, dst, eidx, ts)."""
    params, data, (src, dst, neg, ts, eidx) = warm_stream(m, k, seed, w)
    sdn = np.stack([src, dst, neg], 1)
    cuda = lambda a: torch.as_tensor(a).cuda()
    rows = cuda(data[torch.from_numpy(sdn).long()])
    return params, rows, cuda(src), cuda(dst), cuda(eidx), cuda(ts)


def scan_stream(n: int, m: int, k: int, seed: int, device: str = "cuda"):
    """:func:`warm_stream`'s index on the card and its next ``n`` events,
    with the cases where a fused scan most easily differs from the loop:
    self-loops (every 9th event), invalid events (every 7th), neg equal to
    the previous event's src (every 5th) or dst (every 6th), and src equal
    to the previous dst (every 8th). The 301-node stream shares nodes
    between near events all the time besides. Returns (params, data,
    columns on ``device``)."""
    params, data, (src, dst, neg, ts, eidx) = warm_stream(m, k, seed, n)
    valid = np.ones(n, bool)
    valid[3::7] = False
    for step, col, prev in ((8, src, dst), (5, neg, src), (6, neg, dst)):
        i = np.arange(step // 4, n, step)
        col[i] = prev[i - 1]
    dst[::9] = src[::9]
    data = data.to(device)
    return params, data, _columns(data, src, dst, neg, ts, eidx, valid)


def _equal(got, want, what):
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert torch.equal(got, want), f"{what}: max abs err {err}"
    return err


def seed_merge_phase(card: str, shape=SEED_MERGE):
    """santa_merge on the rows of a seed-parallel training wave: src, dst
    and one negative per seed, [W, 2 + S, F] with row stride (2 + S)·F;
    the kernel reads rows 0-1."""
    what, w, r, m, k = shape
    params, data, (src, dst, neg, ts, eidx) = warm_stream(m, k, w + r, w)
    extra = np.random.RandomState(w + r).randint(1, 301, (w, r - 3))
    sdn = np.concatenate([np.stack([src, dst, neg], 1), extra], 1)
    cuda = lambda a: torch.as_tensor(a).cuda()
    rows = cuda(data[torch.from_numpy(sdn).long()])
    src, dst, eidx, ts = cuda(src), cuda(dst), cuda(eidx), cuda(ts)
    assert rows.shape == (w, r, row_width(m, k)) and rows.is_contiguous()
    kernel = lambda: merge.SANTA_MERGE(rows, src, dst, eidx, ts, params)
    plain = lambda: merge.merge_both_reference(rows, src, dst, eidx, ts,
                                               params)
    err = _equal(kernel(), plain(), f"santa_merge {what}")
    bound_ms, bound_by = bound(*merge_work(rows, m, k))
    res = dict(shape=what, W=w, R=r, M=m, k=k, max_abs_err=err,
               ms=device_ms(kernel),
               plain_ms=device_ms(plain, n=60, per_round=10),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               card=card)
    print("kernel santa_merge " + json.dumps(res), flush=True)
    return res


def merge_phase(card: str):
    results = []
    for what, w, m, k in MERGE_SHAPES:
        params, rows, src, dst, eidx, ts = realistic_rows(w, m, k, seed=w + k)
        kernel = lambda: merge.SANTA_MERGE(rows, src, dst, eidx, ts, params)
        plain = lambda: merge.merge_both_reference(rows, src, dst, eidx, ts,
                                                   params)
        want = plain()
        want_cpu = merge.merge_both_reference(
            rows.cpu(), src.cpu(), dst.cpu(), eidx.cpu(), ts.cpu(), params)
        err = _equal(kernel(), want, f"santa_merge {what}")
        plain_cpu_same = bool(torch.equal(want.cpu(), want_cpu))
        # the plain version makes 70 device operations per call
        ms = device_ms(kernel)
        plain_ms = device_ms(plain, n=60, per_round=10)
        bound_ms, bound_by = bound(*merge_work(rows, m, k))
        res = dict(shape=what, W=w, M=m, k=k,
                   max_abs_err=err, plain_cuda_equals_plain_cpu=plain_cpu_same,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=None, card=card)
        print("kernel santa_merge " + json.dumps(res), flush=True)
        results.append(res)
    return results


def _event_ms(fn, n: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``n`` calls, each between
    two CUDA events (for the plain scan: thousands of launches a call, so
    the host's enqueue rate sets it)."""
    times = []
    for _ in range(n):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def scan_chunks(device: str = "cuda"):
    """The chunks santa_scan is held on: (what, params, start table, columns
    on ``device``). First a b = 200 observe chunk of the bench stream (the
    flagship's (α, β) and top-20; random negatives), then
    :data:`SCAN_SHAPES`' chunks of :func:`scan_stream`."""
    data, _ = synthetic_stream(120_000, 20_000, 20_000, seed=0)
    src, dst = data.sources, data.destinations
    n_nodes = int(max(src.max(), dst.max())) + 1
    neg = np.random.RandomState(0).randint(0, n_nodes, len(src))
    ts, eidx = data.timestamps.astype(np.float32), data.edge_idxs
    ones = np.ones(len(src), bool)
    params = TpprParams.create(ALPHA[:2], BETA[:2], 20)
    w = slice(0, SCAN_BENCH_WARM)
    start = fill_scan(init_tppr_state(2, n_nodes, 20, device="cpu"), params,
                      src[w], dst[w], ts[w], eidx[w], ones[w]).data.to(device)
    sl = slice(SCAN_BENCH_WARM, SCAN_BENCH_WARM + OBSERVE_BS)
    yield "bench observe", params, start, _columns(
        start, src[sl], dst[sl], neg[sl], ts[sl], eidx[sl], ones[sl])
    for what, n, m, k in SCAN_SHAPES:
        yield (what,) + scan_stream(n, m, k, seed=n + k, device=device)


def parent_scan(archive: Path):
    """The serial santa_scan of an unpacked ``git archive`` of a commit
    before the cluster design (4881985: one block, the events in stream
    order), built with the port's nvcc flags into ``archive/_parent_build``.
    Returns ``run(data, params, cols, ext=None)``, which launches it on the
    current stream."""
    import ctypes

    from zebra_tpu_torch.index.merge import host_coefficients

    csrc = Path(archive).resolve() / "zebra_tpu_torch" / "csrc"
    out = csrc.parents[1] / "_parent_build" / "libsanta_scan_serial.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc),
                    "-o", str(out), str(csrc / "santa_scan.cu")], check=True,
                   capture_output=True, timeout=600)
    fn = ctypes.CDLL(str(out)).santa_scan
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int, ptr]
    fn.restype = ctypes.c_int

    def run(data, params, cols, ext=None):
        src, dst, neg, ts, eidx, valid = cols
        alpha, beta = host_coefficients(params)
        rc = fn(data.data_ptr(), src.data_ptr(), dst.data_ptr(),
                neg.data_ptr(), eidx.data_ptr(), ts.data_ptr(),
                valid.data_ptr(), ctypes.addressof(alpha),
                ctypes.addressof(beta), None if ext is None else
                ext.data_ptr(), src.shape[0], len(params.alpha), params.k,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"serial santa_scan: cudaError {rc}")

    return run


def scan_trace_split(stamps: torch.Tensor, mhz: float) -> dict:
    """µs of each part of a traced santa_scan launch from its clock64
    stamps [E + 1, 5] (``scan.TRACE_PARTS``; thread 0 of block 0): each
    stamp ends the span since the one before it in time, which counts to
    its part. The plan per tile, the other parts per level, and the
    launch's stamped µs in all."""
    t = stamps.cpu().numpy()
    depth, tiles = int(t[0, 1]), int(t[0, 2])
    marks = sorted([(t[0, 0], -1)] + [
        (v, p) for row in t[1: 1 + depth] for p, v in enumerate(row) if v])
    total = np.zeros(len(scan.TRACE_PARTS))
    for (a, _), (b, p) in zip(marks, marks[1:]):
        total[p] += b - a
    per = [max(tiles, 1)] + [max(depth, 1)] * (len(scan.TRACE_PARTS) - 1)
    split = {part: float(total[i] / per[i] / mhz)
             for i, part in enumerate(scan.TRACE_PARTS)}
    plan_end = t[1, 0] if depth else t[0, 4]
    first_plan = np.diff([t[0, 0], t[0, 3], t[0, 4], plan_end]) / mhz
    return dict(split, levels=depth, tiles=tiles,
                first_plan=dict(zip(("slots", "walk", "rank"),
                                    first_plan.tolist())),
                stamped_us=float((marks[-1][0] - marks[0][0]) / mhz))


def _level_widths(levels: np.ndarray, per_pass: int) -> dict:
    widths = np.bincount(levels[levels >= 0])
    return dict(depth=len(widths), widest_level=int(widths.max(initial=0)),
                passes=int(np.ceil(widths / per_pass).sum()))


def scan_phase(card: str, parent=None):
    """santa_scan on each of :func:`scan_chunks` against scan_reference on
    the card, with and without extraction, untraced and traced: bit for bit
    in the table and the extraction rows (filled with NaN first), its levels
    equal to ``scan.scan_levels``. Per chunk: the geometry, the depth, the
    widest level and the cluster's passes, ms and µs per event and per
    level, the traced split at the SM clock nvidia-smi reads, the plain
    scan's time, the bound, and with ``parent`` (:func:`parent_scan`) the
    serial design's time, checked bit for bit too."""
    results = []
    for what, params, start, cols in scan_chunks():
        m, k = len(params.alpha), params.k
        n, f = cols[0].shape[0], start.shape[1]
        want = start.clone()
        want_rows = scan.scan_reference(want, params, *cols)
        cpu = start.to("cpu", copy=True)
        cpu_rows = scan.scan_reference(cpu, params, *(c.cpu() for c in cols))
        plain_cpu_same = bool(torch.equal(want.cpu(), cpu)
                              and torch.equal(want_rows.cpu(), cpu_rows))
        host = [c.cpu() for c in cols]
        want_levels = {x: scan.scan_levels(host[0], host[1], host[2],
                                           host[5], x) for x in (True, False)}
        levels = torch.empty(n, dtype=torch.int32, device="cuda")
        trace = torch.zeros((n + 1, len(scan.TRACE_PARTS)), dtype=torch.int64,
                            device="cuda")
        err = 0.0
        for extract in (True, False):
            for tr in (None, trace):
                got = start.clone()
                ext = (torch.full((n, 3, f), float("nan"), device="cuda")
                       if extract else None)
                levels.fill_(-2)
                scan.SANTA_SCAN(got, params, *cols, ext=ext, levels=levels,
                                trace=tr)
                torch.cuda.synchronize()
                tag = (f"santa_scan {what} extract={extract}"
                       + (" traced" if tr is not None else ""))
                err = max(err, _equal(got, want, tag + " data"))
                if extract:
                    err = max(err, _equal(ext, want_rows, tag + " rows"))
                assert np.array_equal(levels.cpu().numpy(),
                                      want_levels[extract]), tag + " levels"
        geom = scan.SANTA_SCAN.geom
        work = start.clone()
        ext = torch.empty((n, 3, f), device="cuda")
        run = lambda e=None, tr=None: scan.SANTA_SCAN(work, params, *cols,
                                                      ext=e, trace=tr)
        ms = device_ms(run, n=20, per_round=20)
        ms_extract = device_ms(lambda: run(ext), n=20, per_round=20)
        traced_ms = device_ms(lambda: run(None, trace), n=20, per_round=20)
        mhz = sm_clock_mhz(lambda: run(None, trace), max(50, int(2000 / ms)))
        splits = {}
        for extract in (False, True):
            trace.zero_()
            run(ext if extract else None, trace)
            splits[extract] = scan_trace_split(trace, mhz)
        serial = {}
        if parent is not None:
            for extract in (True, False):
                got = start.clone()
                pext = (torch.full((n, 3, f), float("nan"), device="cuda")
                        if extract else None)
                parent(got, params, cols, pext)
                torch.cuda.synchronize()
                tag = f"serial santa_scan {what} extract={extract}"
                _equal(got, want, tag + " data")
                if extract:
                    _equal(pext, want_rows, tag + " rows")
            serial = dict(
                serial_ms=device_ms(lambda: parent(work, params, cols),
                                    n=20, per_round=20),
                serial_ms_extract=device_ms(
                    lambda: parent(work, params, cols, ext), n=20,
                    per_round=20))
        plain_ms = _event_ms(lambda: scan.scan_reference(
            work.clone(), params, *cols, extract=False), n=1 if n > 1000 else 3)
        bound_ms, bound_by = bound(*scan_work(want_rows, cols, m, k, False))
        bound_ext_ms, _ = bound(*scan_work(want_rows, cols, m, k, True))
        shape = _level_widths(want_levels[False], geom.per_pass)
        shape_ext = _level_widths(want_levels[True], geom.per_pass)
        res = dict(shape=what, E=n, M=m, k=k, cluster=geom.cluster,
                   lanes_per_block=geom.lanes, tile=geom.tile,
                   smem_bytes=geom.smem_bytes, **shape,
                   **{f"{key}_extract": v for key, v in shape_ext.items()},
                   max_abs_err=err, plain_cuda_equals_plain_cpu=plain_cpu_same,
                   ms=ms, us_per_event=1e3 * ms / n,
                   us_per_level=1e3 * ms / max(shape["depth"], 1),
                   ms_extract=ms_extract, **serial, traced_ms=traced_ms,
                   sm_mhz=mhz, traced_us=splits[False],
                   traced_us_extract=splits[True], plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   bound_extract_ms=bound_ext_ms, library_ms=None, card=card)
        print("kernel santa_scan " + json.dumps(res), flush=True)
        results.append(res)
    return results


def waves_work(rows: torch.Tensor, cols, plan, m: int, k: int):
    """What one wave scan of a chunk must do, from its pre-edge rows
    [E, R, F] in stream order, its columns (src, dst, neg, ts, eidx, valid)
    and its plan. Bytes: each distinct row whose pre-chunk value the chunk
    reads (src, dst and the negatives of the scheduled events) read once,
    each distinct row written once, the extraction rows [E, R, F] written
    once, the columns (4 bytes for each of src, dst, eidx, ts and each
    negative, 1 for valid) and the plan (4 bytes per scheduled event and
    per wave bound). Operations: the merges of the scheduled events
    (:func:`merge_work`)."""
    src, dst, neg = cols[:3]
    n, r = rows.shape[:2]
    f = row_width(m, k)
    order = plan.order
    read = torch.unique(torch.cat([src[order], dst[order],
                                   neg[order].reshape(-1)])).numel()
    written = torch.unique(torch.cat([src[order], dst[order]])).numel()
    nbytes = ((read + written) * f * 4 + n * r * f * 4
              + n * (4 * (r + 2) + 1) + 4 * (len(order) + plan.n_waves + 1))
    _, ops = merge_work(rows[order], m, k)
    return nbytes, ops


def sm_clock_mhz(fn, n: int) -> float:
    """The SM clock (MHz) that nvidia-smi reads while ``n`` calls of
    ``fn``, enqueued first, keep the card busy."""
    for _ in range(n):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    torch.cuda.synchronize()
    return float(out.stdout.split()[0])


def trace_split(stamps: torch.Tensor, mhz: float, parts) -> dict:
    """µs per wave of each part of a wave from a traced launch's clock64
    stamps [n_waves, len(parts)] (thread 0 of block 0, at the end of each
    part): part 0 runs from the previous wave's last stamp, so the first
    wave is left out."""
    t = stamps.cpu().double()
    if t.shape[0] < 2:
        return {}
    flat = t.reshape(-1)
    steps = (flat[1:] - flat[:-1])[len(parts) - 1:].reshape(-1, len(parts))
    return {p: float(steps[:, i].mean()) / mhz for i, p in enumerate(parts)}


def same_wave_write_after_read(plan, src, dst, neg) -> int:
    """The lanes that write a row which an earlier lane of their wave reads
    as a negative (host columns): the case that needs santa_waves' first
    grid barrier."""
    order = plan.order.cpu().numpy()
    negs = neg.reshape(len(src), -1)
    pairs = 0
    for lo, hi in zip(plan.bounds[:-1], plan.bounds[1:]):
        read = set()
        for e in order[lo:hi]:
            pairs += int(src[e]) in read or int(dst[e]) in read
            read.update(int(v) for v in negs[e])
    return pairs


def waves_chunks(device: str = "cuda"):
    """The chunks santa_waves is held on: (what, params, start table,
    columns on the card, plan). The bench stream's first train superchunk
    (the flagship Trainer's stream, epoch 0's negatives, cap 64, from the
    empty index an epoch starts with) with 1, 5 and 2 negatives per event
    (R = 3, 7, 4; the extra columns are the negatives of the next epochs),
    and :func:`scan_stream`'s dense 301-node stream with its self-loops,
    invalid events and rows shared between near events, cut into waves of
    at most 64."""
    trainer = Trainer(*flagship_training(seed=0), device=device)
    cfg, ps = trainer.cfg, trainer._streams["train"]
    chunk = len(ps.host["src"]) // ps.n_chunks
    sl = slice(0, chunk)
    negs = np.stack([trainer._draw_train_negs(e)[sl] for e in range(
        max(s for _, s in WAVES_SEEDS))], 1)
    params = trainer._tppr
    host = {c: ps.host[c][sl] for c in ("src", "dst", "valid")}
    t, eidx = ps.stream.t[sl], ps.stream.eidx[sl]
    f = row_width(cfg.n_tppr, cfg.topk)
    shapes = [(what, n_neg, cfg.wave_cap) for what, n_neg in WAVES_SEEDS]
    shapes.append((f"train superchunk at wave_cap {WAVES_WIDE_CAP}", 1,
                   WAVES_WIDE_CAP))
    for what, n_neg, cap in shapes:
        neg = np.ascontiguousarray(negs[:, 0] if n_neg == 1
                                   else negs[:, :n_neg])
        plan = plan_waves(host["src"], host["dst"], neg, host["valid"],
                          cfg.n_nodes, cap, device)
        start = torch.zeros((cfg.n_nodes, f), device=device)
        cols = _columns(start, host["src"], host["dst"], neg, t, eidx,
                        host["valid"])
        yield what, params, start, cols, plan
    del trainer
    for m, k in WAVES_STRESS_SHAPES:
        params, start, cols = scan_stream(WAVES_STRESS_EVENTS, m, k, 7,
                                          device)
        h = [c.cpu().numpy() for c in cols]
        plan = plan_waves(h[0], h[1], h[2], h[5], start.shape[0], WAVE_CAP,
                          device)
        yield f"dense 301-node stress, M = {m}, k = {k}", params, start, \
            cols, plan


def waves_kernel_phase(card: str, scan_us_per_level: float):
    """santa_waves on each of :func:`waves_chunks`, bit for bit against the
    per-wave santa_merge loop and the plain loop on the card (the table and
    the extraction rows in stream order), untraced and traced, with its
    geometry, the redirected negatives (and the host ms of their list), its
    time beside the cooperative design's (:data:`WAVES_COOP_MS`), the
    loops' times, the bound, the wave chain's time at santa_scan's measured
    µs per level, and the traced launch's µs per wave of each part at the SM clock
    nvidia-smi reads."""
    results = []
    for what, params, start, cols, plan in waves_chunks():
        m, k = len(params.alpha), params.k
        n = cols[0].shape[0]
        r = 2 + (1 if cols[2].dim() == 1 else cols[2].shape[1])
        ext = torch.empty((n, r, start.shape[1]), device="cuda")
        loop = lambda d, mg=None: wave_scan_reference(d, params, *cols[:5],
                                                      plan, merge=mg)
        want = start.clone()
        want_rows = loop(want, merge.merge_both_reference)
        by_wave = start.clone()
        merge.SANTA_MERGE.launches = 0
        by_wave_rows = loop(by_wave)
        assert merge.SANTA_MERGE.launches == plan.n_waves, (
            merge.SANTA_MERGE.launches, plan.n_waves)
        trace = torch.zeros((plan.n_waves, len(TRACE_PARTS)),
                            dtype=torch.int64, device="cuda")
        tag = f"santa_waves {what}"
        err = max(_equal(by_wave, want, tag + " santa_merge loop data"),
                  _equal(by_wave_rows, want_rows,
                         tag + " santa_merge loop rows"))
        for tr in (None, trace):
            got = start.clone()
            ext.fill_(float("nan"))
            SANTA_WAVES.launches = 0
            SANTA_WAVES(got, params, *cols, plan, ext, trace=tr)
            assert SANTA_WAVES.launches == 1
            torch.cuda.synchronize()
            traced = " traced" if tr is not None else ""
            err = max(err, _equal(got, want, tag + traced + " data"),
                      _equal(ext, want_rows, tag + traced + " rows"))
        geom = SANTA_WAVES.geom
        h = [c.cpu().numpy() for c in cols[:3]]
        war = same_wave_write_after_read(plan, *h)
        order = plan.order.cpu().numpy()
        t0 = time.perf_counter()
        redirects(*h, order, plan.bounds, start.shape[0])
        redirect_host_ms = 1e3 * (time.perf_counter() - t0)
        work = start.clone()
        run = lambda tr=None: SANTA_WAVES(work, params, *cols, plan, ext,
                                          trace=tr)
        ms = device_ms(run, n=20, per_round=5, warmup=3)
        traced_ms = device_ms(lambda: run(trace), n=20, per_round=5,
                              warmup=3)
        mhz = sm_clock_mhz(lambda: run(trace), max(50, int(2000 / ms)))
        merge_loop_ms = _event_ms(lambda: loop(work))
        plain_ms = _event_ms(lambda: loop(work, merge.merge_both_reference),
                             n=1)
        bound_ms, bound_by = bound(*waves_work(want_rows, cols, plan, m, k))
        res = dict(shape=what, E=n, scheduled=len(plan.order), R=r, M=m,
                   k=k, waves=plan.n_waves, widest_wave=plan.width,
                   cluster=geom.cluster, lanes_per_block=geom.lanes,
                   smem_bytes=geom.smem_bytes,
                   redirected=int(plan.redirect.shape[0]),
                   redirect_host_ms=redirect_host_ms,
                   same_wave_write_after_read=war, launches=1,
                   santa_merge_loop_launches=plan.n_waves, max_abs_err=err,
                   ms=ms, cooperative_ms=WAVES_COOP_MS.get(what),
                   us_per_wave=1e3 * ms / max(plan.n_waves, 1),
                   traced_ms=traced_ms, sm_mhz=mhz,
                   stamped_mhz_by_events=float(trace[-1, -1] - trace[0, 0])
                   / traced_ms / 1e3,
                   traced_us_per_wave=trace_split(trace, mhz, TRACE_PARTS),
                   santa_merge_loop_ms=merge_loop_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   chain_ms_at_scan_level=plan.n_waves * scan_us_per_level
                   / 1e3, library_ms=None, card=card)
        print("kernel santa_waves " + json.dumps(res), flush=True)
        results.append(res)
    for res in results:
        if res["shape"].startswith("dense"):
            assert res["same_wave_write_after_read"] > 0, res
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
    _reset_counts()
    t0 = time.perf_counter()
    gpu_scores, timing = _drive(gpu, cols, timed=True)
    main_s = time.perf_counter() - t0
    launches = scan.SANTA_SCAN.launches
    merge_launches = merge.SANTA_MERGE.launches
    observed = WARM_EVENTS + FINAL_OBSERVE_B
    observe_calls = WARM_EVENTS // OBSERVE_BS + 1
    assert (launches == observe_calls and merge_launches
            == SANTA_WAVES.launches == 0), (
        launches, merge_launches, SANTA_WAVES.launches, observe_calls)
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
               observed_events=observed, observe_calls=observe_calls,
               santa_scan_launches=launches,
               santa_merge_launches=merge_launches,
               main_path_s=main_s, peak_device_gib=peak_gib,
               index_bitwise_cuda_vs_cpu=index_bitwise,
               memory_max_abs_err=mem_err, memory_diff_share=mem_share,
               score_max_abs_err=score_err, card=card)
    print("serve " + json.dumps(res), flush=True)
    return launches, gpu, cols


def wave_phase(gpu: LinkPredictor, cols, card: str):
    """The santa_merge path: ``edge_step`` on waves of consecutive,
    node-disjoint events (at most WAVE_CAP each; such a wave equals its
    events in sequence) after the served ones, from the served index,
    against ``fill_scan`` of the same events from the same index. Returns
    santa_merge's launches."""
    lo = WARM_EVENTS + FINAL_OBSERVE_B
    src, dst, ts, eidx = (c[lo: lo + WAVE_EVENTS] for c in cols)
    waves, seen = [[]], set()
    for i, (s, d) in enumerate(zip(src, dst)):
        if {s, d} & seen or len(waves[-1]) == WAVE_CAP:
            waves.append([])
            seen = set()
        waves[-1].append(i)
        seen |= {s, d}
    start = gpu.index_state.data
    by_wave = TpprState(start.clone())
    merge.SANTA_MERGE.launches = scan.SANTA_SCAN.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for w in waves:
        edge_step(by_wave, src[w], dst[w], src[w], ts[w], eidx[w],
                  np.ones(len(w), bool), gpu._tppr)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    launches = merge.SANTA_MERGE.launches
    assert launches == len(waves) and scan.SANTA_SCAN.launches == 0, (
        launches, len(waves))
    seq = fill_scan(TpprState(start.clone()), gpu._tppr, src, dst, ts, eidx,
                    np.ones(len(src), bool))
    _equal(by_wave.data, seq.data, "edge_step waves vs fill_scan")
    res = dict(events=len(src), waves=len(waves),
               mean_wave=len(src) / len(waves), santa_merge_launches=launches,
               waves_s=wave_s, index_bitwise_waves_vs_scan=True, card=card)
    print("waves " + json.dumps(res), flush=True)
    return launches


def fill_phase(cfg, cols, card: str, parent=None):
    """The whole bench stream through ``fill_scan`` in one launch, from an
    empty index: its seconds, the kernel's device ms (onto the filled
    index), depth (its levels equal to ``scan.scan_levels``) and bound, the
    traced split, the index bit-equal to the same stream in 200-event
    ``fill_scan`` calls, to an extracting launch and, with ``parent``, to
    the serial design's launch, with its ms; counts the live weights that
    are subnormal (0 < w < 2^-126), which the XLA reference flushes to zero
    and the port keeps."""
    src, dst, ts, eidx = cols
    n = len(src)
    params = TpprParams.create(cfg.alpha_list, cfg.beta_list, cfg.topk)
    fresh = lambda: init_tppr_state(cfg.n_tppr, cfg.n_nodes, cfg.topk,
                                    device="cuda")
    valid = np.ones(n, bool)
    dev_cols = [torch.as_tensor(c).cuda() for c in (src, dst, ts, eidx, valid)]
    state = fresh()
    launches = scan.SANTA_SCAN.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fill_scan(state, params, *dev_cols)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    assert scan.SANTA_SCAN.launches == launches + 1
    chunked = fresh()
    for lo in range(0, n, OBSERVE_BS):
        fill_scan(chunked, params, *(c[lo: lo + OBSERVE_BS] for c in dev_cols))
    _equal(chunked.data, state.data, "fill: one launch vs 200-event launches")
    del chunked
    kcols = _columns(state.data, src, dst, src, ts, eidx, valid)
    levels = torch.empty(n, dtype=torch.int32, device="cuda")
    trace = torch.zeros((n + 1, len(scan.TRACE_PARTS)), dtype=torch.int64,
                        device="cuda")
    again = fresh().data
    scan.SANTA_SCAN(again, params, *kcols, levels=levels, trace=trace)
    _equal(again, state.data, "fill: traced launch")
    want_levels = scan.scan_levels(src, dst, src, valid, extract=False)
    assert np.array_equal(levels.cpu().numpy(), want_levels), "fill levels"
    m, k = cfg.n_tppr, cfg.topk
    rows = torch.empty((n, 3, state.data.shape[1]), device="cuda")
    again = fresh().data
    scan.SANTA_SCAN(again, params, *kcols, ext=rows)
    _equal(again, state.data, "fill: extracting launch")
    bound_ms, bound_by = bound(*scan_work(rows, kcols, m, k, False))
    del rows
    work = again
    run = lambda tr=None: scan.SANTA_SCAN(work, params, *kcols, trace=tr)
    kernel_ms = _event_ms(run)
    mhz = sm_clock_mhz(lambda: run(trace), max(50, int(2000 / kernel_ms)))
    trace.zero_()
    run(trace)
    split = scan_trace_split(trace, mhz)
    serial = {}
    if parent is not None:
        old = fresh().data
        parent(old, params, kcols)
        _equal(old, state.data, "fill: serial launch")
        serial = dict(serial_ms=_event_ms(lambda: parent(old, params, kcols)))
    w = state.data[:, : 4 * m * k].reshape(-1, m, 4, k)[:, :, 0]
    assert bool(torch.isfinite(state.data).all())
    res = dict(events=n, nodes=cfg.n_nodes, fill_s=fill_s,
               us_per_event=1e6 * fill_s / n, kernel_ms=kernel_ms, **serial,
               bound_ms=bound_ms, bound_by=bound_by,
               depth=int(want_levels.max()) + 1, tiles=split["tiles"],
               geometry=scan.geometry(n, m, k)._asdict(), sm_mhz=mhz,
               traced_us=split, index_bitwise_vs_200_event_launches=True,
               live_entries=int((w > 0).sum()),
               subnormal_live_entries=int(((w > 0) & (w < FLT_MIN)).sum()),
               min_live_weight=float(w[w > 0].min()), card=card)
    print("fill " + json.dumps(res), flush=True)


def _reset_counts() -> None:
    merge.SANTA_MERGE.launches = scan.SANTA_SCAN.launches = 0
    SANTA_WAVES.launches = 0


def _counts(trainer: Trainer) -> dict:
    """This process's santa launches since :func:`_reset_counts` and
    ``trainer``'s wave counters, for :func:`_hold_counts`."""
    return dict(santa_merge_launches=merge.SANTA_MERGE.launches,
                santa_scan_launches=scan.SANTA_SCAN.launches,
                santa_waves_launches=SANTA_WAVES.launches,
                index_waves=trainer.index_waves,
                index_sharded_waves=trainer.index_sharded_waves,
                index_scans=trainer.index_scans)


def _hold_counts(c: dict, cuda: bool, tag) -> None:
    """:func:`_counts` of a Trainer made after the last
    :func:`_reset_counts`: on the card one santa_waves launch per
    superchunk scanned in one piece and one santa_merge launch per
    row-sharded wave, off it none; no santa_scan launch."""
    want = (c["index_scans"], c["index_sharded_waves"]) if cuda else (0, 0)
    assert ((c["santa_waves_launches"], c["santa_merge_launches"]) == want
            and c["santa_scan_launches"] == 0), (tag, c)


def _wave_launches(trainer: Trainer, scans: int, tag) -> int:
    """santa_waves' launches since :func:`_reset_counts` of a one-process
    ``trainer`` whose ``index_scans`` was ``scans`` then, held by
    :func:`_hold_counts`."""
    c = dict(_counts(trainer), index_scans=trainer.index_scans - scans,
             index_sharded_waves=0)
    _hold_counts(c, trainer.device.type == "cuda", tag)
    return c["santa_waves_launches"]


def _metrics(r) -> str:
    return f"loss {r.loss:.6f} ap {r.ap:.6f} auc {r.auc:.6f} acc {r.acc:.6f}"


def train_phase(card: str):
    """The training main path at full width on the bench stream, then the
    CUDA-vs-CPU replay."""
    cfg, splits, edge_feats = flagship_training(seed=0)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, splits, edge_feats, device="cuda")
    setup_s = time.perf_counter() - t0
    n_train = splits.train.n_interactions
    torch.cuda.reset_peak_memory_stats()
    epochs = []
    for e in (1, 2):
        _reset_counts()
        scans = trainer.index_scans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = trainer.train_epoch()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = _wave_launches(trainer, scans, e)
        assert np.isfinite(r.per_batch[:, 0]).all(), e
        print(f"train epoch {e}{' (warm-up)' if e == 1 else ''}: {s:.3f} s, "
              f"{n_train / s:.1f} train events/s, index {r.index_seconds:.3f} "
              f"s of host time, {r.waves} waves, {launches} santa_waves "
              f"launches, {_metrics(r)}  ({card})", flush=True)
        epochs.append(dict(seconds=s, events_per_s=n_train / s,
                           index_host_s=r.index_seconds, waves=r.waves,
                           santa_waves_launches=launches, loss=r.loss,
                           ap=r.ap, auc=r.auc, acc=r.acc))
    # the train-end index depends on the stream alone (seeds phase)
    train_end_index = trainer.index_state.data.clone()
    _reset_counts()
    scans = trainer.index_scans
    t0 = time.perf_counter()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = _wave_launches(trainer, scans, "eval")
    phases = dict(val=val, nn_val=nn_val, test=test, nn_test=nn_test)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, r in phases.items():
        print(f"{name:8s} {r.seconds:.3f} s, {r.waves} waves, {_metrics(r)}"
              f"  ({card})", flush=True)
    print(f"train peak device memory {peak_gib:.3f} GiB  ({card})", flush=True)
    assert epochs[1]["ap"] > 0.5 and val.ap > 0.5 and test.ap > 0.5, (
        epochs[1]["ap"], val.ap, test.ap)
    res = dict(train_events=n_train, n_nodes=trainer.cfg.n_nodes,
               setup_s=setup_s, epochs=epochs, eval_s=eval_s,
               eval_santa_waves_launches=eval_launches,
               phases={k: dict(seconds=r.seconds, waves=r.waves, ap=r.ap,
                               auc=r.auc, acc=r.acc)
                       for k, r in phases.items()},
               peak_device_gib=peak_gib, card=card)
    print("train " + json.dumps(res), flush=True)
    replay_phase(card)
    return train_end_index, epochs[1]["seconds"]


def _bitwise(a: Trainer, b: Trainer) -> bool:
    """Whether two Trainers hold bit-equal params and memory tables."""
    return all(torch.equal(x, y.to(x.device)) for x, y in zip(
        list(a.params.parameters()) + list(a.mem),
        list(b.params.parameters()) + list(b.mem)))


def replay_phase(card: str, build=flagship_training, tag: str = "replay",
                 n_events: int = TRAIN_REPLAY_EVENTS, twice: bool = False):
    """The first ``n_events`` events of ``build``'s configuration and
    stream at full width, dropout 0, through one ``train_epoch`` and
    ``validate()`` on the card and on the CPU; both Trainers draw the same
    params (a CPU generator). The index (streaming), ``msg_count`` and
    ``msg_ts`` are held bit-equal, the message table at MESSAGE_REL. With
    ``twice`` a second card Trainer runs the same and is compared with the
    first (printed, not held: under mean the card's accumulation order is
    the sort-based ``index_put_``'s)."""
    cfg, splits, edge_feats = build(seed=0, n_events=n_events, dropout=0.0)
    gpu = Trainer(cfg, splits, edge_feats, device="cuda")
    cpu = Trainer(cfg, splits, edge_feats, device="cpu")
    gpu2 = Trainer(cfg, splits, edge_feats, device="cuda") if twice else None
    for a, b in zip(gpu.params.parameters(), cpu.params.parameters()):
        assert torch.equal(a.cpu(), b)
    out = {}
    for leg, run in (("train", lambda t: t.train_epoch()),
                     ("val", lambda t: t.validate()[0])):
        rg, rc = run(gpu), run(cpu)
        index_bitwise = None
        if gpu.index_state is not None:
            got, want = gpu.index_state.data.cpu(), cpu.index_state.data
            index_bitwise = bool(torch.equal(got, want))
            assert index_bitwise, (leg, int((got != want).any(1).sum()))
        diff = (gpu.mem.memory.cpu().float() - cpu.mem.memory.float()).abs()
        mem_err, mem_share = float(diff.max()), float((diff > 0).float().mean())
        loss_err = float(np.abs(rg.per_batch[:, 0] - rc.per_batch[:, 0]).max())
        got, want = gpu.mem.messages.cpu().float(), cpu.mem.messages.float()
        msg_diff = (got - want).abs()
        msg_excess = float((msg_diff - MESSAGE_REL * want.abs()).max())
        for f in ("msg_count", "msg_ts", "last_update"):
            assert torch.equal(getattr(gpu.mem, f).cpu(),
                               getattr(cpu.mem, f)), (leg, f)
        out[leg] = dict(batches=int(rg.per_batch.shape[0]), waves=rg.waves,
                        index_bitwise_cuda_vs_cpu=index_bitwise,
                        memory_max_abs_err=mem_err,
                        memory_diff_share=mem_share,
                        messages_max_abs_err=float(msg_diff.max()),
                        messages_diff_share=float((msg_diff > 0).float()
                                                  .mean()),
                        msg_count_ts_bitwise=True,
                        batch_loss_max_abs_err=loss_err,
                        ap_cuda=rg.ap, ap_cpu=rc.ap)
        if gpu2 is not None:
            r2 = run(gpu2)
            out[leg]["cuda_twice_bitwise"] = bool(
                np.array_equal(rg.per_batch, r2.per_batch)
                and _bitwise(gpu, gpu2))
        print(f"{tag} {leg}: " + json.dumps(out[leg]), flush=True)
        assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, (
            leg, mem_err, mem_share)
        assert msg_excess <= MEMORY_ATOL, (leg, msg_excess)
        assert loss_err <= TRAIN_LOSS_ATOL, (leg, loss_err)
    print(f"{tag} " + json.dumps(dict(events=n_events, card=card, **out)),
          flush=True)


def write_bench_dataset(root: Path, n_events: int) -> None:
    """The first ``n_events`` of the bench stream as ``root/bench/ml_bench
    .csv`` (the layout ``preprocess.run`` writes) and ``ml_bench.npy`` (its
    edge features, zero row 0). The labels are those of
    ``synthetic_stream(..., label_users_frac=0.1)``, which draws the same
    events: its labels are drawn after them (its edge features after the
    labels, so they differ and are not taken)."""
    data, edge_feats = bench_stream(seed=0)
    labeled, _ = synthetic_stream(120_000, 20_000, 20_000, seed=0,
                                  label_users_frac=0.1)
    for f in ("sources", "destinations", "timestamps", "edge_idxs"):
        assert np.array_equal(getattr(data, f), getattr(labeled, f)), f
    n = n_events
    write_ml(root / "bench", "bench",
             {"u": data.sources[:n], "i": data.destinations[:n],
              "ts": data.timestamps[:n], "label": labeled.labels[:n],
              "idx": data.edge_idxs[:n]},
             edge_feats[: n + 1])


def _on(trainer: Trainer, device: str) -> bool:
    """Whether every parameter, Adam state tensor and table of ``trainer``
    lies on ``device`` (Adam's step counters stay on the host by design)."""
    tensors = list(trainer.params.parameters()) + list(trainer.mem) + [
        trainer.index_state.data, trainer.edge_feats]
    tensors += [v for st in trainer.optimizer.state.values()
                for k, v in st.items() if k != "step"]
    return all(t.device.type == device for t in tensors)


def cli_fit(root: Path, device: str, card: str):
    """The CLI on the bench dataset; returns its trainer and results."""
    argv = (["-d", "bench", "--data_dir", str(root), *FIT_FLAGS,
             "--checkpoint_dir", str(root / "ckpt"),
             "--log_dir", str(root / "log"), "--device", device])
    _reset_counts()
    t0 = time.perf_counter()
    (trainer, results), = cli.main(argv)
    if device == "cuda":
        torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = _wave_launches(trainer, 0, "fit cli")
    assert _on(trainer, device), "a parameter or table left the card"
    cfg = trainer.cfg
    log = root / "log" / "bench" / cfg.run_name()
    state = root / "ckpt" / (cfg.run_name() + ".state.ckpt")
    assert log.is_file() and state.is_file() and Path(
        trainer.checkpoint_path).is_file(), (log, state)
    assert len(trainer.epoch_log) == 3 and results["stop_epoch"] == -1.0
    for r in trainer.epoch_log:
        assert r["state_s"] is not None
        print(f"fit epoch {r['epoch']}: train {r['train_s']:.3f} s, "
              f"{r['train_events_per_s']:.1f} train events/s, index "
              f"{r['index_s']:.3f} s of host time, {r['waves']} waves, val "
              f"{r['val_s']:.3f} s, train ap {r['train_ap']:.6f}, val ap "
              f"{r['val_ap']:.6f}, new node val ap {r['nn_val_ap']:.6f}, "
              f"state file written in {r['state_s']:.3f} s  ({card})",
              flush=True)
    print("fit test: " + ", ".join(f"{k} {v:.6f}" for k, v in results.items())
          + f"  ({card})", flush=True)
    for k in ("test_ap", "test_auc", "nn_test_ap", "node_train_auc",
              "node_val_auc", "node_test_auc"):
        assert np.isfinite(results[k]), (k, results)
    assert results["test_ap"] > 0.5, results
    res = dict(cli_s=cli_s, santa_waves_launches=launches,
               index_scans=trainer.index_scans,
               index_waves=trainer.index_waves,
               santa_scan_launches=scan.SANTA_SCAN.launches,
               state_file_bytes=state.stat().st_size,
               best_checkpoint_bytes=Path(
                   trainer.checkpoint_path).stat().st_size,
               log_file=log.name, epochs=trainer.epoch_log, results=results,
               card=card)
    print("fit cli " + json.dumps(res), flush=True)
    return trainer, str(state), launches


def preempt_fit(root: Path, device: str, card: str, n_events: int,
                chunk: int):
    """Uninterrupted ``fit`` (A) against one stopped after its first
    superchunk (B) and resumed from B's state file (C)."""
    cfg, splits, edge_feats = flagship_training(seed=0, n_events=n_events,
                                                index_chunk=chunk)
    make = lambda d: Trainer(cfg.replace(checkpoint_dir=str(root / d)),
                             splits, edge_feats, device=device)
    a = make("a")
    n_chunks = a._streams["train"].n_chunks
    ra = a.fit(n_epoch=PREEMPT_EPOCHS)
    b = make("b")
    b.request_stop()
    rb = b.fit(n_epoch=PREEMPT_EPOCHS)
    assert rb["interrupted"], rb
    saved = load_checkpoint(rb["state_path"])
    assert (saved["epoch"], saved["chunk"]) == (0, 1), (
        saved["epoch"], saved["chunk"])
    c = make("b")
    t0 = time.perf_counter()
    rc = c.fit(n_epoch=PREEMPT_EPOCHS, resume_from=rb["state_path"])
    resumed_s = time.perf_counter() - t0
    index_bitwise = bool(torch.equal(a.index_state.data, c.index_state.data))
    assert index_bitwise, "resumed index differs"
    pairs = [(x.detach(), y.detach()) for x, y in zip(
        a.params.parameters(), c.params.parameters())]
    params_bitwise = all(torch.equal(x, y) for x, y in pairs)
    param_err = max(float((x - y).abs().max()) for x, y in pairs)
    diff = (a.mem.memory.float() - c.mem.memory.float()).abs()
    mem_bitwise = all(torch.equal(x, y) for x, y in zip(a.mem, c.mem))
    mem_err, mem_share = float(diff.max()), float((diff > 0).float().mean())
    metric_err = max(abs(ra[k] - rc[k]) for k in ra)
    assert param_err <= RESUME_PARAM_ATOL, param_err
    assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, (
        mem_err, mem_share)
    assert metric_err <= RESUME_METRIC_ATOL, (ra, rc)
    res = dict(events=n_events, train_superchunks=n_chunks,
               saved_epoch=saved["epoch"], saved_chunk=saved["chunk"],
               index_bitwise=index_bitwise, params_bitwise=params_bitwise,
               params_max_abs_err=param_err, memory_bitwise=mem_bitwise,
               memory_max_abs_err=mem_err, memory_diff_share=mem_share,
               test_metrics_max_abs_err=metric_err, resumed_fit_s=resumed_s,
               uninterrupted=ra, resumed=rc, card=card)
    print("fit preempt " + json.dumps(res), flush=True)


def deploy(trainer: Trainer, state: str, edge_feats, device: str, card: str):
    """``from_checkpoint`` of the CLI's last state file against
    ``from_trainer`` of its Trainer restored from that file: scores at
    b = DEPLOY_SCORE_B, then DEPLOY_CALLS observe calls each."""
    t0 = time.perf_counter()
    served = LinkPredictor.from_checkpoint(state, edge_feats=edge_feats,
                                           device=device)
    load_s = time.perf_counter() - t0
    trainer.restore_state(state)
    ref = LinkPredictor.from_trainer(trainer)
    te = trainer.splits.test
    sl = slice(0, DEPLOY_SCORE_B)
    q = (te.sources[sl], te.destinations[sl], te.timestamps[sl])
    got, want = served.score(*q), ref.score(*q)
    assert got.shape == (len(q[0]),) and np.isfinite(got).all()
    assert np.array_equal(got, want), float(np.abs(got - want).max())
    _reset_counts()
    for c in range(DEPLOY_CALLS):
        sl = slice(c * DEPLOY_OBSERVE_B, (c + 1) * DEPLOY_OBSERVE_B)
        served.observe(te.sources[sl], te.destinations[sl],
                       te.timestamps[sl], te.edge_idxs[sl])
    launches = scan.SANTA_SCAN.launches
    assert (launches == DEPLOY_CALLS
            and merge.SANTA_MERGE.launches == SANTA_WAVES.launches == 0), (
        launches, merge.SANTA_MERGE.launches, SANTA_WAVES.launches)
    for c in range(DEPLOY_CALLS):
        sl = slice(c * DEPLOY_OBSERVE_B, (c + 1) * DEPLOY_OBSERVE_B)
        ref.observe(te.sources[sl], te.destinations[sl], te.timestamps[sl],
                    te.edge_idxs[sl])
    assert torch.equal(served.index_state.data, ref.index_state.data)
    assert all(torch.equal(x, y) for x, y in zip(served.mem, ref.mem))
    after = served.score(*q)
    assert np.array_equal(after, ref.score(*q)) and not np.array_equal(
        after, got)
    res = dict(state_file=Path(state).name, from_checkpoint_s=load_s,
               score_b=DEPLOY_SCORE_B, scores_bitwise=True,
               observe_calls=DEPLOY_CALLS, observe_b=DEPLOY_OBSERVE_B,
               santa_scan_launches=launches, state_bitwise_after_observe=True,
               card=card)
    print("fit deploy " + json.dumps(res), flush=True)


def fit_phase(card: str, device: str = "cuda", n_events: int = 120_000,
              preempt_chunk: int = PREEMPT_CHUNK) -> int:
    """The whole training run (see the module docstring, phase 8). Returns
    santa_waves' launches in the CLI's run."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_bench_dataset(root, n_events)
        print(f"fit: bench dataset written in {time.perf_counter() - t0:.3f}"
              f" s ({os.path.getsize(root / 'bench' / 'ml_bench.csv')} B of "
              "CSV)", flush=True)
        trainer, state, launches = cli_fit(root, device, card)
        _, edge_feats = load_feat("bench", str(root))
        deploy(trainer, state, edge_feats, device, card)
        del trainer
        preempt_fit(root, device, card, n_events, preempt_chunk)
    return launches


def _per_seed(r) -> str:
    return " ".join(f"{f} [{', '.join(f'{v:.6f}' for v in getattr(r, f))}]"
                    for f in ("loss", "ap", "auc", "acc"))


def seeds_train(card: str, single_index: torch.Tensor):
    """``Trainer(parallel_runs=SEEDS)`` at full width on the bench stream;
    returns the Trainer after ``test()`` and santa_waves' launches."""
    cfg, splits, edge_feats = flagship_training(seed=0, parallel_runs=SEEDS)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, splits, edge_feats, device="cuda")
    setup_s = time.perf_counter() - t0
    n_train = splits.train.n_interactions
    torch.cuda.reset_peak_memory_stats()
    epochs, launches_all = [], 0
    for e in (1, 2):
        _reset_counts()
        scans = trainer.index_scans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = trainer.train_epoch()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = _wave_launches(trainer, scans, ("seeds", e))
        launches_all += launches
        assert np.isfinite(r.per_batch).all(), e
        rate = SEEDS * n_train / s
        print(f"seeds train epoch {e}{' (warm-up)' if e == 1 else ''}: "
              f"{s:.3f} s, {rate:.1f} train events/s over {SEEDS} seeds "
              f"({n_train / s:.1f} per seed), index {r.index_seconds:.3f} s "
              f"of host time, {r.waves} waves, {launches} santa_waves "
              f"launches; {_per_seed(r)}  ({card})", flush=True)
        epochs.append(dict(seconds=s, events_per_s=rate,
                           index_host_s=r.index_seconds, waves=r.waves,
                           santa_waves_launches=launches,
                           loss=r.loss.tolist(), ap=r.ap.tolist()))
    index_bitwise = bool(torch.equal(trainer.index_state.data, single_index))
    assert index_bitwise, int((trainer.index_state.data != single_index)
                              .any(1).sum())
    _reset_counts()
    scans = trainer.index_scans
    t0 = time.perf_counter()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    phases = dict(val=val, nn_val=nn_val, test=test, nn_test=nn_test)
    eval_launches = _wave_launches(trainer, scans, "seeds eval")
    launches_all += eval_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for name, r in phases.items():
        print(f"seeds {name:8s} {r.seconds:.3f} s, {r.waves} waves, "
              f"{_per_seed(r)}  ({card})", flush=True)
    print(f"seeds peak device memory {peak_gib:.3f} GiB  ({card})",
          flush=True)
    assert (min(epochs[1]["ap"]) > 0.5 and val.ap.min() > 0.5
            and test.ap.min() > 0.5), (
        epochs[1]["ap"], val.ap, test.ap)
    res = dict(seeds=SEEDS, train_events_per_seed=n_train, setup_s=setup_s,
               epochs=epochs, eval_s=eval_s,
               eval_santa_waves_launches=eval_launches,
               index_bitwise_vs_single_seed=index_bitwise,
               phases={k: dict(seconds=r.seconds, waves=r.waves,
                               ap=r.ap.tolist(), auc=r.auc.tolist())
                       for k, r in phases.items()},
               peak_device_gib=peak_gib, card=card)
    print("seeds train " + json.dumps(res), flush=True)
    return trainer, launches_all


def seeds_replay(card: str, build=flagship_training, n_seeds: int = SEEDS,
                 lanes=SEED_REPLAY_LANES, tag: str = "seeds replay"):
    """Lanes ``lanes`` of an ``n_seeds``-seed Trainer on the first
    TRAIN_REPLAY_EVENTS events of ``build``'s configuration and stream
    against single-seed Trainers with those seeds, dropout 0.1: one epoch
    and ``validate()``."""
    cfg, splits, edge_feats = build(seed=0, n_events=TRAIN_REPLAY_EVENTS)
    par = Trainer(cfg.replace(parallel_runs=n_seeds), splits, edge_feats,
                  device="cuda")
    singles = {s: Trainer(cfg.replace(seed=s), splits, edge_feats,
                          device="cuda") for s in lanes}
    rp, vp = par.train_epoch(), par.validate()[0]
    n = par.cfg.n_nodes
    out = {}
    for s, single in singles.items():
        r1, v1 = single.train_epoch(), single.validate()[0]
        loss_err = float(np.abs(rp.per_batch[:, s, 0]
                                - r1.per_batch[:, 0]).max())
        param_err = max(
            float((v[s] - single.params.state_dict()[k]).abs().max())
            for k, v in par.params.state_dict().items())
        diff = (par.mem.memory[s * n: (s + 1) * n].float()
                - single.mem.memory.float()).abs()
        mem_err, mem_share = float(diff.max()), float((diff > 0).float()
                                                       .mean())
        metric_err = max(abs(float(getattr(vp, f)[s]) - getattr(v1, f))
                         for f in ("ap", "auc", "acc"))
        out[s] = dict(batch_loss_max_abs_err=loss_err,
                      params_max_abs_err=param_err,
                      memory_max_abs_err=mem_err, memory_diff_share=mem_share,
                      val_metric_max_abs_err=metric_err,
                      bitwise=loss_err == 0 and param_err == 0
                      and mem_err == 0 and metric_err == 0)
        print(f"{tag} lane {s}: " + json.dumps(out[s]), flush=True)
        assert loss_err <= LANE_LOSS_ATOL, (s, loss_err)
        steps = rp.per_batch.shape[0]
        assert param_err <= 2 * cfg.lr * steps, (s, param_err, steps)
        assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, (
            s, mem_err, mem_share)
        assert metric_err <= LANE_METRIC_ATOL, (s, metric_err)
    print(f"{tag} " + json.dumps(dict(events=TRAIN_REPLAY_EVENTS, card=card,
                                      lanes=out)), flush=True)


def seeds_ensemble(trainer: Trainer, card: str):
    """``EnsemblePredictor`` over the seed-parallel Trainer; returns
    santa_scan's launches in its observe calls."""
    ens = EnsemblePredictor.from_trainer(trainer)
    te = trainer.splits.test
    sl = slice(0, ENSEMBLE_SCORE_B)
    q = (te.sources[sl], te.destinations[sl], te.timestamps[sl])
    score, members = ens.score(*q), ens.member_scores(*q)
    assert score.shape == (ENSEMBLE_SCORE_B,) and members.shape == (
        SEEDS, ENSEMBLE_SCORE_B) and np.isfinite(members).all()
    mean_err = float(np.abs(score - members.mean(0)).max())
    assert mean_err <= ENSEMBLE_MEAN_ATOL, mean_err
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seeds.state.ckpt")
        trainer.save_state(path)
        ef = trainer.edge_feats.cpu().numpy()
        t0 = time.perf_counter()
        served = LinkPredictor.from_checkpoint(path, edge_feats=ef,
                                               ensemble=True)
        load_s = time.perf_counter() - t0
        assert isinstance(served, EnsemblePredictor) and served.n_models == SEEDS
        member_err = 0.0
        for s in range(SEEDS):
            one = LinkPredictor.from_checkpoint(path, edge_feats=ef,
                                                run_index=s)
            member_err = max(member_err, float(np.abs(
                one.score(*q) - members[s]).max()))
        assert member_err <= ENSEMBLE_MEMBER_ATOL, member_err
    assert np.array_equal(served.score(*q), score)
    assert np.array_equal(served.member_scores(*q), members)
    _reset_counts()
    for c in range(ENSEMBLE_CALLS):
        sl = slice(c * ENSEMBLE_OBSERVE_B, (c + 1) * ENSEMBLE_OBSERVE_B)
        served.observe(te.sources[sl], te.destinations[sl],
                       te.timestamps[sl], te.edge_idxs[sl])
    launches = scan.SANTA_SCAN.launches
    assert (launches == ENSEMBLE_CALLS
            and merge.SANTA_MERGE.launches == SANTA_WAVES.launches == 0), (
        launches, merge.SANTA_MERGE.launches, SANTA_WAVES.launches)
    for c in range(ENSEMBLE_CALLS):
        sl = slice(c * ENSEMBLE_OBSERVE_B, (c + 1) * ENSEMBLE_OBSERVE_B)
        ens.observe(te.sources[sl], te.destinations[sl], te.timestamps[sl],
                    te.edge_idxs[sl])
    assert torch.equal(served.index_state.data, ens.index_state.data)
    assert all(torch.equal(x, y) for x, y in zip(served.mem, ens.mem))
    after = served.score(*q)
    assert np.array_equal(after, ens.score(*q)) and not np.array_equal(
        after, score)
    res = dict(members=SEEDS, score_b=ENSEMBLE_SCORE_B,
               score_vs_member_mean_max_abs_err=mean_err,
               member_vs_run_index_max_abs_err=member_err,
               from_checkpoint_s=load_s, checkpoint_bitwise=True,
               observe_calls=ENSEMBLE_CALLS, observe_b=ENSEMBLE_OBSERVE_B,
               santa_scan_launches=launches, card=card)
    print("seeds ensemble " + json.dumps(res), flush=True)
    return launches


def seeds_phase(card: str, single_index: torch.Tensor):
    """The seed axis (module docstring, phase 9). Returns the santa_waves
    launches of its main path, santa_scan's and the merge's result at the
    seed-parallel shape."""
    merged = seed_merge_phase(card)
    trainer, wave_launches = seeds_train(card, single_index)
    scan_launches = seeds_ensemble(trainer, card)
    del trainer
    seeds_replay(card)
    return wave_launches, scan_launches, merged


def entry_err(got, want, rel: float) -> float:
    """The largest relative weight difference between two queries' live
    entries (TpprQueries, fields [M, Q, k]). Raises unless both hold the
    same (eidx, nbr) entries, but for entries within 1e-4 of the k-th
    weight, with equal dt, and the weights agree within ``rel``."""
    g, w = ([x.cpu().numpy() for x in q] for q in (got, want))
    worst = 0.0
    for m in range(w[3].shape[0]):
        for i in range(w[3].shape[1]):
            sets = []
            for nbr, eidx, dt, wt in (g, w):
                live = wt[m, i] > 0
                sets.append({(int(e), int(n)): (float(x), float(d))
                             for e, n, d, x in zip(eidx[m, i][live],
                                                   nbr[m, i][live],
                                                   dt[m, i][live],
                                                   wt[m, i][live])})
            a, b = sets
            cut = min((x for x, _ in b.values()), default=0.0)
            for key in a.keys() ^ b.keys():
                x = (b.get(key) or a.get(key))[0]
                assert abs(x - cut) <= 1e-4 * cut, (m, i, key, x, cut)
            for key in a.keys() & b.keys():
                assert a[key][1] == b[key][1], (m, i, key)
                worst = max(worst, abs(a[key][0] - b[key][0]) / b[key][0])
    assert worst <= rel, worst
    return worst


def prune_bfs(trainer: Trainer, card: str):
    """``pruned_topk`` on the roots of train batch BFS_BATCH (src, dst and
    the negatives: 600 at bs 200) on the card, twice, with the sorted dedup
    forced, and on the CPU from the same index."""
    cfg = trainer.cfg
    blocks, t = bfs_roots(trainer, BFS_BATCH)
    ab = ensemble_tensors(cfg, trainer.device)
    call = lambda: pruned_queries(cfg, trainer.train_nbr_index, ab, blocks, t)
    first, second = call(), call()
    for a, b in zip(first, second):
        _equal(a, b, "pruned_topk twice on the card")
    tr = trainer.splits.train
    cpu_index = build_neighbor_index(tr.sources, tr.destinations,
                                     tr.timestamps, tr.edge_idxs,
                                     cfg.n_nodes, "cpu")
    for f in ("arena", "offsets", "keys", "times"):
        assert torch.equal(getattr(cpu_index, f),
                           getattr(trainer.train_nbr_index, f).cpu()), f
    on_cpu = pruned_queries(cfg, cpu_index, ensemble_tensors(cfg, "cpu"),
                            [x.cpu() for x in blocks], t.cpu())
    cpu_err = entry_err(first, on_cpu, BFS_REL)
    keep = pruning._MATCH_MATRIX_MAX_C
    pruning._MATCH_MATRIX_MAX_C = 0
    try:
        by_sort = call()
        sort_ms = device_ms(call, n=20, per_round=5)
    finally:
        pruning._MATCH_MATRIX_MAX_C = keep
    dedup_err = entry_err(by_sort, first, DEDUP_REL)
    ms = device_ms(call, n=20, per_round=5)
    host = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        host.append(time.perf_counter() - t0)
    res = dict(roots=int(t.shape[0]) * len(blocks), width=cfg.n_degree,
               depth=cfg.n_layer, k=cfg.topk, members=cfg.n_tppr,
               live_share=float((first.w > 0).float().mean()),
               bitwise_twice=True, cpu_max_rel_err=cpu_err,
               sorted_dedup_max_rel_err=dedup_err, ms=ms,
               sorted_dedup_ms=sort_ms,
               host_enqueue_ms=1e3 * float(np.median(host)), card=card)
    print(f"pruning bfs: {ms:.4f} ms per call on the device, "
          f"{res['host_enqueue_ms']:.3f} ms of host time  ({card})",
          flush=True)
    print("pruning bfs " + json.dumps(res), flush=True)


def prune_train(trainer: Trainer, card: str):
    """A warm-up and a timed epoch, ``validate()`` and ``test()``."""
    n_train = trainer.splits.train.n_interactions
    epochs = []
    for e in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = trainer.train_epoch()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        batches = int(r.per_batch.shape[0])
        assert np.isfinite(r.per_batch).all() and r.waves == 0, e
        bfs_ms = 1e3 * r.index_seconds / batches
        print(f"pruning train epoch {e}{' (warm-up)' if e == 1 else ''}: "
              f"{s:.3f} s, {n_train / s:.1f} train events/s, BFS "
              f"{bfs_ms:.3f} ms of host time per batch ({batches} batches), "
              f"{_metrics(r)}  ({card})", flush=True)
        epochs.append(dict(seconds=s, events_per_s=n_train / s,
                           bfs_host_ms_per_batch=bfs_ms, batches=batches,
                           loss=r.loss, ap=r.ap, auc=r.auc, acc=r.acc))
    t0 = time.perf_counter()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    phases = dict(val=val, nn_val=nn_val, test=test, nn_test=nn_test)
    for name, r in phases.items():
        print(f"pruning {name:8s} {r.seconds:.3f} s, {_metrics(r)}  ({card})",
              flush=True)
        assert r.waves == 0 and np.isfinite(r.per_batch).all(), name
    assert trainer.index_state is None and trainer.index_waves == 0
    assert epochs[1]["ap"] > 0.5 and val.ap > 0.5 and test.ap > 0.5, (
        epochs[1]["ap"], val.ap, test.ap)
    res = dict(train_events=n_train, n_nodes=trainer.cfg.n_nodes,
               arena_slots=int(trainer.full_nbr_index.ts.shape[0]),
               max_degree=trainer.full_nbr_index.max_degree, epochs=epochs,
               eval_s=eval_s,
               phases={k: dict(seconds=r.seconds, ap=r.ap, auc=r.auc,
                               acc=r.acc) for k, r in phases.items()},
               peak_device_gib=torch.cuda.max_memory_allocated() / 2**30,
               card=card)
    print("pruning train " + json.dumps(res), flush=True)


def _prune_requests(pred: LinkPredictor, cols, timed: bool):
    """The serve leg's calls on ``pred`` (the test split's columns ``cols``):
    observe calls, scores at each batch size, a brand-new edge and its
    fold. Returns the scores, whether the new edge was seen before and
    after its fold, and the timings."""
    sync = torch.cuda.synchronize if timed else (lambda: None)
    src, dst, ts, eidx = cols
    obs_s = []
    for c in range(PRUNE_OBSERVE_CALLS):
        sl = slice(c * PRUNE_OBSERVE_B, (c + 1) * PRUNE_OBSERVE_B)
        t0 = time.perf_counter()
        pred.observe(src[sl], dst[sl], ts[sl], eidx[sl])
        sync()
        obs_s.append(time.perf_counter() - t0)
    lo = PRUNE_OBSERVE_CALLS * PRUNE_OBSERVE_B
    scores, score_s = {}, {}
    for b in SCORE_BS:
        sl = slice(lo, lo + b)
        scores[b] = pred.score(src[sl], dst[sl], ts[sl])
        if timed:
            lat = []
            for _ in range(10):
                t0 = time.perf_counter()
                pred.score(src[sl], dst[sl], ts[sl])
                lat.append(time.perf_counter() - t0)
            score_s[b] = float(np.median(lat))
    t_new, e_new = float(ts[-1]) + 100.0, int(eidx.max()) + 1
    seen = lambda: _sees_edge(pred, src[0], t_new + 1.0, e_new)
    before = seen()
    pred.observe([src[0]], [dst[1]], [t_new], [e_new])
    after = seen()
    scores["new"] = pred.score([src[0]], [dst[1]], [t_new + 1.0])
    return scores, (before, after), dict(
        observe_ms=[1e3 * x for x in obs_s],
        score_ms={b: 1e3 * x for b, x in score_s.items()})


def _sees_edge(pred: LinkPredictor, node, t: float, e: int) -> bool:
    """Whether a query of ``node`` at ``t`` reads edge ``e``: among its
    T-PPR entries (the diffusion tower), or as its newest neighbor (the
    recursive towers)."""
    node, t = (torch.tensor([x], device=pred.device) for x in (node, t))
    if pred.cfg.uses_tppr:
        q = pred._queries(node, node, t, with_neg=False)
        return bool((q.eidx[:, 0] == e).any())
    return bool(most_recent_neighbors(pred.nbr_index, node, t, 1)[1][0, 0]
                == e)


def _cpu_twin(trainer: Trainer, rebuild_every: int = 1) -> LinkPredictor:
    """On the CPU, the predictor ``LinkPredictor.from_trainer`` makes."""
    fu = trainer.splits.full
    return LinkPredictor(trainer.cfg, trainer.params,
                         MemoryState(**trainer._memory_tables()), None,
                         trainer.edge_feats, trainer.full_nbr_index,
                         (fu.sources, fu.destinations, fu.timestamps,
                          fu.edge_idxs), rebuild_every, device="cpu")


def prune_serve(trainer: Trainer, card: str):
    """``LinkPredictor.from_trainer`` over the pruning Trainer, and the same
    predictor on the CPU: the serve leg's calls on both, compared; then the
    two with ``rebuild_every=1000``."""
    te, fu = trainer.splits.test, trainer.splits.full
    cols = (te.sources, te.destinations, te.timestamps.astype(np.float32),
            te.edge_idxs)
    gpu, cpu = LinkPredictor.from_trainer(trainer), _cpu_twin(trainer)
    gs, g_seen, timing = _prune_requests(gpu, cols, timed=True)
    cs, c_seen, _ = _prune_requests(cpu, cols, timed=False)
    assert g_seen == c_seen == (False, True), (g_seen, c_seen)
    score_err = max(float(np.abs(gs[b] - cs[b]).max()) for b in gs)
    assert score_err <= SCORE_ATOL, score_err
    for b in SCORE_BS:
        assert gs[b].shape == (b,) and np.isfinite(gs[b]).all(), b
    diff = (gpu.mem.memory.cpu().float() - cpu.mem.memory.float()).abs()
    mem_err, mem_share = float(diff.max()), float((diff > 0).float().mean())
    assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, (
        mem_err, mem_share)
    assert torch.equal(gpu.mem.last_update.cpu(), cpu.mem.last_update)
    for f in ("arena", "offsets", "keys", "times"):
        assert torch.equal(getattr(gpu.nbr_index, f).cpu(),
                           getattr(cpu.nbr_index, f)), f
    deferred = []
    t_new, e_new = float(fu.timestamps[-1]) + 100.0, int(
        fu.edge_idxs.max()) + 1
    for pred in (LinkPredictor.from_trainer(trainer, rebuild_every=1000),
                 _cpu_twin(trainer, rebuild_every=1000)):
        pred.observe([cols[0][0]], [cols[1][1]], [t_new], [e_new])
        slots, pending = int(pred.nbr_index.ts.shape[0]), pred._pending_n
        pred.flush_index()
        deferred.append((pending, slots, int(pred.nbr_index.ts.shape[0]),
                         pred._pending_n))
    n_arena = 2 * fu.n_interactions
    assert deferred[0] == deferred[1] == (1, n_arena, n_arena + 2, 0), (
        deferred)
    for b in SCORE_BS:
        print(f"pruning serve score b={b:5d}: {timing['score_ms'][b]:.3f} "
              f"ms/call  ({card})", flush=True)
    print("pruning serve observe b=200: " + ", ".join(
        f"{x:.3f}" for x in timing["observe_ms"]) + f" ms/call  ({card})",
        flush=True)
    res = dict(score_max_abs_err=score_err, memory_max_abs_err=mem_err,
               memory_diff_share=mem_share, new_edge_seen=list(g_seen),
               deferred_fold=deferred[0], **timing, card=card)
    print("pruning serve " + json.dumps(res), flush=True)


def prune_phase(card: str):
    """The pruning strategy (module docstring, phase 10); fails if a santa
    kernel launched during it."""
    _reset_counts()
    t0 = time.perf_counter()
    cfg, splits, edge_feats = mooc_pruning(seed=0)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, splits, edge_feats, device="cuda")
    print(f"pruning: Trainer built in {time.perf_counter() - t0:.3f} s "
          f"({splits.full.n_interactions} events, {trainer.cfg.n_nodes} "
          "rows)", flush=True)
    prune_bfs(trainer, card)
    prune_train(trainer, card)
    prune_serve(trainer, card)
    del trainer
    replay_phase(card, build=mooc_pruning, tag="pruning replay")
    seeds_replay(card, build=mooc_pruning, n_seeds=PRUNE_SEEDS,
                 lanes=PRUNE_LANES, tag="pruning seeds replay")
    assert (merge.SANTA_MERGE.launches == scan.SANTA_SCAN.launches
            == SANTA_WAVES.launches == 0), (
        merge.SANTA_MERGE.launches, scan.SANTA_SCAN.launches,
        SANTA_WAVES.launches)
    print(f"pruning: phase took {time.perf_counter() - t0:.1f} s, 0 "
          "santa_merge, santa_scan and santa_waves launches", flush=True)


def _pending_memory(cfg, t_max: float, seed: int) -> MemoryState:
    """Memory tables of ``cfg`` on the CPU, in its storage dtypes, drawn
    from ``seed``: rows in ±0.5, last updates and message times before
    ``t_max``, a pending message on about half the rows."""
    g = torch.Generator().manual_seed(seed)
    n = cfg.n_nodes
    u = lambda *shape: torch.rand(shape, generator=g)
    msgs = u(n, cfg.msg_table_dim + 1) - 0.5
    msgs[:, -1] = (u(n) < 0.5).float()
    return MemoryState(
        memory=(u(n, cfg.memory_dim) - 0.5).to(torch_dtype(cfg.memory_dtype)),
        last_update=u(n) * t_max / 2,
        messages=msgs.to(torch_dtype(cfg.message_dtype)),
        msg_ts=t_max / 2 + u(n) * t_max / 2,
        msg_count=msgs[:, -1].clone())


def towers_embed(trainer: Trainer, card: str):
    """``recursive_embed`` on the 600 roots of train batch TOWER_BATCH, in
    train and eval mode, for graph_attention and graph_sum, on the card and
    on the CPU from the same params, memory and train graph."""
    cfg = trainer.cfg
    blocks, t = bfs_roots(trainer, TOWER_BATCH)
    roots, times = torch.cat(blocks), t.repeat(len(blocks))
    tr = trainer.splits.train
    cpu_index = build_neighbor_index(tr.sources, tr.destinations,
                                     tr.timestamps, tr.edge_idxs,
                                     cfg.n_nodes, "cpu")
    mem = _pending_memory(cfg, float(t.min()), seed=1)
    gpu_mem = MemoryState(*(x.cuda() for x in mem))
    out = {}
    for tower in ("graph_attention", "graph_sum"):
        tcfg = cfg.replace(embedding_module=tower)
        params = init_tgn_params(tcfg, torch.Generator().manual_seed(0),
                                 "cpu")
        gpu_params = init_tgn_params(tcfg, torch.Generator().manual_seed(0),
                                     "cuda")
        for train in (True, False):
            call = lambda p, m, ef, idx, r, tm: recursive_embed(
                tcfg, p, m, ef, idx, r, tm, train)
            with torch.no_grad():
                got = call(gpu_params, gpu_mem, trainer.edge_feats,
                           trainer.train_nbr_index, roots, times)
                want = call(params, mem, trainer.edge_feats.cpu(), cpu_index,
                            roots.cpu(), times.cpu())
                ms = device_ms(lambda: call(
                    gpu_params, gpu_mem, trainer.edge_feats,
                    trainer.train_nbr_index, roots, times), n=10, per_round=5)
            assert got.shape == want.shape == (roots.shape[0], cfg.node_dim)
            assert torch.isfinite(got).all()
            scale = max(1.0, float(want.abs().max()))
            err = float((got.cpu() - want).abs().max())
            assert err <= TOWER_ATOL * scale, (tower, train, err, scale)
            mode = "train" if train else "eval"
            out[f"{tower}_{mode}"] = dict(ms=ms, max_abs_err=err,
                                         max_abs=scale)
            print(f"towers {tower} {mode}: {ms:.4f} ms per call on the "
                  f"device, max abs err {err:.3g} against the CPU  ({card})",
                  flush=True)
    print("towers embed " + json.dumps(dict(
        roots=int(roots.shape[0]), gathered_rows=int(roots.shape[0]) * sum(
            cfg.n_degree ** h for h in range(cfg.n_layer + 1)),
        n_degree=cfg.n_degree, n_layer=cfg.n_layer, card=card, **out)),
        flush=True)


def towers_train(trainer: Trainer, card: str):
    """A warm-up and a timed epoch, ``validate()``, ``test()``, then one
    train batch's device time (CUDA events with the stream held, so the
    host's enqueue is not timed; every batch runs the same kernels on the
    same shapes). The device's busy share of the epoch is the batches'
    device time over the epoch's seconds. (A ``torch.profiler`` trace of a
    whole epoch holds millions of events; reading them back took longer
    than the phase, and the host ran slower while they were alive.)"""
    n_train = trainer.splits.train.n_interactions
    epochs = []
    for e in (1, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = trainer.train_epoch()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        batches = int(r.per_batch.shape[0])
        assert np.isfinite(r.per_batch).all() and r.waves == 0, e
        print(f"towers train epoch {e}{' (warm-up)' if e == 1 else ''}: "
              f"{s:.3f} s, {n_train / s:.1f} train events/s ({batches} "
              f"batches), {_metrics(r)}  ({card})", flush=True)
        epochs.append(dict(seconds=s, events_per_s=n_train / s,
                           batches=batches, loss=r.loss, ap=r.ap, auc=r.auc,
                           acc=r.acc))
    t0 = time.perf_counter()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    # after the eval phases, since each timed call is a train step; one
    # batch is about 620 launches, so a round of one fits the queue
    batch_ms = device_ms(train_batch(trainer, batches // 2), n=10,
                         per_round=1)
    busy_s = batches * batch_ms / 1e3
    phases = dict(val=val, nn_val=nn_val, test=test, nn_test=nn_test)
    for name, r in phases.items():
        print(f"towers {name:8s} {r.seconds:.3f} s, {_metrics(r)}  ({card})",
              flush=True)
        assert r.waves == 0 and np.isfinite(r.per_batch).all(), name
    assert trainer.index_state is None and trainer.index_waves == 0
    assert epochs[1]["ap"] > 0.5 and val.ap > 0.5 and test.ap > 0.5, (
        epochs[1]["ap"], val.ap, test.ap)
    peak = torch.cuda.max_memory_allocated() / 2**30
    res = dict(train_events=n_train, n_nodes=trainer.cfg.n_nodes,
               arena_slots=int(trainer.full_nbr_index.ts.shape[0]),
               max_degree=trainer.full_nbr_index.max_degree, epochs=epochs,
               device_ms_per_batch=batch_ms, device_busy_s=busy_s,
               device_busy_share_of_epoch=busy_s / epochs[1]["seconds"],
               eval_s=eval_s,
               phases={k: dict(seconds=r.seconds, ap=r.ap, auc=r.auc,
                               acc=r.acc) for k, r in phases.items()},
               peak_device_gib=peak, card=card)
    print(f"towers train: {batch_ms:.3f} ms of device time per batch, "
          f"device busy {busy_s:.3f} s per epoch, "
          f"{100 * busy_s / epochs[1]['seconds']:.1f}% of the timed epoch; "
          f"peak device memory {peak:.3f} GiB  ({card})", flush=True)
    print("towers train " + json.dumps(res), flush=True)


def towers_serve(trainer: Trainer, card: str):
    """``LinkPredictor.from_trainer`` over the tower Trainer, and the same
    predictor on the CPU: the serve leg's calls on both (its brand-new edge
    id lies past the feature table), compared; peak memory of a score call
    at b = 2048."""
    te = trainer.splits.test
    cols = (te.sources, te.destinations, te.timestamps.astype(np.float32),
            te.edge_idxs)
    gpu, cpu = LinkPredictor.from_trainer(trainer), _cpu_twin(trainer)
    assert int(cols[3].max()) + 1 >= trainer.edge_feats.shape[0]
    gs, g_seen, timing = _prune_requests(gpu, cols, timed=True)
    cs, c_seen, _ = _prune_requests(cpu, cols, timed=False)
    assert g_seen == c_seen == (False, True), (g_seen, c_seen)
    score_err = max(float(np.abs(gs[b] - cs[b]).max()) for b in gs)
    assert score_err <= SCORE_ATOL, score_err
    for b in SCORE_BS:
        assert gs[b].shape == (b,) and np.isfinite(gs[b]).all(), b
    diff = (gpu.mem.memory.cpu().float() - cpu.mem.memory.float()).abs()
    mem_err, mem_share = float(diff.max()), float((diff > 0).float().mean())
    assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, (
        mem_err, mem_share)
    assert torch.equal(gpu.mem.last_update.cpu(), cpu.mem.last_update)
    b = SCORE_BS[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gpu.score(cols[0][:b], cols[1][:b], cols[2][-1] + np.zeros(b, np.float32))
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    for b in SCORE_BS:
        print(f"towers serve score b={b:5d}: {timing['score_ms'][b]:.3f} "
              f"ms/call  ({card})", flush=True)
    print("towers serve observe b=200: " + ", ".join(
        f"{x:.3f}" for x in timing["observe_ms"]) + f" ms/call; score at "
        f"b=2048 takes {peak:.3f} GiB above the state  ({card})", flush=True)
    res = dict(score_max_abs_err=score_err, memory_max_abs_err=mem_err,
               memory_diff_share=mem_share, new_edge_seen=list(g_seen),
               new_edge_past_the_table=True, score_2048_peak_gib=peak,
               **timing, card=card)
    print("towers serve " + json.dumps(res), flush=True)


def towers_phase(card: str):
    """The towers other than diffusion (module docstring, phase 11); fails
    if a santa kernel launched during it."""
    _reset_counts()
    t0 = time.perf_counter()
    cfg, splits, edge_feats = wikipedia_attention(seed=0)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, splits, edge_feats, device="cuda")
    print(f"towers: Trainer built in {time.perf_counter() - t0:.3f} s "
          f"({splits.full.n_interactions} events, {trainer.cfg.n_nodes} "
          "rows)", flush=True)
    steps = [("embed", lambda: towers_embed(trainer, card)),
             ("train", lambda: towers_train(trainer, card)),
             ("serve", lambda: towers_serve(trainer, card)),
             ("replay", lambda: replay_phase(
                 card, build=wikipedia_attention, tag="towers replay"))]
    steps += [(f"replay {tower}", lambda tower=tower, n=n: replay_phase(
        card, build=functools.partial(wikipedia_attention,
                                      embedding_module=tower),
        tag=f"towers replay {tower}", n_events=n))
        for tower, n in TOWER_REPLAYS]
    steps.append(("seeds", lambda: seeds_replay(
        card, build=wikipedia_attention, n_seeds=TOWER_SEEDS,
        lanes=TOWER_LANES, tag="towers seeds replay")))
    for name, step in steps:
        t1 = time.perf_counter()
        step()
        print(f"towers: {name} took {time.perf_counter() - t1:.1f} s",
              flush=True)
    del trainer
    assert (merge.SANTA_MERGE.launches == scan.SANTA_SCAN.launches
            == SANTA_WAVES.launches == 0), (
        merge.SANTA_MERGE.launches, scan.SANTA_SCAN.launches,
        SANTA_WAVES.launches)
    print(f"towers: phase took {time.perf_counter() - t0:.1f} s, 0 "
          "santa_merge, santa_scan and santa_waves launches", flush=True)


def _epochs(trainer: Trainer, tag: str, card: str):
    """A warm-up and a timed ``train_epoch``: one santa_waves launch per
    superchunk, no santa_merge and no santa_scan. Returns each epoch's
    seconds, train events/s, waves and metrics."""
    n_train = trainer.splits.train.n_interactions
    epochs = []
    for e in (1, 2):
        _reset_counts()
        scans = trainer.index_scans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = trainer.train_epoch()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        launches = _wave_launches(trainer, scans, (tag, e))
        assert np.isfinite(r.per_batch).all(), (tag, e)
        print(f"{tag} epoch {e}{' (warm-up)' if e == 1 else ''}: {s:.3f} s, "
              f"{n_train / s:.1f} train events/s, {r.waves} waves, "
              f"{launches} santa_waves launches, overflow {r.overflow:g}, "
              f"{_metrics(r)}  ({card})", flush=True)
        epochs.append(dict(seconds=s, events_per_s=n_train / s,
                           waves=r.waves, santa_waves_launches=launches,
                           overflow=r.overflow, loss=r.loss, ap=r.ap))
    return epochs


def options_train(card: str):
    """The options configuration at full width: two epochs, validate, test,
    one batch's device time (the busy share), the message table's size.
    Returns the Trainer and santa_waves' launches in those phases."""
    cfg, splits, edge_feats = flagship_training(seed=0, **OPTIONS)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, splits, edge_feats, device="cuda")
    table = trainer.mem.messages
    table_bytes = table.numel() * table.element_size()
    print(f"options: message table {tuple(table.shape)} {table.dtype}, "
          f"{table_bytes} B; message {trainer.cfg.message_dim} wide, cell "
          f"input {trainer.cfg.cell_input_dim}  ({card})", flush=True)
    epochs = _epochs(trainer, "options train", card)
    _reset_counts()
    scans = trainer.index_scans
    t0 = time.perf_counter()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    phases = dict(val=val, nn_val=nn_val, test=test, nn_test=nn_test)
    launches = _wave_launches(trainer, scans, "options eval")
    launches += sum(e["santa_waves_launches"] for e in epochs)
    for name, r in phases.items():
        assert np.isfinite(r.per_batch).all(), name
        print(f"options {name:8s} {r.seconds:.3f} s, {_metrics(r)}  "
              f"({card})", flush=True)
    assert epochs[1]["ap"] > 0.5 and val.ap > 0.5 and test.ap > 0.5, (
        epochs[1]["ap"], val.ap, test.ap)
    peak = torch.cuda.max_memory_allocated() / 2**30
    batches = trainer._streams["train"].real_batches
    # after the eval phases: each timed call is a train step
    batch_ms = device_ms(train_batch(trainer, batches // 2), n=10,
                         per_round=1)
    busy_s = batches * batch_ms / 1e3
    res = dict(options=OPTIONS, n_nodes=trainer.cfg.n_nodes,
               message_dim=trainer.cfg.message_dim,
               message_table_bytes=table_bytes, epochs=epochs,
               device_ms_per_batch=batch_ms, device_busy_s=busy_s,
               device_busy_share_of_epoch=busy_s / epochs[1]["seconds"],
               eval_s=eval_s, phases={k: dict(seconds=r.seconds, ap=r.ap,
                                              auc=r.auc, acc=r.acc)
                                      for k, r in phases.items()},
               peak_device_gib=peak, card=card)
    print(f"options train: {batch_ms:.3f} ms of device time per batch, "
          f"busy {100 * busy_s / epochs[1]['seconds']:.1f}% of the timed "
          f"epoch; peak device memory {peak:.3f} GiB  ({card})", flush=True)
    print("options train " + json.dumps(res), flush=True)
    return trainer, launches


def options_serve(trainer: Trainer, card: str) -> int:
    """Serving the options Trainer on the card and on the CPU: observe
    calls (one extracting santa_scan launch each), scores at each b.
    Returns santa_scan's launches."""
    te = trainer.splits.test
    src, dst, ts, eidx = (te.sources, te.destinations,
                          te.timestamps.astype(np.float32), te.edge_idxs)
    gpu = LinkPredictor.from_trainer(trainer)
    cpu = LinkPredictor(trainer.cfg, trainer.params,
                        MemoryState(**trainer._memory_tables()),
                        trainer.index_state, trainer.edge_feats,
                        device="cpu")
    _reset_counts()
    scan.SANTA_SCAN.extracting = 0
    observe_ms = []
    for pred in (gpu, cpu):
        for c in range(OPTIONS_OBSERVE_CALLS):
            sl = slice(c * OPTIONS_OBSERVE_B, (c + 1) * OPTIONS_OBSERVE_B)
            t0 = time.perf_counter()
            pred.observe(src[sl], dst[sl], ts[sl], eidx[sl])
            if pred is gpu:
                torch.cuda.synchronize()
                observe_ms.append(1e3 * (time.perf_counter() - t0))
    assert (scan.SANTA_SCAN.launches == scan.SANTA_SCAN.extracting
            == OPTIONS_OBSERVE_CALLS
            and merge.SANTA_MERGE.launches == SANTA_WAVES.launches == 0), (
        scan.SANTA_SCAN.launches, scan.SANTA_SCAN.extracting,
        merge.SANTA_MERGE.launches, SANTA_WAVES.launches)
    lo = OPTIONS_OBSERVE_CALLS * OPTIONS_OBSERVE_B
    score_ms, score_err = {}, 0.0
    for b in SCORE_BS:
        sl = slice(lo, lo + b)
        g = gpu.score(src[sl], dst[sl], ts[sl])
        c = cpu.score(src[sl], dst[sl], ts[sl])
        assert g.shape == (b,) and np.isfinite(g).all(), b
        score_err = max(score_err, float(np.abs(g - c).max()))
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            gpu.score(src[sl], dst[sl], ts[sl])
            lat.append(time.perf_counter() - t0)
        score_ms[b] = 1e3 * float(np.median(lat))
    assert score_err <= SCORE_ATOL, score_err
    assert torch.equal(gpu.index_state.data.cpu(), cpu.index_state.data)
    diff = (gpu.mem.memory.cpu().float() - cpu.mem.memory.float()).abs()
    mem_err, mem_share = float(diff.max()), float((diff > 0).float().mean())
    assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, (
        mem_err, mem_share)
    for f in ("last_update", "msg_count", "msg_ts"):
        assert torch.equal(getattr(gpu.mem, f).cpu(), getattr(cpu.mem, f)), f
    print("options serve observe b=200: " + ", ".join(
        f"{x:.3f}" for x in observe_ms) + f" ms/call, "
        f"{scan.SANTA_SCAN.extracting} extracting santa_scan launches for "
        f"{OPTIONS_OBSERVE_CALLS} calls  ({card})", flush=True)
    for b in SCORE_BS:
        print(f"options serve score b={b:5d}: {score_ms[b]:.3f} ms/call  "
              f"({card})", flush=True)
    print("options serve " + json.dumps(dict(
        observe_ms=observe_ms, score_ms=score_ms,
        santa_scan_launches=scan.SANTA_SCAN.launches,
        extracting_launches=scan.SANTA_SCAN.extracting,
        score_max_abs_err=score_err, memory_max_abs_err=mem_err,
        memory_diff_share=mem_share, index_bitwise_cuda_vs_cpu=True,
        card=card)), flush=True)
    return scan.SANTA_SCAN.launches


class _Records(logging.Handler):
    """Keeps the messages of the records it handles."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def options_lazy(card: str, per_position_s: float):
    """The compaction on the plain flagship: the auto cap's epochs beside
    phase 7's per-position epoch, its replay against per-position at JAX's
    bar, and an overflowing cap's rerun against a per-position epoch."""
    cfg, splits, edge_feats = flagship_training(seed=0,
                                                lazy_unique_cap=AUTO_CAP)
    auto = Trainer(cfg, splits, edge_feats, device="cuda")
    epochs = _epochs(auto, "lazy auto cap", card)
    print(f"lazy auto cap: timed epoch {epochs[1]['seconds']:.3f} s against "
          f"{per_position_s:.3f} s per position (phase 7)  ({card})",
          flush=True)
    del auto

    f32 = dict(dropout=0.0, memory_dtype="float32", message_dtype="float32")
    legs = {}
    for cap in (AUTO_CAP, 0):
        cfg, splits, edge_feats = flagship_training(
            seed=0, n_events=TRAIN_REPLAY_EVENTS, lazy_unique_cap=cap, **f32)
        t = Trainer(cfg, splits, edge_feats, device="cuda")
        legs[cap] = (t.train_epoch(), t.validate()[0])
    (ra, va), (ro, vo) = legs[AUTO_CAP], legs[0]
    assert ra.overflow == 0.0
    np.testing.assert_allclose(ra.per_batch[:, 0], ro.per_batch[:, 0],
                               rtol=LAZY_RTOL, atol=LAZY_ATOL)
    np.testing.assert_allclose([va.loss, va.ap], [vo.loss, vo.ap],
                               rtol=LAZY_RTOL, atol=LAZY_ATOL)
    replay_err = float(np.abs(ra.per_batch[:, 0] - ro.per_batch[:, 0]).max())

    cfg, splits, edge_feats = flagship_training(seed=0)
    records = _Records()
    logger = logging.getLogger("zebra_tpu_torch")
    logger.addHandler(records)
    try:
        over = Trainer(cfg.replace(lazy_unique_cap=OVERFLOW_CAP), splits,
                       edge_feats, device="cuda")
        t0 = time.perf_counter()
        r_over = over.train_epoch()
        torch.cuda.synchronize()
        over_s = time.perf_counter() - t0
    finally:
        logger.removeHandler(records)
    assert over._lazy_fallback and any(
        "rerunning the epoch on the per-position path" in m
        for m in records.messages), records.messages
    plain = Trainer(cfg, splits, edge_feats, device="cuda")
    r_plain = plain.train_epoch()
    bitwise = (np.array_equal(r_over.per_batch, r_plain.per_batch)
               and _bitwise(over, plain)
               and torch.equal(over.index_state.data, plain.index_state.data))
    res = dict(auto_cap_epochs=epochs, per_position_epoch_s=per_position_s,
               replay_events=TRAIN_REPLAY_EVENTS,
               replay_batch_loss_max_abs_err=replay_err,
               replay_val_ap=[va.ap, vo.ap],
               overflow_cap=OVERFLOW_CAP, overflow_warning=records.messages,
               overflow_epoch_with_rerun_s=over_s,
               overflow_rerun_bitwise=bool(bitwise), card=card)
    print(f"lazy overflow cap {OVERFLOW_CAP}: warning logged, epoch rerun "
          f"per position ({over_s:.3f} s with the rerun), bit-equal to a "
          f"per-position epoch: {bitwise}  ({card})", flush=True)
    print("lazy " + json.dumps(res), flush=True)
    assert bitwise


def options_nans(card: str):
    """``debug_nans`` with a NaN in the edge features of the first train
    batch's last event, whose message wins the store of both its nodes."""
    cfg, splits, edge_feats = flagship_training(
        seed=0, n_events=TRAIN_REPLAY_EVENTS, debug_nans=True)
    edge_feats = edge_feats.copy()
    edge_feats[splits.train.edge_idxs[cfg.bs - 1], 0] = np.nan
    trainer = Trainer(cfg, splits, edge_feats, device="cuda")
    try:
        trainer.train_epoch()
    except FloatingPointError as e:
        print(f"debug_nans: FloatingPointError: {e}  ({card})", flush=True)
        assert "train batch 0" in str(e), e
        return
    raise AssertionError("debug_nans let a NaN through")


def options_phase(card: str, per_position_s: float):
    """The model options (module docstring, phase 12). Returns the
    launches of santa_waves (training) and santa_scan (serving) on the
    options path."""
    t0 = time.perf_counter()
    trainer, wave_launches = options_train(card)
    scan_launches = options_serve(trainer, card)
    build = functools.partial(flagship_training, **OPTIONS)
    steps = [("replay", lambda: replay_phase(
                 card, build=build, tag="options replay", twice=True)),
             ("seeds", lambda: seeds_replay(
                 card, build=build, n_seeds=OPTIONS_SEEDS,
                 lanes=OPTIONS_LANES, tag="options seeds replay")),
             ("lazy", lambda: options_lazy(card, per_position_s)),
             ("nans", lambda: options_nans(card))]
    for name, step in steps:
        t1 = time.perf_counter()
        step()
        print(f"options: {name} took {time.perf_counter() - t1:.1f} s",
              flush=True)
    print(f"options: phase took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return wave_launches, scan_launches


# ------------------------------------------------------------- phase 13

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _lanes_err(got, want) -> tuple:
    """(max abs err, share of entries that differ) of two tables."""
    diff = (got.float() - want.float()).abs()
    return float(diff.max()), float((diff > 0).float().mean())


def shard_rank(out: str, device: str, n_events: int) -> None:
    """(a), one rank of the group: the flagship with SHARD_SEEDS seeds over
    SHARD_RANKS ranks, first the lane replay (TRAIN_REPLAY_EVENTS events:
    an epoch and validate()), then on ``n_events``: a warm-up and a timed
    epoch, validate() and test(); what the parent compares goes to
    ``out/rank<r>.pt``."""
    res = {}
    for leg, n in (("replay", TRAIN_REPLAY_EVENTS), ("full", n_events)):
        cfg, splits, edge_feats = flagship_training(
            seed=0, n_events=n, parallel_runs=SHARD_SEEDS,
            n_devices=SHARD_RANKS)
        trainer = Trainer(cfg.replace(checkpoint_dir=out), splits,
                          edge_feats, device=device)
        res[leg] = (_shard_replay if leg == "replay" else _shard_run)(
            trainer)
    res.update(rank=trainer.mesh.rank, lanes=list(trainer._lanes),
               device=str(trainer.device))
    torch.save(res, os.path.join(out, f"rank{trainer.mesh.rank}.pt"))


def _shard_replay(trainer: Trainer) -> dict:
    """One epoch and validate() (seeds_replay's legs): per-batch losses,
    this rank's params and memory, the val metrics."""
    r, v = trainer.train_epoch(), trainer.validate()[0]
    return dict(per_batch=r.per_batch, steps=int(r.per_batch.shape[0]),
                params={k: x.detach().cpu().clone()
                        for k, x in trainer.params.state_dict().items()},
                memory=trainer._memory_tables()["memory"].cpu().clone(),
                val=np.stack([v.ap, v.auc, v.acc]))


def _shard_run(trainer: Trainer) -> dict:
    """Two epochs, validate() and test() of a seed-parallel Trainer, with
    the santa launches counted from 0."""
    dev = trainer.device
    _reset_counts()
    epochs, mem1 = [], None
    for e in (1, 2):
        _sync(dev)
        t0 = time.perf_counter()
        r = trainer.train_epoch()
        _sync(dev)
        epochs.append(dict(seconds=time.perf_counter() - t0, waves=r.waves,
                           index_host_s=r.index_seconds,
                           gather_ms=1e3 * r.gather_seconds,
                           per_batch=r.per_batch))
        if e == 1:
            mem1 = trainer._memory_tables()["memory"].cpu().clone()
    train_index = trainer.index_state.data.cpu().clone()
    t0 = time.perf_counter()
    phases = dict(zip(("val", "nn_val", "test", "nn_test"),
                      (*trainer.validate(), *trainer.test())))
    _sync(dev)
    return dict(
        epochs=epochs, mem1=mem1, train_index=train_index,
        eval_s=time.perf_counter() - t0,
        index_end=trainer.index_state.data.cpu().clone(),
        phases={k: dict(per_batch=r.per_batch, waves=r.waves,
                        gather_ms=1e3 * r.gather_seconds)
                for k, r in phases.items()},
        **_counts(trainer))


def _replay_errs(ranks, one, lr: float) -> dict:
    """The ranks' lane replay against the one-process run's, at phase 9's
    lane bars."""
    loss = max(float(np.abs(r["replay"]["per_batch"][..., 0]
                            - one["per_batch"][..., 0]).max()) for r in ranks)
    params = max(float((torch.cat([r["replay"]["params"][k] for r in ranks])
                        - v).abs().max()) for k, v in one["params"].items())
    mem_err, mem_share = _lanes_err(
        torch.cat([r["replay"]["memory"] for r in ranks]), one["memory"])
    metric = max(float(np.abs(r["replay"]["val"] - one["val"]).max())
                 for r in ranks)
    res = dict(events=TRAIN_REPLAY_EVENTS, steps=one["steps"],
               batch_loss_max_abs_err=loss, params_max_abs_err=params,
               memory_max_abs_err=mem_err, memory_diff_share=mem_share,
               val_metric_max_abs_err=metric)
    assert loss <= LANE_LOSS_ATOL, res
    assert params <= 2 * lr * one["steps"], res
    assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, res
    assert metric <= LANE_METRIC_ATOL, res
    return res


def _divergence(got: np.ndarray, want: np.ndarray) -> dict:
    """Per-batch loss error of a lane grouping against another over an
    epoch: where it first passes each bar, and its largest."""
    err = np.abs(got[..., 0] - want[..., 0]).max(axis=-1)
    first = lambda bar: int(np.argmax(err > bar)) if (err > bar).any() else None
    return dict(batches=len(err), first_batch_err=float(err[0]),
                max_err=float(err.max()),
                first_batch_past={f"{b:g}": first(b)
                                  for b in (1e-7, 1e-6, 1e-5, 1e-4, 1e-3)})


def shard_train(card: str, device: str = "cuda:0",
                n_events: int = 120_000) -> int:
    """(a): two ranks sharing one card against one process on it. Returns
    santa_waves' launches of both's full runs."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch(shard_rank, SHARD_RANKS, (tmp, device, n_events),
               threads=max(1, (os.cpu_count() or 2) // SHARD_RANKS))
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(SHARD_RANKS)]
    runs = {}
    for leg, n in (("replay", TRAIN_REPLAY_EVENTS), ("full", n_events)):
        cfg, splits, edge_feats = flagship_training(
            seed=0, n_events=n, parallel_runs=SHARD_SEEDS)
        trainer = Trainer(cfg, splits, edge_feats, device=device)
        runs[leg] = (_shard_replay if leg == "replay" else _shard_run)(
            trainer)
    one = runs["full"]
    per = SHARD_SEEDS // SHARD_RANKS
    assert [r["lanes"] for r in ranks] == [
        list(range(i * per, (i + 1) * per)) for i in range(SHARD_RANKS)]
    replay = _replay_errs(ranks, runs["replay"], cfg.lr)
    index_bitwise = all(
        torch.equal(r["full"]["train_index"], one["train_index"])
        and torch.equal(r["full"]["index_end"], one["index_end"])
        for r in ranks)
    assert index_bitwise, "a rank's index differs from the one-process run"
    cuda = torch.device(device).type == "cuda"
    _hold_counts(one, cuda, "one process")
    launches = one["santa_waves_launches"]
    for r in ranks:
        full = r["full"]
        _hold_counts(full, cuda, r["rank"])
        launches += full["santa_waves_launches"]
        for e, ep in enumerate(full["epochs"], 1):
            print(f"shard rank {r['rank']} of {SHARD_RANKS} on {r['device']} "
                  f"(lanes {r['lanes']}) epoch {e}"
                  f"{' (warm-up)' if e == 1 else ''}: {ep['seconds']:.3f} s, "
                  f"{ep['waves']} waves, metrics gather "
                  f"{ep['gather_ms']:.3f} ms; the ranks share one card, so "
                  f"this is no scaling figure  ({card})", flush=True)
        print(f"shard rank {r['rank']}: {full['santa_waves_launches']} "
              f"santa_waves launches, validate + test "
              f"{full['eval_s']:.3f} s", flush=True)
        aps = [full["phases"][k]["per_batch"][..., 1].mean(0)
               for k in ("val", "test")]
        assert all(np.isfinite(ep["per_batch"]).all()
                   for ep in full["epochs"]) and min(
                       float(a.min()) for a in aps) > 0.5, aps
    print(f"one process, {SHARD_SEEDS} seeds on {device}: epochs "
          f"{one['epochs'][0]['seconds']:.3f} s (warm-up), "
          f"{one['epochs'][1]['seconds']:.3f} s  ({card})", flush=True)
    # the full run, held to nothing but its index: over 322 Adam steps a
    # summation order that depends on the lane grouping drifts the lanes
    # apart (reported, with where the drift passes each bar)
    full0 = ranks[0]["full"]
    mem_err, mem_share = _lanes_err(
        torch.cat([r["full"]["mem1"] for r in ranks]), one["mem1"])
    res = dict(seeds=SHARD_SEEDS, ranks=SHARD_RANKS, device=device,
               events=n_events, group_s=group_s,
               rank_epoch_s=[[e["seconds"] for e in r["full"]["epochs"]]
                             for r in ranks],
               one_process_epoch_s=[e["seconds"] for e in one["epochs"]],
               rank_santa_waves_launches=[r["full"]["santa_waves_launches"]
                                          for r in ranks],
               index_bitwise=index_bitwise, lane_replay=replay,
               full_epoch1=_divergence(full0["epochs"][0]["per_batch"],
                                       one["epochs"][0]["per_batch"]),
               full_epoch2=_divergence(full0["epochs"][1]["per_batch"],
                                       one["epochs"][1]["per_batch"]),
               full_epoch1_memory_max_abs_err=mem_err,
               full_epoch1_memory_diff_share=mem_share,
               full_eval_metric_max_abs_err=max(
                   float(np.abs(full0["phases"][k]["per_batch"][..., 1:]
                                .mean(0) - one["phases"][k]["per_batch"]
                                [..., 1:].mean(0)).max())
                   for k in one["phases"]),
               card=card)
    print("shard train " + json.dumps(res), flush=True)
    return launches


def cli_rank(argv, out: str) -> None:
    """(b), one rank of the CLI's run: the CLI's own rank entry, then its
    results and the santa launches to ``out/<rank>.json``."""
    from zebra_tpu_torch.parallel.distributed import rank

    _reset_counts()
    ns = Config.arg_parser().parse_args(argv)
    (trainer, results), = cli._main_rank(Config.from_dict(vars(ns)),
                                         resolve_device(ns.device))
    with open(os.path.join(out, f"{rank()}.json"), "w") as f:
        json.dump(dict(results=results, device=str(trainer.device),
                       **_counts(trainer),
                       epochs=[dict(train_s=e["train_s"], val_s=e["val_s"],
                                    waves=e["waves"], state_s=e["state_s"])
                               for e in trainer.epoch_log]), f)


def _cli_ranks(argv, root: Path, tag: str):
    out = root / f"out_{tag}"
    out.mkdir()
    t0 = time.perf_counter()
    launch(cli_rank, SHARD_RANKS, (argv, str(out)),
           threads=max(1, (os.cpu_count() or 2) // SHARD_RANKS))
    s = time.perf_counter() - t0
    ranks = [json.loads((out / f"{r}.json").read_text())
             for r in range(SHARD_RANKS)]
    assert all(r["results"] == ranks[0]["results"] for r in ranks), tag
    cuda = ranks[0]["device"].startswith("cuda")
    for r in ranks:
        _hold_counts(r, cuda, tag)
    return ranks, s


def _state_bitwise(a: str, b: str) -> bool:
    """Whether two state files hold the same tensors."""
    leaves = lambda t: (
        list(t["params"].values()) + list(t["mem"].values())
        + t["optimizer"]["exp_avg"] + t["optimizer"]["exp_avg_sq"]
        + [t["index_state"], t["dropout"]])
    return all(torch.equal(x, y) for x, y in zip(
        leaves(load_checkpoint(a)), leaves(load_checkpoint(b))))


def shard_cli(card: str, device: str = "cuda:0",
              n_events: int = 120_000) -> int:
    """(b): the CLI's form on two ranks, its resume and its state file
    served, against one process. Returns santa_waves' launches."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_bench_dataset(root, n_events)
        base = ["-d", "bench", "--data_dir", str(root), *SHARD_FLAGS,
                "--device", device]
        run = lambda tag, *extra: [*base, "--checkpoint_dir",
                                   str(root / tag), "--log_dir",
                                   str(root / f"log_{tag}"), *extra]
        sharded = ["--n_devices", str(SHARD_RANKS)]
        a, a_s = _cli_ranks(run("a", "--n_epoch", "2", *sharded), root, "a")
        b1, _ = _cli_ranks(run("b1", "--n_epoch", "1", *sharded), root, "b1")
        states = lambda tag: sorted((root / tag).glob("*.state.ckpt"))
        b1_state, = states("b1")
        b2, b2_s = _cli_ranks(run("b2", "--n_epoch", "2", *sharded,
                                  "--resume_state", str(b1_state)),
                              root, "b2")
        a_state, = states("a")
        b2_state, = states("b2")
        assert a_state.name == b2_state.name and a_state.name.endswith(
            f"_par_{SHARD_SEEDS}.state.ckpt"), (a_state, b2_state)
        logs = list((root / "log_a" / "bench").iterdir())
        assert len(logs) == 1 and "Test statistics" in logs[0].read_text()
        resume_bitwise = (_state_bitwise(str(a_state), str(b2_state))
                          and a[0]["results"] == b2[0]["results"])
        assert resume_bitwise, (a[0]["results"], b2[0]["results"])
        # the one-process run of that state: a Trainer of S seeds on the
        # card restored from the ranks' file, and its predictors
        _, edge_feats = load_feat("bench", str(root))
        ns = Config.arg_parser().parse_args(run("c", "--n_epoch", "2"))
        one = Trainer(Config.from_dict(vars(ns)), get_data("bench",
                                                           str(root)),
                      edge_feats, device=device)
        one.restore_state(str(a_state))
        state_bytes = a_state.stat().st_size
        live = EnsemblePredictor.from_trainer(one)
        te = one.splits.test
        q = (te.sources[:ENSEMBLE_SCORE_B], te.destinations[:ENSEMBLE_SCORE_B],
             te.timestamps[:ENSEMBLE_SCORE_B])
        serve = lambda **kw: LinkPredictor.from_checkpoint(
            str(a_state), edge_feats=edge_feats, device=device, **kw)
        ens = serve(ensemble=True)
        assert isinstance(ens, EnsemblePredictor) and ens.n_models == SHARD_SEEDS
        lane = SHARD_SEEDS - 1     # a lane of the last rank
        got, want = ens.score(*q), live.score(*q)
        ens_err = float(np.abs(got - want).max())
        lane_err = float(np.abs(serve(run_index=lane).score(*q)
                                - live.member_scores(*q)[lane]).max())
        assert np.isfinite(got).all() and got.shape == (len(q[0]),)
    launches = 0
    for tag, ranks in (("a", a), ("b1", b1), ("b2", b2)):
        launches += sum(r["santa_waves_launches"] for r in ranks)
    res = dict(seeds=SHARD_SEEDS, ranks=SHARD_RANKS, device=device,
               uninterrupted_s=a_s, resumed_s=b2_s,
               rank_epochs=[r["epochs"] for r in a],
               rank_santa_waves_launches={tag: [r["santa_waves_launches"]
                                                for r in ranks]
                                          for tag, ranks in (("a", a),
                                                             ("b1", b1),
                                                             ("b2", b2))},
               state_file=a_state.name,
               state_file_bytes=state_bytes,
               resume_bitwise=resume_bitwise,
               ensemble_vs_one_process_max_abs_err=ens_err,
               lane_vs_one_process_member_max_abs_err=lane_err,
               per_seed=a[0]["results"]["per_seed"], card=card)
    print("shard cli " + json.dumps(res), flush=True)
    assert ens_err <= SCORE_ATOL and lane_err <= SCORE_ATOL, (ens_err,
                                                              lane_err)
    return launches


def _eval_peak(trainer: Trainer) -> dict:
    """validate() + test() with the device's allocation peak."""
    dev = trainer.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = time.perf_counter()
    phases = (*trainer.validate(), *trainer.test())
    _sync(dev)
    return dict(
        seconds=time.perf_counter() - t0, host_copy_s=trainer.host_copy_seconds,
        base_bytes=base,
        peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else 0,
        peak_reserved_bytes=torch.cuda.max_memory_reserved(dev) if cuda else 0,
        per_batch=[r.per_batch for r in phases],
        mem={k: v.cpu().clone() for k, v in trainer._memory_tables().items()},
        index=trainer.index_state.data.cpu().clone())


def host_backup_phase(card: str, device: str = "cuda",
                      n_events: int = 120_000) -> int:
    """(c): validate() + test() of the flagship at S = BACKUP_SEEDS from
    one train-end state under the device protocol, then under host backups
    (a Trainer restored from that state). Returns santa_waves' launches."""
    cfg, splits, edge_feats = flagship_training(
        seed=0, n_events=n_events, parallel_runs=BACKUP_SEEDS)
    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_end.state.ckpt")
        dev_t = Trainer(cfg.replace(host_backup=False), splits, edge_feats,
                        device=device)
        dev_t.train_epoch()
        dev_t.save_state(path)
        on_dev = _eval_peak(dev_t)
        tables = mb.budget(dev_t.cfg, BACKUP_SEEDS, 0).tables
        index = mb.index_bytes(dev_t.cfg)
        del dev_t
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        host_t = Trainer(cfg.replace(host_backup=True), splits, edge_feats,
                         device=device)
        host_t.restore_state(path)
        on_host = _eval_peak(host_t)
        del host_t
        gc.collect()
    bitwise = (all(np.array_equal(x, y) for x, y in zip(
        on_dev["per_batch"], on_host["per_batch"]))
        and all(torch.equal(on_dev["mem"][k], on_host["mem"][k])
                for k in on_dev["mem"])
        and torch.equal(on_dev["index"], on_host["index"]))
    assert bitwise, "host backups changed a result"
    guard = guard_constants(cfg, splits, edge_feats, device)
    res = dict(seeds=BACKUP_SEEDS, table_bytes=tables, index_bytes=index,
               bitwise=bitwise, **{
                   name: dict(seconds=m["seconds"],
                              host_copy_s=m["host_copy_s"],
                              base_bytes=m["base_bytes"],
                              peak_bytes=m["peak_bytes"],
                              peak_above_base=m["peak_bytes"]
                              - m["base_bytes"],
                              peak_reserved_bytes=m["peak_reserved_bytes"])
                   for name, m in (("device", on_dev), ("host", on_host))},
               guard=guard, card=card)
    print("host backup " + json.dumps(res), flush=True)
    if torch.device(device).type == "cuda":
        assert on_host["peak_bytes"] < on_dev["peak_bytes"], (
            on_host["peak_bytes"], on_dev["peak_bytes"])
    assert merge.SANTA_MERGE.launches == scan.SANTA_SCAN.launches == 0
    return SANTA_WAVES.launches


def guard_constants(cfg, splits, edge_feats, device) -> dict:
    """The guard's constants measured (beside the ones it holds): the peak
    of validate() + test() above the bytes allocated before them, for each
    protocol at S = 2 and 5 on two streams of N1 and N2 node rows
    (untrained Trainers: the peak depends on shapes alone). Its growth per
    seed is b + (copies - 1)·N·row: a seed's batch activations and its
    extra table copies, solved from the two N. Then one seed's flush, in
    place, alone: its bytes per node row; and allocated over reserved bytes
    at the host protocol's peak."""
    if torch.device(device).type != "cuda":
        return {}
    small, small_ef = synthetic_stream(120_000, 5_000, 5_000, edge_dim=172,
                                       seed=0)
    streams = {"bench": (splits, edge_feats),
               "small": (split_data(small.sources, small.destinations,
                                    small.timestamps, small.edge_idxs,
                                    small.labels), small_ef)}
    extra, rows, share, flush_row = {}, {}, None, None
    for name, (sp, ef) in streams.items():
        for host in (False, True):
            for s in GUARD_SEEDS:
                t = Trainer(cfg.replace(parallel_runs=s, host_backup=host),
                            sp, ef, device=device)
                rows[name] = t.cfg.n_nodes
                m = _eval_peak(t)
                extra[name, host, s] = m["peak_bytes"] - m["base_bytes"]
                if name == "bench" and host and s == GUARD_SEEDS[-1]:
                    share = m["peak_bytes"] / m["peak_reserved_bytes"]
                    torch.cuda.synchronize(device)
                    torch.cuda.reset_peak_memory_stats(device)
                    before = torch.cuda.memory_allocated(device)
                    n = t.cfg.n_nodes
                    flush_pending_(t.cfg, lane_params(t.params, 0),
                                   MemoryState(*(x[:n] for x in t.mem)))
                    torch.cuda.synchronize(device)
                    flush_row = (torch.cuda.max_memory_allocated(device)
                                 - before) / n
                del t
                gc.collect()
                torch.cuda.empty_cache()
    lo, hi = GUARD_SEEDS
    row = mb.row_bytes(cfg)
    out = dict(seeds=list(GUARD_SEEDS), node_rows=rows,
               flush_row_bytes=flush_row, allocated_over_reserved=share,
               peak_above_base={f"{n} {'host' if h else 'device'} S={s}": v
                                for (n, h, s), v in extra.items()})
    for host in (False, True):
        per_seed = {n: (extra[n, host, hi] - extra[n, host, lo]) / (hi - lo)
                    for n in streams}
        c = (per_seed["bench"] - per_seed["small"]) / (
            (rows["bench"] - rows["small"]) * row)
        key = "host" if host else "device"
        out[f"{key}_copies"] = 1 + c
        out[f"{key}_lane_batch_bytes"] = per_seed["bench"] - c * rows[
            "bench"] * row
    out["held"] = dict(device_copies=mb.DEVICE_COPIES,
                       host_copies=mb.HOST_COPIES,
                       lane_batch_bytes=mb.LANE_BATCH_BYTES,
                       flush_row_bytes=mb.FLUSH_ROW_BYTES,
                       usable_share=mb.USABLE_SHARE)
    return out


def guard_phase(card: str, device: str = "cuda") -> None:
    """(d): the guard's decision at Wiki-Talk's node count for S = 1, 2, …
    on this card's free memory, until both protocols are refused."""
    free, total = torch.cuda.mem_get_info(device)
    cfg, _, _ = flagship_training(seed=0, n_events=10)
    cfg = cfg.replace(n_nodes=WIKI_TALK_NODES, edge_dim=1)
    rows = []
    for s in range(1, 1000):
        b = mb.budget(cfg, s, free)
        rows.append(dict(seeds=s, auto=b.decide(None),
                         device_protocol=b.decide(False),
                         host_backup=b.decide(True),
                         device_gib=b.device / 2**30,
                         host_gib=b.host / 2**30))
        if rows[-1]["host_backup"] == "refused":
            break
    # one line per run of equal decisions
    runs = []
    for r in rows:
        key = (r["auto"], r["device_protocol"], r["host_backup"])
        if runs and runs[-1][0] == key:
            runs[-1][2] = r
        else:
            runs.append([key, r, r])
    for (auto, forced_dev, forced_host), lo, hi in runs:
        print(f"guard at {WIKI_TALK_NODES} nodes, S = {lo['seeds']}-"
              f"{hi['seeds']}: auto {auto}, --no_host_backup {forced_dev}, "
              f"--host_backup {forced_host} (device protocol "
              f"{lo['device_gib']:.2f}-{hi['device_gib']:.2f} GiB, host "
              f"{lo['host_gib']:.2f}-{hi['host_gib']:.2f} GiB of "
              f"{mb.USABLE_SHARE * free / 2**30:.2f} usable)  ({card})",
              flush=True)
    print("guard " + json.dumps(dict(
        n_nodes=WIKI_TALK_NODES, row_bytes=mb.row_bytes(cfg),
        index_bytes=mb.index_bytes(cfg), free_bytes=free, total_bytes=total,
        largest_device=max([r["seeds"] for r in rows
                            if r["device_protocol"] != "refused"] or [0]),
        largest_host=max([r["seeds"] for r in rows
                          if r["host_backup"] != "refused"] or [0]),
        card=card)), flush=True)


def shard_phase(card: str):
    """Phase 13 (module docstring). Returns santa_waves' launches of its
    main path and the merge's result at a rank's wave shape."""
    merged = seed_merge_phase(card, SHARD_MERGE)
    launches = shard_train(card)
    launches += shard_cli(card)
    launches += host_backup_phase(card)
    guard_phase(card)
    return launches, merged


# ------------------------------------------------------------- phase 14

def _cpu_tree(tree):
    """Every tensor of a nested dict or list, detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu_tree(v) for v in tree]
    return tree


def _exchange(trainer: Trainer) -> dict:
    """The row exchange's counts since their last reset, per kind."""
    return {kind: dict(calls=n, bytes=b, seconds=sec)
            for kind, (n, b, sec) in trainer.exchange.stats.items()}


def rows_rank(out: str, device: str, n_events: int) -> None:
    """(a), one rank: the flagship's one seed over ROWS_RANKS ranks, the
    replay leg (TRAIN_REPLAY_EVENTS events), then the full leg on
    ``n_events``; what the parent compares goes to ``out/rows<r>.pt``."""
    res = {}
    for leg, n in (("replay", TRAIN_REPLAY_EVENTS), ("full", n_events)):
        cfg, splits, edge_feats = flagship_training(
            seed=0, n_events=n, n_devices=ROWS_RANKS,
            dropout=ROWS_REPLAY_DROPOUT if leg == "replay" else 0.1)
        trainer = Trainer(cfg.replace(checkpoint_dir=out), splits,
                          edge_feats, device=device)
        res[leg] = (_rows_replay(trainer) if leg == "replay"
                    else _rows_run(trainer, out))
    res.update(rank=trainer.mesh.rank, backend=trainer.exchange.backend,
               device=str(trainer.device),
               local_rows=int(trainer.mem.memory.shape[0]))
    torch.save(res, os.path.join(out, f"rows{trainer.mesh.rank}.pt"))


def _rows_replay(trainer: Trainer) -> dict:
    """One epoch and validate(): per-batch metrics, the params, the
    gathered memory table and the val metrics."""
    r, v = trainer.train_epoch(), trainer.validate()[0]
    mem, _ = trainer.gathered_state()
    return dict(per_batch=r.per_batch, steps=int(r.per_batch.shape[0]),
                params=_cpu_tree(trainer.params.state_dict()),
                memory=mem.memory.cpu().clone(),
                val=np.asarray([v.ap, v.auc, v.acc]))


def _rows_run(trainer: Trainer, out: str) -> dict:
    """Two epochs, then validate() + test() under the device protocol and,
    from the saved train-end state, under host backups."""
    dev = trainer.device
    _reset_counts()
    epochs = []
    for _ in (1, 2):
        trainer.exchange.reset_stats()
        _sync(dev)
        t0 = time.perf_counter()
        r = trainer.train_epoch()
        _sync(dev)
        epochs.append(dict(seconds=time.perf_counter() - t0, waves=r.waves,
                           index_host_s=r.index_seconds,
                           gather_ms=1e3 * r.gather_seconds,
                           per_batch=r.per_batch, exchange=_exchange(trainer)))
    _, index = trainer.gathered_state()
    train_index = index.data.cpu().clone()
    path = os.path.join(out, "rows_train_end.state.ckpt")
    trainer.save_state(path)
    evals, eval_exchange = {}, {}
    for host in (False, True):
        if host:
            trainer.host_backup = True
            trainer.restore_state(path)
        trainer.exchange.reset_stats()
        evals[host] = _eval_peak(trainer)
        eval_exchange[host] = _exchange(trainer)
        if not host:
            _, index = trainer.gathered_state()
            index_end = index.data.cpu().clone()
    waves = sum(e["waves"] for e in epochs)
    bitwise = (all(np.array_equal(x, y) for x, y in zip(
        evals[False]["per_batch"], evals[True]["per_batch"]))
        and all(torch.equal(evals[False]["mem"][k], evals[True]["mem"][k])
                for k in evals[False]["mem"])
        and torch.equal(evals[False]["index"], evals[True]["index"]))
    return dict(
        epochs=epochs, train_index=train_index, index_end=index_end,
        eval={("host" if h else "device"): dict(
            seconds=m["seconds"], host_copy_s=m["host_copy_s"],
            base_bytes=m["base_bytes"], peak_bytes=m["peak_bytes"],
            peak_above_base=m["peak_bytes"] - m["base_bytes"],
            per_batch=m["per_batch"], exchange=eval_exchange[h])
            for h, m in evals.items()},
        host_backup_bitwise=bitwise,
        params=_cpu_tree(trainer.params.state_dict()),
        train_waves=waves, **_counts(trainer))


def _same_params(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a)


def rows_train(card: str, device: str = "cuda:0",
               n_events: int = 120_000) -> int:
    """(a): two ranks of one seed sharing one card against one process on
    it. Returns santa_merge's launches of the ranks' full runs."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch(rows_rank, ROWS_RANKS, (tmp, device, n_events),
               threads=max(1, (os.cpu_count() or 2) // ROWS_RANKS))
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rows{r}.pt"),
                            weights_only=False) for r in range(ROWS_RANKS)]
    # one process, the same legs
    one = {}
    for leg, n in (("replay", TRAIN_REPLAY_EVENTS), ("full", n_events)):
        cfg, splits, edge_feats = flagship_training(
            seed=0, n_events=n,
            dropout=ROWS_REPLAY_DROPOUT if leg == "replay" else 0.1)
        trainer = Trainer(cfg, splits, edge_feats, device=device)
        if leg == "replay":
            r, v = trainer.train_epoch(), trainer.validate()[0]
            one[leg] = dict(per_batch=r.per_batch,
                            steps=int(r.per_batch.shape[0]),
                            params=_cpu_tree(trainer.params.state_dict()),
                            memory=trainer.mem.memory.cpu().clone(),
                            val=np.asarray([v.ap, v.auc, v.acc]))
            continue
        seconds = []
        for _ in (1, 2):
            _sync(device)
            t0 = time.perf_counter()
            r = trainer.train_epoch()
            _sync(device)
            seconds.append(time.perf_counter() - t0)
        train_index = trainer.index_state.data.cpu().clone()
        phases = (*trainer.validate(), *trainer.test())
        one[leg] = dict(epoch_s=seconds, per_batch=r.per_batch,
                        train_index=train_index,
                        index_end=trainer.index_state.data.cpu().clone(),
                        eval=[p.per_batch for p in phases])
        del trainer
        gc.collect()
    rep, want = [r["replay"] for r in ranks], one["replay"]
    loss = max(float(np.abs(r["per_batch"][:, 0]
                            - want["per_batch"][:, 0]).max()) for r in rep)
    params = max(float((rep[0]["params"][k] - v).abs().max())
                 for k, v in want["params"].items())
    mem_err, mem_share = _lanes_err(rep[0]["memory"], want["memory"])
    metric = max(float(np.abs(r["val"] - want["val"]).max()) for r in rep)
    replay = dict(events=TRAIN_REPLAY_EVENTS, steps=want["steps"],
                  batch_loss_max_abs_err=loss, params_max_abs_err=params,
                  memory_max_abs_err=mem_err, memory_diff_share=mem_share,
                  val_metric_max_abs_err=metric,
                  params_bitwise_across_ranks=_same_params(
                      rep[0]["params"], rep[1]["params"]))
    print("rows replay " + json.dumps(dict(replay, card=card)), flush=True)
    assert replay["params_bitwise_across_ranks"], replay
    assert loss <= LANE_LOSS_ATOL, replay
    assert params <= 2 * cfg.lr * want["steps"], replay
    assert mem_err <= MEMORY_ATOL and mem_share <= MEMORY_DIFF_SHARE, replay
    assert metric <= LANE_METRIC_ATOL, replay

    full = [r["full"] for r in ranks]
    index_bitwise = all(
        torch.equal(f["train_index"], one["full"]["train_index"])
        and torch.equal(f["index_end"], one["full"]["index_end"])
        for f in full)
    assert index_bitwise, "a rank's index differs from the one-process run"
    assert _same_params(full[0]["params"], full[1]["params"]), (
        "the ranks' params differ")
    cuda = torch.device(device).type == "cuda"
    launches = 0
    for r, f in zip(ranks, full):
        assert r["backend"] == "gloo", r      # two ranks on one card
        _hold_counts(f, cuda, r["rank"])
        assert f["santa_waves_launches"] == 0, r["rank"]
        assert f["host_backup_bitwise"], r["rank"]
        launches += f["santa_merge_launches"]
        for e, ep in enumerate(f["epochs"], 1):
            print(f"rows rank {r['rank']} of {ROWS_RANKS} on {r['device']} "
                  f"({r['local_rows']} node rows, {r['backend']}) epoch {e}"
                  f"{' (warm-up)' if e == 1 else ''}: {ep['seconds']:.3f} s, "
                  f"{ep['waves']} waves, exchange "
                  + ", ".join(f"{k} {v['calls']} calls {v['bytes']} B "
                              f"{v['seconds']:.3f} s"
                              for k, v in ep["exchange"].items())
                  + f"; the ranks share one card, so this is no scaling "
                  f"figure  ({card})", flush=True)
        aps = [p[:, 1].mean() for p in f["eval"]["device"]["per_batch"]]
        assert all(np.isfinite(ep["per_batch"]).all()
                   for ep in f["epochs"]) and min(aps) > 0.5, aps
    res = dict(
        ranks=ROWS_RANKS, device=device, backend=ranks[0]["backend"],
        events=n_events, group_s=group_s,
        local_node_rows=[r["local_rows"] for r in ranks],
        rank_epoch_s=[[e["seconds"] for e in f["epochs"]] for f in full],
        one_process_epoch_s=one["full"]["epoch_s"],
        rank_waves=[[e["waves"] for e in f["epochs"]] for f in full],
        rank_santa_merge_launches=[f["santa_merge_launches"] for f in full],
        rank_exchange_epoch2=[f["epochs"][1]["exchange"] for f in full],
        eval={k: [dict({x: f["eval"][k][x] for x in (
            "seconds", "host_copy_s", "base_bytes", "peak_bytes",
            "peak_above_base")}, exchange=f["eval"][k]["exchange"])
            for f in full] for k in ("device", "host")},
        index_bitwise=index_bitwise, params_bitwise_across_ranks=True,
        host_backup_bitwise=True, lane_replay=replay,
        full_epoch2=_divergence(full[0]["epochs"][1]["per_batch"][:, None],
                                one["full"]["per_batch"][:, None]),
        card=card)
    print("rows train " + json.dumps(res), flush=True)
    return launches


def _tensor_leaves(tree) -> list:
    """Every tensor of a nested state file's tree, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree, key=str) for t in
                _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return []


def rows_cli(card: str, device: str = "cuda:0",
             n_events: int = ROWS_CLI_EVENTS) -> int:
    """(b): the CLI's one-seed form on two ranks, its resume and its state
    file served, against one process. Returns santa_merge's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_bench_dataset(root, n_events)
        base = ["-d", "bench", "--data_dir", str(root), *ROWS_FLAGS,
                "--device", device]
        run = lambda tag, *extra: [*base, "--checkpoint_dir",
                                   str(root / tag), "--log_dir",
                                   str(root / f"log_{tag}"), *extra]
        sharded = ["--n_devices", str(ROWS_RANKS)]
        a, a_s = _cli_ranks(run("a", "--n_epoch", "2", *sharded), root, "a")
        b1, _ = _cli_ranks(run("b1", "--n_epoch", "1", *sharded), root, "b1")
        states = lambda tag: sorted((root / tag).glob("*.state.ckpt"))
        b1_state, = states("b1")
        b2, b2_s = _cli_ranks(run("b2", "--n_epoch", "2", *sharded,
                                  "--resume_state", str(b1_state)),
                              root, "b2")
        a_state, = states("a")
        b2_state, = states("b2")
        assert a_state.name == b2_state.name and "_par_" not in a_state.name
        logs = list((root / "log_a" / "bench").iterdir())
        assert len(logs) == 1 and "Test statistics" in logs[0].read_text()
        resume_bitwise = all(torch.equal(x, y) for x, y in zip(
            _tensor_leaves(load_checkpoint(str(a_state))),
            _tensor_leaves(load_checkpoint(str(b2_state))))) and (
                a[0]["results"] == b2[0]["results"])
        assert resume_bitwise, (a[0]["results"], b2[0]["results"])
        _, edge_feats = load_feat("bench", str(root))
        ns = Config.arg_parser().parse_args(run("c", "--n_epoch", "2"))
        one = Trainer(Config.from_dict(vars(ns)), get_data("bench",
                                                           str(root)),
                      edge_feats, device=device)
        one.restore_state(str(a_state))
        live = LinkPredictor.from_trainer(one)
        served = LinkPredictor.from_checkpoint(
            str(a_state), edge_feats=edge_feats, device=device)
        te = one.splits.test
        q = (te.sources[:DEPLOY_SCORE_B], te.destinations[:DEPLOY_SCORE_B],
             te.timestamps[:DEPLOY_SCORE_B])
        obs = (te.sources[-DEPLOY_OBSERVE_B:],
               te.destinations[-DEPLOY_OBSERVE_B:],
               te.timestamps[-DEPLOY_OBSERVE_B:],
               te.edge_idxs[-DEPLOY_OBSERVE_B:])
        _reset_counts()
        scores = []
        for pred in (served, live):
            first = pred.score(*q)
            pred.observe(*obs)
            scores.append((first, pred.score(*q)))
        serve_scans = scan.SANTA_SCAN.launches
        serve_bitwise = all(np.array_equal(x, y) for x, y in zip(*scores))
        assert serve_bitwise and np.isfinite(scores[0][0]).all()
        state_bytes = a_state.stat().st_size
    launches = 0
    for tag, ranks in (("a", a), ("b1", b1), ("b2", b2)):
        launches += sum(r["santa_merge_launches"] for r in ranks)
    res = dict(ranks=ROWS_RANKS, device=device, events=n_events,
               uninterrupted_s=a_s, resumed_s=b2_s,
               rank_epochs=[r["epochs"] for r in a],
               rank_santa_merge_launches={tag: [r["santa_merge_launches"]
                                                for r in ranks]
                                          for tag, ranks in (("a", a),
                                                             ("b1", b1),
                                                             ("b2", b2))},
               state_file=a_state.name, state_file_bytes=state_bytes,
               resume_bitwise=resume_bitwise,
               served_vs_one_process_bitwise=serve_bitwise,
               serve_santa_scan_launches=serve_scans,
               results=a[0]["results"], card=card)
    print("rows cli " + json.dumps(res), flush=True)
    return launches


def rows_align_rank(out: str, device: str, n_events: int) -> None:
    """(c), one rank: each schedule's waves over a train epoch of the
    120,000-event Wikipedia-shaped stream (the host's plans of the epoch's
    negatives); one epoch and validate() of the plain and the interleaved
    run on the first ``n_events``, their gathered index and tables and
    state files."""
    legs = {"plain": dict(owner_aligned_waves=False),
            "aligned": dict(owner_aligned_waves=True,
                            interleave_node_ids=False),
            "interleaved": dict(owner_aligned_waves=True)}
    res = {}
    for name, kw in legs.items():
        cfg, splits, edge_feats = wikipedia_attention(
            seed=0, n_devices=ROWS_RANKS, **ROWS_TPPR, **kw)
        t = Trainer(cfg.replace(checkpoint_dir=out), splits, edge_feats,
                    device=device)
        plans = t._wave_plans("train", t._draw_train_negs(0),
                              range(t._streams["train"].n_chunks))
        res[name] = dict(full_stream_waves=sum(p.n_waves
                                               for p in plans.values()),
                         wave_shards=t._wave_shards,
                         interleave_shards=t.cfg.interleave_shards)
        del t
        if name == "aligned":
            continue
        cfg, splits, edge_feats = wikipedia_attention(
            seed=0, n_events=n_events, n_devices=ROWS_RANKS, **ROWS_TPPR,
            **kw)
        t = Trainer(cfg.replace(checkpoint_dir=out), splits, edge_feats,
                    device=device)
        _reset_counts()
        tr = t.train_epoch()
        val, nn_val = t.validate()
        mem, index = t.gathered_state()
        path = os.path.join(out, f"{name}.state.ckpt")
        t.save_state(path)
        res[name].update(waves=tr.waves, train_ap=tr.ap, val_ap=val.ap,
                         nn_val_ap=nn_val.ap, index=index.data.cpu().clone(),
                         memory=mem.memory.cpu().clone(), path=path,
                         n_nodes=t.cfg.n_nodes,
                         **_counts(t))
    torch.save(res, os.path.join(out, f"align{t.mesh.rank}.pt"))


def _unpermute_index(index: torch.Tensor, n_shards: int, m: int,
                     k: int) -> torch.Tensor:
    """An index trained on interleaved ids → the raw id space: row v is
    the permuted run's row perm[v], its neighbor ids mapped back through
    the inverse (padding 0 stays 0)."""
    n = index.shape[0]
    perm = torch.from_numpy(interleave_permutation(n, n_shards).astype(
        np.int64))
    inv = torch.from_numpy(interleave_inverse(n, n_shards).astype(np.int64))
    rows = index[perm]
    fields = rows[:, : 4 * m * k].reshape(n, m, 4, k).clone()
    fields[:, :, 1] = inv[fields[:, :, 1].to(torch.int64)].to(torch.float32)
    return torch.cat([fields.reshape(n, -1), rows[:, 4 * m * k:]], dim=1)


def rows_align(card: str, device: str = "cuda:0",
               n_events: int = ROWS_WIKI_EVENTS) -> int:
    """(c): aligned waves and the interleave. Returns santa_merge's
    launches."""
    with tempfile.TemporaryDirectory() as tmp:
        launch(rows_align_rank, ROWS_RANKS, (tmp, device, n_events),
               threads=max(1, (os.cpu_count() or 2) // ROWS_RANKS))
        ranks = [torch.load(os.path.join(tmp, f"align{r}.pt"),
                            weights_only=False) for r in range(ROWS_RANKS)]
        r0 = ranks[0]
        plain, il = r0["plain"], r0["interleaved"]
        assert (plain["wave_shards"], r0["aligned"]["wave_shards"],
                il["wave_shards"]) == (1, ROWS_RANKS, ROWS_RANKS)
        assert (r0["aligned"]["interleave_shards"],
                il["interleave_shards"]) == (0, ROWS_RANKS)
        back = _unpermute_index(il["index"], ROWS_RANKS, len(
            ROWS_TPPR["alpha_list"]), ROWS_TPPR["topk"])
        index_bitwise = bool(torch.equal(back, plain["index"]))
        perm = torch.from_numpy(interleave_permutation(
            il["n_nodes"], ROWS_RANKS).astype(np.int64))
        mem_err = float((il["memory"][perm].float()
                         - plain["memory"].float()).abs().max())
        # the interleaved file answers external ids as the plain one does
        _, splits, edge_feats = wikipedia_attention(
            seed=0, n_events=n_events, **ROWS_TPPR)
        te = splits.test
        q = (te.sources[:DEPLOY_SCORE_B], te.destinations[:DEPLOY_SCORE_B],
             te.timestamps[:DEPLOY_SCORE_B])
        serve = lambda path: LinkPredictor.from_checkpoint(
            path, edge_feats=edge_feats, device=device)
        p_plain, p_il = serve(plain["path"]), serve(il["path"])
        got, want = p_il.score(*q), p_plain.score(*q)
        score_err = float(np.abs(got - want).max())
        obs = (te.sources[-DEPLOY_OBSERVE_B:],
               te.destinations[-DEPLOY_OBSERVE_B:],
               te.timestamps[-DEPLOY_OBSERVE_B:],
               te.edge_idxs[-DEPLOY_OBSERVE_B:])
        p_plain.observe(*obs)
        p_il.observe(*obs)
        observed_err = float(np.abs(p_il.score(*q) - p_plain.score(*q)).max())
    launches = sum(r[leg]["santa_merge_launches"] for r in ranks
                   for leg in ("plain", "interleaved"))
    cuda = torch.device(device).type == "cuda"
    for r in ranks:
        for leg in ("plain", "interleaved"):
            _hold_counts(r[leg], cuda, leg)
            assert r[leg]["santa_waves_launches"] == 0, leg
    res = dict(
        ranks=ROWS_RANKS, device=device,
        full_stream_train_waves={k: r0[k]["full_stream_waves"]
                                 for k in ("plain", "aligned",
                                           "interleaved")},
        cut_events=n_events,
        cut_train_waves={k: r0[k]["waves"] for k in ("plain",
                                                     "interleaved")},
        cut_train_ap={k: r0[k]["train_ap"] for k in ("plain",
                                                     "interleaved")},
        cut_val_ap={k: r0[k]["val_ap"] for k in ("plain", "interleaved")},
        interleaved_index_unpermuted_bitwise=index_bitwise,
        interleaved_memory_unpermuted_max_abs_err=mem_err,
        served_external_ids_max_abs_err=score_err,
        served_after_observe_max_abs_err=observed_err, card=card)
    print("rows align " + json.dumps(res), flush=True)
    assert index_bitwise, res
    assert score_err <= SCORE_ATOL and observed_err <= SCORE_ATOL, res
    return launches


def _leg_config(name: str, n_devices: int):
    """Leg ``name`` of (e)-(g) (:data:`ROWS_LEGS`): (cfg, splits,
    edge_feats) over ``n_devices`` ranks."""
    build, n_events, kw = ROWS_LEGS[name]
    return build(seed=0, n_events=n_events, n_devices=n_devices,
                 **ROWS_LEG_TABLES, **kw)


class _Scores:
    """Every batch's (pos, neg) probabilities [2, b] as a phase's metrics
    read them (``train/phase.py``'s accuracy, whole batches, in one process
    and after a row-sharded phase's gather), while the context is open."""

    def __init__(self):
        self.rows = []

    def __enter__(self):
        self._acc = phase_mod.masked_rank_acc

        def spy(pos, neg, valid):
            self.rows.append(torch.stack([pos, neg]).detach().cpu())
            return self._acc(pos, neg, valid)

        phase_mod.masked_rank_acc = spy
        return self

    def __exit__(self, *exc):
        phase_mod.masked_rank_acc = self._acc


def _rows_leg_run(trainer: Trainer) -> dict:
    """A train epoch, then validate() + test() with the device's
    allocation peak: per-batch metrics and probabilities, seconds, the
    santa launches, the exchange's counts (two ranks), the gathered tables
    and params. The one-process Trainer runs its batches eagerly: the
    scores' spy reads every batch in Python, which a batch replayed from
    the CUDA graphs (``train/graphs.py``) does not pass through."""
    dev = trainer.device
    cuda = dev.type == "cuda"
    trainer._graphs = None
    _reset_counts()
    ex = trainer.exchange
    if ex is not None:
        ex.reset_stats()
    scores = _Scores()
    _sync(dev)
    t0 = time.perf_counter()
    with scores:
        tr = trainer.train_epoch()
    _sync(dev)
    train_s = time.perf_counter() - t0
    # an overflowing epoch ran twice: its result is the rerun's
    del scores.rows[: -trainer._streams["train"].n_batches]
    train_exchange = None if ex is None else _exchange(trainer)
    train_ids = None if ex is None else {k: list(v)
                                         for k, v in ex.ids.items()}
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    t0 = time.perf_counter()
    with scores:
        phases = (tr, *trainer.validate(), *trainer.test())
    _sync(dev)
    eval_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    mem, _ = trainer.gathered_state()
    return dict(
        per_batch=[p.per_batch for p in phases], train_s=train_s,
        eval_s=eval_s, eval_peak_above_base=peak - base,
        waves=[p.waves for p in phases], **_counts(trainer),
        train_exchange=train_exchange, train_ids=train_ids,
        fallback=trainer._lazy_fallback, scores=torch.stack(scores.rows),
        mem={k: v.cpu().clone() for k, v in mem._asdict().items()},
        params=_cpu_tree(trainer.params.state_dict()))


def rows_legs_rank(out: str, device: str) -> None:
    """(e)-(g), one rank: every leg of :data:`ROWS_LEGS` in turn, what the
    parent compares to ``out/legs<r>.pt``."""
    res = {}
    for name in ROWS_LEGS:
        cfg, splits, edge_feats = _leg_config(name, ROWS_RANKS)
        trainer = Trainer(cfg.replace(checkpoint_dir=out), splits,
                          edge_feats, device=device)
        res[name] = _rows_leg_run(trainer)
        res[name]["local_rows"] = int(trainer.mem.memory.shape[0])
        rank = trainer.mesh.rank
        del trainer
        gc.collect()
    torch.save(res, os.path.join(out, f"legs{rank}.pt"))


def _leg_errors(ranks, one) -> dict:
    """A leg's ranks against one process: the probabilities' and the
    memory's largest errors, the per-batch losses' largest error relative
    to 1 + |loss|, the params' largest error and whether they are
    bit-equal across ranks; AP, AUC and accuracy's largest error and the
    count of entries past 1e-6 (reported: an ulp breaks f32 ties)."""
    probs = max(float((r["scores"] - one["scores"]).abs().max())
                for r in ranks)
    loss, metric, past = 0.0, 0.0, 0
    for r in ranks:
        for got, want in zip(r["per_batch"], one["per_batch"]):
            assert got.shape == want.shape
            err = np.abs(got - want)
            loss = max(loss, float((err[:, 0] / (1 + np.abs(want[:, 0])))
                                   .max()))
            metric = max(metric, float(err[:, 1:].max()))
            past += int((err[:, 1:] > ROWS_LEG_ATOL).sum())
    mem = max(float((ranks[0]["mem"][k].float() - v.float()).abs().max())
              for k, v in one["mem"].items())
    params = max(float((ranks[0]["params"][k] - v).abs().max())
                 for k, v in one["params"].items())
    return dict(probs_max_abs_err=probs, loss_rel_err=loss,
                memory_max_abs_err=mem, params_max_abs_err=params,
                params_bitwise_across_ranks=_same_params(
                    ranks[0]["params"], ranks[1]["params"]),
                metric_max_abs_err=metric, metrics_past_bar=past)


def rows_legs(card: str, device: str = "cuda:0") -> int:
    """(e)-(g): the options beyond the flagship's on two ranks of one seed
    sharing the card, each against one process on it. Returns
    santa_merge's launches of the ranks' runs."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch(rows_legs_rank, ROWS_RANKS, (tmp, device),
               threads=max(1, (os.cpu_count() or 2) // ROWS_RANKS))
        group_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"legs{r}.pt"),
                            weights_only=False) for r in range(ROWS_RANKS)]
    cuda = torch.device(device).type == "cuda"
    launches, out, failed = 0, {}, []
    for name in ROWS_LEGS:
        cfg, splits, edge_feats = _leg_config(name, 1)
        one_t = Trainer(cfg, splits, edge_feats, device=device)
        one = _rows_leg_run(one_t)
        del one_t
        gc.collect()
        _hold_counts(one, cuda, (name, "one process"))
        rs = [r[name] for r in ranks]
        streaming = cfg.keeps_tppr_index
        for r in rs:
            _hold_counts(r, cuda, name)
            assert r["santa_waves_launches"] == 0, name
            assert (r["index_sharded_waves"] > 0) == streaming, name
            launches += r["santa_merge_launches"]
        errs = _leg_errors(rs, one)
        fetched, named = rs[0]["train_ids"]["tower_fetch"]
        n_batches = rs[0]["per_batch"][0].shape[0]
        leg = dict(
            leg=name, events=ROWS_LEGS[name][1], ranks=ROWS_RANKS,
            local_node_rows=[r["local_rows"] for r in rs],
            rank_train_s=[r["train_s"] for r in rs], one_process_train_s=one[
                "train_s"], rank_eval_s=[r["eval_s"] for r in rs],
            rank_eval_peak_above_base=[r["eval_peak_above_base"]
                                       for r in rs],
            one_process_eval_peak_above_base=one["eval_peak_above_base"],
            train_waves=[r["waves"][0] for r in rs],
            rank_santa_merge_launches=[r["santa_merge_launches"]
                                       for r in rs],
            one_process_santa_waves_launches=one["santa_waves_launches"],
            train_exchange=[r["train_exchange"] for r in rs],
            tower_fetch_rows_per_batch=fetched / n_batches / ROWS_RANKS,
            tower_fetch_ids_named_per_batch=named / n_batches / ROWS_RANKS,
            overflow_rerun=rs[0]["fallback"], **errs, card=card)
        print("rows leg " + json.dumps(leg), flush=True)
        out[name] = (leg, rs, one)
        held = dict(
            params_bitwise=errs["params_bitwise_across_ranks"],
            probs=errs["probs_max_abs_err"] <= ROWS_LEG_DRIFT_ATOL,
            loss=errs["loss_rel_err"] <= ROWS_LEG_ATOL,
            memory=errs["memory_max_abs_err"] <= ROWS_LEG_DRIFT_ATOL,
            finite=all(np.isfinite(p).all() for r in rs
                       for p in r["per_batch"]))
        failed += [f"{name}: {k}" for k, ok in held.items() if not ok]
    assert not failed, failed
    # the overflowing cap's rerun is per-position training, bit for bit
    over, plain = out["lazy_overflow"][1], out["per_position"][1]
    for a, b in zip(over, plain):
        assert a["fallback"] and not b["fallback"]
        assert all(np.array_equal(x, y) for x, y in zip(a["per_batch"],
                                                        b["per_batch"]))
        assert all(torch.equal(a["mem"][k], b["mem"][k]) for k in a["mem"])
        assert _same_params(a["params"], b["params"])
    attn = out["graph_attention"][0]
    print("rows legs " + json.dumps(dict(
        group_s=group_s, overflow_rerun_bitwise=True,
        attention_fetch_rows_per_block_batch=attn[
            "tower_fetch_rows_per_batch"],
        attention_ids_named_per_block_batch=attn[
            "tower_fetch_ids_named_per_batch"],
        card=card)), flush=True)
    return launches


def rows_node_cli(card: str, device: str = "cuda:0",
                  n_events: int = ROWS_CLI_EVENTS) -> int:
    """(h): the CLI's ``--n_devices 2 --task node`` fit on two ranks, its
    state file served, and the node AUCs against one process's replay from
    that file. Returns the ranks' santa_merge and santa_waves launches."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_bench_dataset(root, n_events)
        argv = ["-d", "bench", "--data_dir", str(root), *ROWS_FLAGS,
                "--device", device, "--checkpoint_dir", str(root / "h"),
                "--log_dir", str(root / "log_h"), "--n_epoch", "1",
                "--task", "node", "--n_devices", str(ROWS_RANKS)]
        ranks, fit_s = _cli_ranks(argv, root, "h")
        res = ranks[0]["results"]
        state, = sorted((root / "h").glob("*.state.ckpt"))
        _, edge_feats = load_feat("bench", str(root))
        ns = Config.arg_parser().parse_args(argv[:-2])
        one = Trainer(Config.from_dict(vars(ns)),
                      get_data("bench", str(root)), edge_feats,
                      device=device)
        one.restore_state(str(state))
        node = run_node_classification(one, n_steps=one.cfg.node_decoder_steps,
                                       lr=one.cfg.node_decoder_lr,
                                       seed=one.cfg.seed)
        live = LinkPredictor.from_trainer(one)
        served = LinkPredictor.from_checkpoint(
            str(state), edge_feats=edge_feats, device=device)
        te = one.splits.test
        q = (te.sources[:DEPLOY_SCORE_B], te.destinations[:DEPLOY_SCORE_B],
             te.timestamps[:DEPLOY_SCORE_B])
        serve_bitwise = bool(np.array_equal(served.score(*q),
                                            live.score(*q)))
    aucs = {k: res[k] for k in node}
    auc_err = max(abs(aucs[k] - v) for k, v in node.items())
    out = dict(ranks=ROWS_RANKS, device=device, events=n_events,
               fit_s=fit_s, node_aucs=aucs, one_process_replay_aucs=node,
               auc_max_abs_err=auc_err, served_vs_one_process_bitwise=(
                   serve_bitwise),
               rank_santa_merge_launches=[r["santa_merge_launches"]
                                          for r in ranks],
               rank_santa_waves_launches=[r["santa_waves_launches"]
                                          for r in ranks],
               rank_index_waves=[r["index_waves"] for r in ranks],
               card=card)
    print("rows node " + json.dumps(out), flush=True)
    assert all(np.isfinite(v) for v in aucs.values()), out
    assert auc_err <= ROWS_LEG_ATOL and serve_bitwise, out
    return (sum(r["santa_merge_launches"] for r in ranks),
            sum(r["santa_waves_launches"] for r in ranks))


def rows_guard(card: str, device: str = "cuda") -> None:
    """(d): the guard's decisions for one seed at Wiki-Talk's node count
    over ROWS_GUARD_DEVICES ranks, on this card's free memory."""
    free, _ = torch.cuda.mem_get_info(device)
    cfg, _, _ = flagship_training(seed=0, n_events=10)
    cfg = cfg.replace(n_nodes=WIKI_TALK_NODES, edge_dim=1)
    out = []
    for d in ROWS_GUARD_DEVICES:
        rows = WIKI_TALK_NODES // d
        b = mb.budget(cfg, 1, free, rows)
        out.append(dict(devices=d, rows_per_rank=rows, auto=b.decide(None),
                        device_protocol=b.decide(False),
                        host_backup=b.decide(True),
                        device_gib=b.device / 2**30, host_gib=b.host / 2**30,
                        usable_gib=b.usable / 2**30))
    print("rows guard " + json.dumps(dict(
        n_nodes=WIKI_TALK_NODES, seeds=1, row_bytes=mb.row_bytes(cfg),
        index_row_bytes=mb.index_bytes(cfg, 1), free_bytes=free,
        decisions=out, card=card)), flush=True)


def rows_phase(card: str):
    """Phase 14 (module docstring). Returns santa_merge's launches of its
    main path (every rank's) and santa_waves' (the ranks' node replays in
    (h), which run at full N with no exchange)."""
    t0 = time.perf_counter()
    launches = rows_train(card)
    launches += rows_cli(card)
    launches += rows_align(card)
    rows_guard(card)
    launches += rows_legs(card)
    node_merges, node_waves = rows_node_cli(card)
    launches += node_merges
    print(f"rows phase: {time.perf_counter() - t0:.1f} s  ({card})",
          flush=True)
    return launches, node_waves


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an unpacked git archive of a commit with the "
                    "serial santa_scan (4881985): time it beside the "
                    "cluster design in the scan and fill phases")
    args = ap.parse_args()
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
    sources = build.SOURCES + build.HOST_SOURCES
    logs = build.build(sources)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(sources)}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    parent = None if args.parent is None else parent_scan(args.parent)
    merges = merge_phase(card)
    scans = scan_phase(card, parent)
    waves = waves_kernel_phase(card, scans[0]["us_per_level"])
    scan_launches, gpu, cols = serve_phase(card)
    wave_phase(gpu, cols, card)
    fill_phase(gpu.cfg, cols, card, parent)
    single_index, flagship_epoch_s = train_phase(card)
    fit_waves = fit_phase(card)
    seed_waves, seed_scans, seed_merge = seeds_phase(card, single_index)
    prune_phase(card)
    towers_phase(card)
    option_waves, option_scans = options_phase(card, flagship_epoch_s)
    shard_waves, shard_merge = shard_phase(card)
    row_merges, row_waves = rows_phase(card)

    def entry(name, results, main, launches):
        return dict(
            name=name, route="cuda",
            source=f"zebra_tpu_torch/csrc/{name}.cu",
            replaces="zebra_tpu/index/pallas_merge.py:43",
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in results),
            **{key: main[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")})

    # each kernel at the shape its path gives it: a training wave for
    # santa_merge (launches: phase 14's row-sharded ranks), a b = 200
    # observe for santa_scan (launches: the serve phase, the ensemble's
    # observe calls and the options predictor's extracting ones), a train
    # superchunk for santa_waves (launches: the CLI's fit run, the
    # seed-parallel Trainer's and the options Trainer's epochs and eval
    # phases, phase 13's ranks, one-process runs and host-backup leg, and
    # the node replays of phase 14 (h)'s ranks)
    print(json.dumps({"kernels": [
        entry("santa_merge", merges + [seed_merge, shard_merge], merges[1],
              row_merges),
        entry("santa_scan", scans, scans[0],
              scan_launches + seed_scans + option_scans),
        entry("santa_waves", waves, waves[0],
              fit_waves + seed_waves + option_waves + shard_waves
              + row_waves),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
