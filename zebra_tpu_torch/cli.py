"""The port's training entry point (counterpart of the repo's ``train.py``):

    python -m zebra_tpu_torch.train -d wikipedia --alpha_list 0.1 --beta_list 0.9

Reads ``{data_dir}/{name}/ml_{name}.csv`` (+ ``ml_{name}.npy``), written by
``python -m zebra_tpu_torch.data.preprocess``; takes the JAX command line's
flags under the same names and defaults, plus ``--device`` (``cuda``, or
``cpu`` for the plain versions of the kernels). Logs to
``<log_dir>/<data>/<run_name>`` and to the console.

SIGTERM or SIGINT ends the run gracefully: training stops after the current
superchunk, a resumable state file is written, and the run exits;
``--resume_state <file>`` continues it exactly. A second signal falls back
to the previous handler.

``--parallel_runs S`` trains seeds ``--seed`` … ``--seed + S - 1`` in one
pass (one Trainer, one shared index scan) and logs per-seed results with
their mean ± σ; ``--parallel_lr`` gives each seed its own lr. It supersedes
``--n_runs``; ``--task node`` is single-seed and refused with it.

``--n_devices D`` shards those seeds over D devices, S/D whole seeds per
process; with one seed (no ``--parallel_runs``) it splits the seed's node
rows over the D devices instead (``train/loop.py``: the row-sharded
layout, with ``--owner_aligned_waves`` and ``--interleave_node_ids``).
Without ``--dist_*`` (or the ``ZEBRA_*`` variables) the command
starts D local ranks itself, rank r on ``cuda:r`` (``--device cuda:0`` puts
every rank on one card, ``--device cpu`` on the host); with them, the
caller started the processes and this one joins the group as one rank.
Rank 0 alone writes the log, the ``epoch:`` and ``Test statistics:`` lines
(over all S seeds) and the state files, in the one-process run's layout and
name. A rank that fails makes the command exit non-zero. The row-sharded
ranks exchange rows over NCCL where each has a card of its own, over Gloo
where they share one (``--device cuda:0``) or run on the CPU."""

from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import tempfile
import time
from typing import List, Optional, Tuple

import torch

from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import get_data, load_feat
from zebra_tpu_torch.device import resolve_device
from zebra_tpu_torch.parallel.distributed import (
    initialize_distributed,
    rank,
    world_size,
)
from zebra_tpu_torch.parallel.launch import launch
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.node_classification import run_node_classification


@contextlib.contextmanager
def _graceful_sigterm(trainer: Trainer, logger: logging.Logger):
    """Route SIGTERM/SIGINT to ``trainer.request_stop`` for the duration of
    a fit; the first signal restores the previous handlers, so a second one
    acts as before."""
    prev = {}

    def handler(signum, frame):
        logger.info("signal %d: stopping at the next superchunk boundary "
                    "(send again to force)", signum)
        trainer.request_stop()
        for sig, h in prev.items():
            signal.signal(sig, h)

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, handler)
    except ValueError:  # not the main thread (embedded use)
        prev.clear()
    try:
        yield
    finally:
        for sig, h in prev.items():
            signal.signal(sig, h)


def setup_logging(cfg: Config) -> Tuple[logging.Logger, List[logging.Handler]]:
    """The ``zebra_tpu_torch`` logger with a file handler at
    ``<log_dir>/<data>/<run_name>`` (DEBUG) and a console handler (INFO);
    returns the logger and the handlers added, which the caller removes."""
    logger = logging.getLogger("zebra_tpu_torch")
    logger.setLevel(logging.DEBUG)
    os.makedirs(os.path.join(cfg.log_dir, cfg.data), exist_ok=True)
    fh = logging.FileHandler(os.path.join(cfg.log_dir, cfg.data,
                                          cfg.run_name()))
    fh.setLevel(logging.DEBUG)
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    fmt = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    for h in (fh, ch):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger, [fh, ch]


def _local_ranks(cfg: Config, device: torch.device) -> int:
    """How many ranks this command starts itself: ``--n_devices`` (0: the
    visible cards, or one on the CPU or a named card), unless the caller
    started the processes (``--dist_*`` or ``ZEBRA_*``)."""
    if (cfg.dist_coordinator or cfg.dist_num_processes > 1
            or int(os.environ.get("ZEBRA_NUM_PROCESSES", "1")) > 1):
        return 1
    if cfg.n_devices > 0:
        return cfg.n_devices
    named = device.type == "cpu" or device.index is not None
    return 1 if named else torch.cuda.device_count()


def main(argv: Optional[List[str]] = None) -> List[Tuple[Trainer, dict]]:
    """Run the command line ``argv``; returns (trainer, results) of each run
    that finished or was interrupted, for callers in the same process. A
    run on local ranks it started returns (None, rank 0's results)."""
    ns = Config.arg_parser().parse_args(argv)
    cfg = Config.from_dict(vars(ns))      # refuses what the port cannot run
    device = resolve_device(ns.device)    # raises without a card
    if cfg.task == "node" and cfg.parallel_runs > 1:
        raise SystemExit(
            "--task node is single-seed: the downstream decoder consumes one "
            "model's embeddings (drop --parallel_runs, or train seed-parallel "
            "with --task link and serve one seed via run_index)")
    n_local = _local_ranks(cfg, device)
    if n_local > 1:
        with tempfile.TemporaryDirectory(prefix="zebra_cli_") as tmp:
            out = os.path.join(tmp, "results.json")
            # the ranks share this process's intra-op threads
            launch(_rank_main, n_local, (argv, out),
                   threads=max(1, torch.get_num_threads() // n_local))
            with open(out) as f:
                return [(None, json.load(f))]
    if initialize_distributed(cfg.dist_coordinator, cfg.dist_num_processes,
                              cfg.dist_process_id) and cfg.n_devices not in (
                                  0, world_size()):
        raise ValueError(
            f"--n_devices {cfg.n_devices} in a group of {world_size()} "
            "processes: one process per device (--n_devices 0 takes them "
            "all)")
    return _main_rank(cfg, device)


def _rank_main(argv: Optional[List[str]], out: str) -> None:
    """One local rank of ``main``: rank 0 writes the results to ``out``."""
    ns = Config.arg_parser().parse_args(argv)
    runs = _main_rank(Config.from_dict(vars(ns)), resolve_device(ns.device))
    if rank() == 0:
        with open(out, "w") as f:
            json.dump(runs[-1][1], f, default=float)


def _main_rank(cfg: Config, device: torch.device):
    """The run in this process: rank 0 (or the only process) logs."""
    logger = logging.getLogger("zebra_tpu_torch")
    handlers = []
    if rank() == 0:
        logger, handlers = setup_logging(cfg)
    try:
        return _run(cfg, device, logger)
    finally:
        for h in handlers:
            logger.removeHandler(h)
            h.close()


def _run(cfg: Config, device, logger: logging.Logger):
    logger.info(cfg)
    splits = get_data(cfg.data, cfg.data_dir)
    node_feats, edge_feats = load_feat(cfg.data, cfg.data_dir)
    if cfg.ignore_node_feats:
        node_feats = None

    if cfg.parallel_runs > 1:
        # all seeds advance together in one Trainer (stacked params, one
        # shared index scan; seed-sharded: this rank's seeds): per-seed
        # results and mean ± σ in one pass
        if cfg.n_runs > 1:
            logger.warning("--parallel_runs %d supersedes --n_runs %d: all "
                           "seeds run in one pass", cfg.parallel_runs,
                           cfg.n_runs)
        t0 = time.time()
        trainer = Trainer(cfg, splits, edge_feats, node_feats, device=device)
        with _graceful_sigterm(trainer, logger):
            results = trainer.fit(resume_from=cfg.resume_state)
        if results.get("interrupted"):
            logger.info("parallel run interrupted; resume with "
                        "--resume_state %s", results["state_path"])
        else:
            logger.info("%d parallel runs finished in %.1fs: %s",
                        cfg.parallel_runs, time.time() - t0, results)
        return [(trainer, results)]

    runs = []
    for run in range(cfg.n_runs):
        t0 = time.time()
        trainer = Trainer(cfg.replace(seed=cfg.seed + run), splits,
                          edge_feats, node_feats, device=device)
        with _graceful_sigterm(trainer, logger):
            results = trainer.fit(
                resume_from=cfg.resume_state if run == 0 else None)
        runs.append((trainer, results))
        if results.get("interrupted"):
            logger.info("run %d interrupted; resume with --resume_state %s",
                        run, results["state_path"])
            return runs
        if cfg.task == "node":
            node = run_node_classification(
                trainer, n_steps=cfg.node_decoder_steps,
                lr=cfg.node_decoder_lr, seed=cfg.seed + run)
            results.update(node)
            logger.info(
                "node classification auc -- train: %f, val: %f, test: %f",
                node["node_train_auc"], node["node_val_auc"],
                node["node_test_auc"])
        logger.info("run %d finished in %.1fs: %s", run, time.time() - t0,
                    results)
    return runs
