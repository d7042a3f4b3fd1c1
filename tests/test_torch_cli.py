"""The port's training CLI (zebra_tpu_torch/cli.py, ``python -m
zebra_tpu_torch.train``) on the CPU, after tests/test_cli.py and
tests/test_preemption.py: datasets written by the port's preprocessor (no
pandas), a run end to end with its log file, ``--task node``, ``--n_runs``,
``--parallel_runs`` with ``--parallel_lr``, logging and signal handlers
restored after each in-process call, and a SIGTERM to a running process
that writes a state file which ``--resume_state`` finishes."""

import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu_torch import cli
from zebra_tpu_torch.data import preprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--bs", "50", "--node_dim", "16", "--time_dim", "16",
         "--memory_dim", "16", "--topk", "4", "--alpha_list", "0.1", "0.1",
         "--beta_list", "0.05", "0.95", "--index_chunk", "400",
         "--lr", "0.003", "--device", "cpu"]


def _toy(root, name="toy", n=600, seed=0, labels=False):
    """A JODIE CSV preprocessed by the port: 40 users, 40 items, two
    features; labels follow a third of the users when ``labels``."""
    rng = np.random.RandomState(seed)
    d = root / name
    d.mkdir(parents=True)
    flagged = rng.rand(40) < 0.3
    with open(d / f"{name}.csv", "w") as f:
        f.write("u,i,ts,label,f0,f1\n")
        users = np.concatenate([np.arange(40), rng.randint(0, 40, n - 40)])
        items = np.concatenate([np.arange(40), rng.randint(0, 40, n - 40)])
        for k in range(n):
            label = int(flagged[users[k]]) if labels else 0
            f.write(f"{users[k]},{items[k]},{float(k)},{label},"
                    f"{rng.rand():.4f},{rng.rand():.4f}\n")
    preprocess.run(name, str(root), bipartite=True, fmt="jodie")


def _argv(tmp_path, name="toy", *extra):
    return ["-d", name, "--data_dir", str(tmp_path), *SMALL,
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--log_dir", str(tmp_path / "log"), *extra]


def test_cli_end_to_end(tmp_path):
    _toy(tmp_path)
    logger = logging.getLogger("zebra_tpu_torch")
    handlers = list(logger.handlers)
    sigterm = signal.getsignal(signal.SIGTERM)
    runs = cli.main(_argv(tmp_path, "toy", "--n_epoch", "2", "--patience",
                          "5", "--state_every", "1"))
    assert logger.handlers == handlers
    assert signal.getsignal(signal.SIGTERM) == sigterm
    (trainer, results), = runs
    assert {"test_ap", "test_auc", "nn_test_ap", "stop_epoch"} <= set(results)
    assert trainer.cfg.real_edge_feats and trainer.cfg.edge_dim == 2
    logs = list((tmp_path / "log" / "toy").iterdir())
    assert [p.name for p in logs] == [trainer.cfg.run_name()]
    text = logs[0].read_text()
    assert "epoch: 2" in text and "Test statistics: Old nodes" in text
    assert (tmp_path / "ckpt" / (trainer.cfg.run_name() + ".state.ckpt")
            ).exists()


def test_cli_task_node(tmp_path):
    _toy(tmp_path, labels=True)
    (trainer, results), = cli.main(_argv(
        tmp_path, "toy", "--n_epoch", "1", "--task", "node",
        "--node_decoder_steps", "50"))
    assert {"node_train_auc", "node_val_auc", "node_test_auc"} <= set(results)
    text = (tmp_path / "log" / "toy" / trainer.cfg.run_name()).read_text()
    assert "node classification auc" in text


def test_cli_n_runs_use_consecutive_seeds(tmp_path):
    _toy(tmp_path, n=300)
    runs = cli.main(_argv(tmp_path, "toy", "--n_epoch", "1", "--n_runs", "2",
                          "--seed", "5"))
    assert [t.cfg.seed for t, _ in runs] == [5, 6]


@pytest.mark.parametrize("flag", [["--parallel_runs", "2",
                                   "--fused_dispatch"],
                                  ["--n_devices", "5",
                                   "--dist_num_processes", "2"]])
def test_cli_refuses_what_the_port_cannot_run(tmp_path, flag):
    with pytest.raises(ValueError, match=flag[0][2:]):
        cli.main(_argv(tmp_path, "toy", *flag))


def test_cli_parallel_runs(tmp_path, caplog):
    """``--parallel_runs 3 --parallel_lr …``: one Trainer, seeds 5, 6, 7,
    per-seed log lines with mean ± σ, ``--n_runs`` superseded."""
    _toy(tmp_path)
    with caplog.at_level("WARNING", logger="zebra_tpu_torch"):
        (trainer, results), = cli.main(_argv(
            tmp_path, "toy", "--n_epoch", "1", "--seed", "5", "--n_runs",
            "2", "--parallel_runs", "3", "--parallel_lr", "0.003", "0.001",
            "0.0003"))
    assert "supersedes --n_runs 2" in caplog.text
    assert trainer.cfg.n_seeds == 3 and trainer.optimizer.lrs == (
        0.003, 0.001, 0.0003)
    per = results["per_seed"]
    assert per["lr"] == [0.003, 0.001, 0.0003] and len(per["test_ap"]) == 3
    assert results["test_ap"] == pytest.approx(np.mean(per["test_ap"]))
    text = (tmp_path / "log" / "toy" / trainer.cfg.run_name()).read_text()
    assert "train events/s (aggregate)" in text
    assert "Test statistics: Old nodes -- ap: " in text and "±" in text


def test_cli_parallel_runs_refuses_task_node(tmp_path):
    _toy(tmp_path, labels=True)
    with pytest.raises(SystemExit, match="--task node is single-seed"):
        cli.main(_argv(tmp_path, "toy", "--parallel_runs", "2", "--task",
                       "node"))


def test_cli_sigterm_then_resume(tmp_path):
    """SIGTERM to a running ``python -m zebra_tpu_torch.train`` stops it
    after the current superchunk with a state file and the resume hint; a
    ``--resume_state`` run from that file completes."""
    _toy(tmp_path, n=4000)
    args = [sys.executable, "-m", "zebra_tpu_torch.train",
            *_argv(tmp_path, "toy", "--n_epoch", "50", "--patience", "50")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline, lines = time.time() + 120, []
    for line in proc.stdout:
        lines.append(line)
        if "epoch: 1," in line or time.time() > deadline:
            break
    proc.send_signal(signal.SIGTERM)
    try:
        out, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    text = "".join(lines) + (out or "")
    assert proc.returncode == 0, text[-2000:]
    assert "stopping at the next superchunk boundary" in text, text[-2000:]
    assert "resume with --resume_state" in text, text[-2000:]
    states = [p for p in (tmp_path / "ckpt").iterdir()
              if p.name.endswith(".state.ckpt")]
    assert len(states) == 1
    done = subprocess.run(args + ["--n_epoch", "2", "--resume_state",
                                  str(states[0])],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    assert "Test statistics" in done.stdout + done.stderr
