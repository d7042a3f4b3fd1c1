"""The port's process group and mesh (zebra_tpu_torch/parallel/): the
``ZEBRA_*`` fallbacks of ``initialize_distributed`` and its error without a
coordinator (tests/test_multiprocess.py:78-95), rank 0's negative bases on
every rank under ``enable_random``, the lanes each rank owns and the mesh's
checks (tests/test_seed_sharded.py:246), and a run whose two processes the
caller started (``--dist_*``, a coordinator on localhost)."""

import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_cli import ROOT, _argv, _toy
from tests.torch_rank_worker import S, fail_on_rank_one, run_group, trainer
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.parallel import distributed
from zebra_tpu_torch.parallel.launch import launch
from zebra_tpu_torch.parallel.mesh import make_mesh, rank_device
from zebra_tpu_torch.parallel.sharding import local_lanes


def test_initialize_distributed_env_fallbacks(monkeypatch):
    for var in ("ZEBRA_NUM_PROCESSES", "ZEBRA_COORDINATOR",
                "ZEBRA_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_distributed(None, 1, 0) is False
    monkeypatch.setenv("ZEBRA_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize_distributed(None, 1, 0)
    assert distributed.world_size() == 1 and distributed.rank() == 0


def test_rank_zero_negative_bases_win_under_enable_random(tmp_path):
    r0, r1 = run_group(["random_bases"], tmp_path)["random_bases"]
    assert not np.array_equal(r0["own"], r1["own"])   # unseeded draws differ
    for r in (r0, r1):
        np.testing.assert_array_equal(r["broadcast"], r0["own"])
    want = np.random.RandomState(100).randint(0, 2**31 - 1, S)
    np.testing.assert_array_equal(
        np.concatenate([r0["neg_base"], r1["neg_base"]]), want)
    assert (r0["lanes"], r1["lanes"]) == ([0, 1], [2, 3])


def test_a_failing_rank_fails_the_launch():
    """A rank that raises ends the launch with an error (its own, or the
    broken collective of the rank that waited for it), and no rank is left
    hanging."""
    t0 = time.time()
    with pytest.raises(mp.ProcessRaisedException):
        launch(fail_on_rank_one, 2, threads=1)
    assert time.time() - t0 < 60


def test_local_lanes():
    assert [local_lanes(4, 2, r) for r in (0, 1)] == [range(0, 2),
                                                      range(2, 4)]
    assert local_lanes(3, 1, 0) == range(3)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        local_lanes(3, 2, 0)


@pytest.mark.parametrize("kw,match", [
    (dict(parallel_runs=3, n_devices=2), "multiple of the mesh size"),
    (dict(parallel_runs=4, n_devices=2, dist_num_processes=4),
     "one process per device"),
], ids=["not_a_multiple", "processes"])
def test_mesh_config_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        Config(**kw)


@pytest.mark.parametrize("kw", [
    dict(n_devices=2, tppr_strategy="pruning"),
    dict(n_devices=0, dist_num_processes=2, aggregator="mean"),
], ids=["one_seed", "one_seed_all"])
def test_row_sharded_configs_construct(kw):
    """One seed over a mesh takes every option (the row-sharded layout
    runs them all)."""
    cfg = Config(**kw)
    assert cfg.n_seeds == 1


def test_make_mesh_rules(tmp_path):
    for n in (0, 1):
        mesh = make_mesh(n, "cpu")
        assert (mesh.size, mesh.rank, mesh.device) == (
            1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(2, "cpu")
    # a Trainer of two ranks needs the group of two
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        trainer(str(tmp_path), parallel_runs=4, n_devices=2)


def test_rank_device(monkeypatch):
    assert rank_device("cpu", 3) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_device("cuda", 0) == torch.device("cuda", 0)
    assert rank_device("cuda:0", 1) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="--device cuda:0"):
        rank_device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rank_device(None, 0)


def test_processes_started_by_the_caller(tmp_path):
    """Two ``python -m zebra_tpu_torch.train`` processes joined by
    ``--dist_*`` (rank 1 by ``ZEBRA_PROCESS_ID``): rank 0 writes the one
    log and the ``_par_4`` state file."""
    _toy(tmp_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    argv = _argv(tmp_path, "toy", "--n_epoch", "1", "--state_every", "1",
                 "--parallel_runs", "4", "--n_devices", "2",
                 "--dist_coordinator", f"localhost:{port}",
                 "--dist_num_processes", "2")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "zebra_tpu_torch.train", *argv],
        env=dict(env, ZEBRA_PROCESS_ID=str(r)), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    assert "Test statistics" in logs[0] and "Test statistics" not in logs[1]
    assert len(os.listdir(tmp_path / "log" / "toy")) == 1
    states = [f for f in os.listdir(tmp_path / "ckpt")
              if f.endswith("_par_4.state.ckpt")]
    assert len(states) == 1


def test_sigterm_to_the_launcher_stops_every_rank(tmp_path):
    """SIGTERM to ``python -m zebra_tpu_torch.train --n_devices 2`` reaches
    both ranks: they stop at one superchunk boundary, rank 0 writes the
    ``_par_4`` state file, and the command exits 0 with the resume hint."""
    _toy(tmp_path, n=4000)
    args = [sys.executable, "-m", "zebra_tpu_torch.train",
            *_argv(tmp_path, "toy", "--n_epoch", "50", "--patience", "50",
                   "--parallel_runs", "4", "--n_devices", "2")]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline, lines = time.time() + 120, []
    for line in proc.stdout:
        lines.append(line)
        if "epoch: 1 (" in line or time.time() > deadline:
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
              if p.name.endswith("_par_4.state.ckpt")]
    assert len(states) == 1
