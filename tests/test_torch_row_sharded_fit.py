"""The row-sharded run's ``fit``, state files, serving and guard (one seed
over D = 2 CPU ranks, tests/torch_rank_worker.py, one spawned group for
the module), and the CLI's one-command form (``--n_devices 2 --device
cpu`` without ``--parallel_runs``).

Bars: a fit resumed from an epoch-1 state file ends bit-equal to the
uninterrupted fit; rank 0's state file holds the one-process layout (the
ranks' rows in order) and name, restores into a one-process Trainer bit
for bit and into another two-rank Trainer that trains on alike; served by
``from_checkpoint`` it scores bit-equal to ``from_trainer`` of the
one-process Trainer restored from it; the params are bit-equal across
ranks; the guard counts N/D rows per rank."""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_cli import _argv, _toy
from tests.torch_rank_worker import SMALL, run_group, splits, trainer
from zebra_tpu_torch import cli
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.serve import LinkPredictor
from zebra_tpu_torch.train import memory_budget as mb
from zebra_tpu_torch.train.checkpoint import load_checkpoint


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_group(["rows_resume", "rows_state"],
                     tmp_path_factory.mktemp("rows_fit"))


def test_resume_from_epoch_one_is_bit_equal(ranks):
    for r in ranks["rows_resume"]:
        assert r["out"] == r["ref"]
        assert r["params_equal"] and r["mem_equal"] and r["index_equal"]
    r0, r1 = ranks["rows_resume"]
    assert r0["out"] == r1["out"]          # every rank decides alike
    for k, v in r0["rank_params"].items():
        assert torch.equal(v, r1["rank_params"][k]), k
    saved = load_checkpoint(r0["state"])   # the resumed fit's last save
    assert saved["epoch"] == 2 and saved["chunk"] == 0


def test_state_file_has_the_one_process_layout(ranks):
    r0, r1 = ranks["rows_state"]
    path = r0["path"]
    assert path == r1["path"]
    tree = load_checkpoint(path)
    for k, v in tree["mem"].items():       # every rank's rows, in order
        assert v.shape[0] == 128 and torch.equal(v, r0["mem"][k]), k
    assert torch.equal(tree["index_state"], r0["index"])
    assert tree["cfg"]["n_devices"] == 2 and tree["cfg"]["n_nodes"] == 128


def test_state_file_restores_on_two_ranks(ranks):
    assert all(r["restored_equal"] for r in ranks["rows_state"])


def test_state_file_restores_into_one_process_and_serves(ranks, tmp_path):
    path = ranks["rows_state"][0]["path"]
    one = trainer(str(tmp_path))
    one.restore_state(path)
    saved = load_checkpoint(path)
    for k, v in one.mem._asdict().items():
        assert torch.equal(v, saved["mem"][k]), k
    assert torch.equal(one.index_state.data, saved["index_state"])
    sp, ef = splits()
    te = sp.test
    q = (te.sources[:64], te.destinations[:64], te.timestamps[:64])
    served = LinkPredictor.from_checkpoint(path, edge_feats=ef, device="cpu")
    live = LinkPredictor.from_trainer(one)
    np.testing.assert_array_equal(served.score(*q), live.score(*q))
    obs = (te.sources[-16:], te.destinations[-16:], te.timestamps[-16:],
           te.edge_idxs[-16:])
    served.observe(*obs)
    live.observe(*obs)
    np.testing.assert_array_equal(served.score(*q), live.score(*q))


@pytest.mark.parametrize("devices", [1, 2, 4])
def test_guard_counts_a_ranks_rows(devices):
    """One seed over D ranks: the guard's tables and index are N/D rows'
    (the JAX guard's ceil(N/D), ``zebra_tpu/train/loop.py:607-622``)."""
    cfg = Config(**SMALL).replace(n_nodes=1_140_096, edge_dim=1)
    rows = 1_140_096 // devices
    b = mb.budget(cfg, 1, 80 * 2**30, rows)
    assert b.tables == rows * mb.row_bytes(cfg)
    assert mb.index_bytes(cfg, rows) == rows * 2 * (4 * 5 + 1) * 4
    whole = mb.budget(cfg, 1, 80 * 2**30)
    assert b.device < whole.device or devices == 1


def test_cli_two_local_ranks_one_seed(tmp_path):
    """``--n_devices 2 --device cpu`` with one seed: two ranks started by
    the command, one log with the ``epoch:`` and ``Test statistics:``
    lines, one state file named as the one-process run's, which serves."""
    _toy(tmp_path)
    (trainer_, res), = cli.main(_argv(
        tmp_path, "toy", "--n_epoch", "2", "--state_every", "1",
        "--n_devices", "2"))
    assert trainer_ is None and "test_ap" in res and "per_seed" not in res
    logs = os.listdir(tmp_path / "log" / "toy")
    assert len(logs) == 1 and not logs[0].endswith("_par_2")
    text = (tmp_path / "log" / "toy" / logs[0]).read_text()
    assert "epoch: 2," in text and "row exchange: 2 ranks" in text
    assert text.count("Test statistics: Old nodes") == 1
    states = [f for f in os.listdir(tmp_path / "ckpt")
              if f.endswith(".state.ckpt")]
    assert states == [logs[0] + ".state.ckpt"]
    path = str(tmp_path / "ckpt" / states[0])
    assert load_checkpoint(path)["cfg"]["n_devices"] == 2
    pred = LinkPredictor.from_checkpoint(
        path, edge_feats=np.load(tmp_path / "toy" / "ml_toy.npy"),
        device="cpu")
    assert np.isfinite(pred.score([1, 2], [41, 42], [1e6, 1e6])).all()
