"""The seed-sharded run's ``fit``, state files and serving (S = 4 seeds
over D = 2 CPU ranks, tests/torch_rank_worker.py, one spawned group for
the module), after tests/test_seed_sharded.py:22-47, and the CLI's
one-command form (``--parallel_runs 4 --n_devices 2 --device cpu``).

Bars: a fit resumed from its epoch-2 state file ends bit-equal to the
uninterrupted fit (``parallel_lr`` per lane); rank 0's state file has the
one-process layout and name (``…_par_4``), restores into a one-process
S = 4 Trainer bit for bit, and serves through ``from_checkpoint``
(``ensemble=True`` bit-equal to ``EnsemblePredictor.from_trainer`` of that
Trainer; ``run_index=s`` within 1e-5 of member s, a plain product against
a batched one); a file of another S is refused, one of another D is not;
a stop requested on one rank stops both at the same superchunk."""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_cli import _argv, _toy
from tests.torch_rank_worker import S, run_group, splits, trainer
from zebra_tpu_torch import cli
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor
from zebra_tpu_torch.train.checkpoint import load_checkpoint

MEMBER_ATOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_group(["resume", "serve", "stop"],
                     tmp_path_factory.mktemp("sharded_fit"))


def test_resume_from_epoch_two_is_bit_equal(ranks):
    for r in ranks["resume"]:
        assert r["out"]["per_seed"] == r["ref"]["per_seed"]
        assert r["params_equal"] and r["mem_equal"] and r["index_equal"]
        assert r["ref"]["per_seed"]["lr"] == [3e-3, 8e-4, 1e-3, 2e-3]
    assert ranks["resume"][0]["out"] == ranks["resume"][1]["out"]
    saved = load_checkpoint(ranks["resume"][0]["state"])
    assert saved["epoch"] == 2 and saved["optimizer"]["lrs"] == [
        3e-3, 8e-4, 1e-3, 2e-3]


def test_state_file_has_the_one_process_layout(ranks):
    r0, r1 = ranks["serve"]
    path = r0["path"]
    assert path == r1["path"] and path.endswith("sharded.state.ckpt")
    tree = load_checkpoint(path)
    n = r0["mem"]["memory"].shape[1]
    assert tree["params"]["fc1.w"].shape[0] == S
    assert tree["mem"]["memory"].shape[:2] == (S, n)
    assert tree["dropout"].shape[0] == S and len(tree["neg_base"]) == S
    assert len(tree["optimizer"]["exp_avg"][0]) == S
    for k, v in tree["mem"].items():   # the ranks' lanes, in order
        assert torch.equal(v, torch.cat([r0["mem"][k], r1["mem"][k]])), k
    assert torch.equal(tree["index_state"], r0["index"])


def test_sharded_state_restores_into_one_process_and_serves(ranks, tmp_path):
    path = ranks["serve"][0]["path"]
    one = trainer(str(tmp_path), parallel_runs=S)
    one.restore_state(path)
    for k, v in one._memory_tables().items():
        assert torch.equal(v, load_checkpoint(path)["mem"][k]), k
    sp, ef = splits()
    te = sp.test
    q = (te.sources[:64], te.destinations[:64], te.timestamps[:64])
    ens = LinkPredictor.from_checkpoint(path, edge_feats=ef, device="cpu",
                                        ensemble=True)
    assert isinstance(ens, EnsemblePredictor) and ens.n_models == S
    live = EnsemblePredictor.from_trainer(one)
    np.testing.assert_array_equal(ens.score(*q), live.score(*q))
    members = ens.member_scores(*q)
    for s in range(S):
        lone = LinkPredictor.from_checkpoint(path, edge_feats=ef,
                                             device="cpu", run_index=s)
        np.testing.assert_allclose(lone.score(*q), members[s], rtol=0,
                                   atol=MEMBER_ATOL)


@pytest.mark.parametrize("live_s,refused", [(S, False), (2, True)])
def test_restore_refuses_another_seed_count_not_another_mesh(
        ranks, tmp_path, live_s, refused):
    path = ranks["serve"][0]["path"]
    t = trainer(str(tmp_path), parallel_runs=live_s)
    if refused:
        with pytest.raises(ValueError, match="parallel_runs: checkpoint=4 "
                                             "vs live=2"):
            t.restore_state(path)
    else:
        assert t.restore_state(path) == (0, 0)


def test_stop_on_one_rank_stops_both(ranks):
    outs = [r["out"] for r in ranks["stop"]]
    assert all(o["interrupted"] for o in outs)
    assert [r["cursor"] for r in ranks["stop"]] == [1, 1]
    saved = load_checkpoint(outs[0]["state_path"])
    assert (saved["epoch"], saved["chunk"]) == (0, 1)
    assert saved["mem"]["memory"].shape[0] == S
    assert outs[0]["state_path"].endswith("_par_4.state.ckpt")


def test_cli_two_local_ranks(tmp_path):
    """``--parallel_runs 4 --n_devices 2 --device cpu``: two ranks started
    by the command, one log with the ``epoch:`` and ``Test statistics:``
    lines over all four seeds, one ``_par_4`` state file that serves as an
    ensemble."""
    _toy(tmp_path)
    (trainer_, res), = cli.main(_argv(
        tmp_path, "toy", "--n_epoch", "2", "--state_every", "1",
        "--parallel_runs", "4", "--n_devices", "2"))
    assert trainer_ is None and len(res["per_seed"]["test_ap"]) == S
    logs = os.listdir(tmp_path / "log" / "toy")
    assert len(logs) == 1 and logs[0].endswith("_par_4")
    text = (tmp_path / "log" / "toy" / logs[0]).read_text()
    assert "epoch: 2 (4 seeds" in text and "Test statistics" in text
    assert text.count("Test statistics: Old nodes") == 1
    states = [f for f in os.listdir(tmp_path / "ckpt")
              if f.endswith(".state.ckpt")]
    assert len(states) == 1 and states[0].endswith("_par_4.state.ckpt")
    ens = LinkPredictor.from_checkpoint(
        str(tmp_path / "ckpt" / states[0]),
        edge_feats=np.load(tmp_path / "toy" / "ml_toy.npy"), device="cpu",
        ensemble=True)
    assert ens.n_models == S
    assert np.isfinite(ens.score([1, 2], [41, 42], [1e6, 1e6])).all()
