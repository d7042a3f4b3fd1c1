"""The port's seed-parallel run loop (``Trainer(parallel_runs=S).fit``,
``_fit_seeds``), its resumes and state files, at the sizes of
test_torch_seed_trainer.py (1,200 events, dims 16, top-5, bs 50,
index_chunk 200: four superchunks), S = 3, the port's default bf16 tables.

Bars: each seed's early stop decided alone, the stopped seeds tested from
their best snapshot; a stop request mid-epoch and its resume, and a state
file's round trip, bit for bit; a seed-parallel file refused by a Trainer
of another seed layout, with the JAX package's wording."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_seed_trainer import S, port
from zebra_tpu_torch.train.checkpoint import load_checkpoint

TEST_KEYS = ("test_ap", "test_auc", "test_acc", "nn_test_ap", "nn_test_auc",
             "nn_test_acc")


def test_fit_seeds_early_stops_per_seed(tmp_path, caplog):
    """patience 1 over four epochs at lr 1e-2: each seed's stopper decides
    alone, the stopped seeds test from their best snapshot, and the result
    carries the mean, σ and per-seed keys with each seed's lr."""
    t = port(tmp_path, parallel_runs=S, lr=1e-2, patience=1, n_epoch=4,
             save_best=True)
    with caplog.at_level("INFO", logger="zebra_tpu_torch"):
        res = t.fit()
    per = res["per_seed"]
    assert set(per) == set(TEST_KEYS) | {"stop_epoch", "lr"}
    assert per["lr"] == [1e-2] * S and len(per["test_ap"]) == S
    assert res["test_ap"] == pytest.approx(np.mean(per["test_ap"]))
    assert res["test_ap_std"] == pytest.approx(np.std(per["test_ap"]))
    assert res["stop_epoch"] == pytest.approx(np.mean(per["stop_epoch"]))
    assert any(e > 0 for e in per["stop_epoch"]), per["stop_epoch"]
    text = caplog.text
    assert "train events/s (aggregate)" in text and "±" in text
    # the best checkpoint holds every seed's best-or-current state
    best = load_checkpoint(t.checkpoint_path)
    assert best["params"]["fc1.w"].shape[0] == S
    assert best["mem"]["memory"].shape[:2] == (S, t.cfg.n_nodes)
    for s, e in enumerate(per["stop_epoch"]):
        if e > 0:   # stopped: tested from its best snapshot
            assert torch.equal(t.params.state_dict()["fc1.w"][s],
                               best["params"]["fc1.w"][s])


def _assert_same(a, b):
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.mem, b.mem):
        assert torch.equal(x, y)
    assert torch.equal(a.index_state.data, b.index_state.data)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["steps"] == sb["steps"]
    for x, y in zip(sa["exp_avg"] + sa["exp_avg_sq"],
                    sb["exp_avg"] + sb["exp_avg_sq"]):
        assert torch.equal(x, y)
    for g, h in zip(a._dropout, b._dropout):
        assert torch.equal(g.get_state(), h.get_state())


def test_request_stop_mid_epoch_resumes_bit_equal(tmp_path):
    full = port(tmp_path, "a", parallel_runs=S)
    ref = full.fit(n_epoch=2)
    half = port(tmp_path, "b", parallel_runs=S)
    half.request_stop()
    out = half.fit(n_epoch=2)
    assert out["interrupted"] is True
    saved = load_checkpoint(out["state_path"])
    assert (saved["epoch"], saved["chunk"]) == (0, 1)
    assert saved["mem"]["memory"].shape[:2] == (S, full.cfg.n_nodes)
    resumed = port(tmp_path, "b", parallel_runs=S)
    got = resumed.fit(n_epoch=2, resume_from=out["state_path"])
    assert {k: got[k] for k in TEST_KEYS} == {k: ref[k] for k in TEST_KEYS}
    assert got["per_seed"] == ref["per_seed"]
    _assert_same(full, resumed)


def test_state_file_round_trip(tmp_path):
    path = str(tmp_path / "seeds.ckpt")
    t1 = port(tmp_path, parallel_runs=S, parallel_lr=(1e-3, 2e-3, 3e-3))
    t1.train_epoch(max_chunks=2)
    t1.save_state(path)
    tree = load_checkpoint(path)
    assert tree["dropout"].shape[0] == S and len(tree["neg_base"]) == S
    assert tree["index_state"].shape[0] == t1.cfg.n_nodes
    t2 = port(tmp_path, parallel_runs=S, parallel_lr=(1e-3, 2e-3, 3e-3))
    assert t2.restore_state(path) == (0, 2)
    _assert_same(t1, t2)
    a, b = t1.train_epoch(start_chunk=2), t2.train_epoch(start_chunk=2)
    np.testing.assert_array_equal(a.per_batch, b.per_batch)
    _assert_same(t1, t2)


@pytest.mark.parametrize("kw,match", [
    (dict(), "parallel_runs: checkpoint=3 vs live=1.*run_index"),
    (dict(parallel_runs=S, parallel_lr=(1e-3,) * S), "parallel_lr: checkpoint"),
], ids=["single_seed", "parallel_lr"])
def test_restore_refuses_another_seed_layout(tmp_path, kw, match):
    path = str(tmp_path / "seeds.ckpt")
    port(tmp_path, parallel_runs=S).save_state(path)
    with pytest.raises(ValueError, match=match):
        port(tmp_path, **kw).restore_state(path)


