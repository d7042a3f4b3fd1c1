"""Serving from a state file (LinkPredictor.from_checkpoint, zebra_tpu_torch/
serve.py), after the JAX package's deployment path: a predictor built from
a Trainer's state file scores and observes exactly as one built from the
Trainer (LinkPredictor.from_trainer) holding that state; a model trained
with real edge features refuses to serve without them; a single-seed file
refuses the seed axis (run_index, ensemble) with the JAX package's errors.
Serving a seed-parallel file: test_torch_ensemble.py."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_checkpoint import port_trainer
from zebra_tpu_torch.serve import LinkPredictor
from zebra_tpu_torch.train.checkpoint import load_checkpoint


@pytest.fixture
def state(tmp_path):
    """A Trainer after an epoch and validate(), and its state file."""
    trainer = port_trainer(tmp_path)
    trainer.train_epoch()
    trainer.validate()
    path = str(tmp_path / "state.ckpt")
    trainer.save_state(path, epoch=1)
    return trainer, path


def _requests(trainer, lo, hi):
    te = trainer.splits.test
    return (te.sources[lo:hi], te.destinations[lo:hi], te.timestamps[lo:hi],
            te.edge_idxs[lo:hi])


def test_from_checkpoint_serves_like_from_trainer(state):
    trainer, path = state
    served = LinkPredictor.from_checkpoint(
        path, edge_feats=trainer.edge_feats.numpy(), device="cpu")
    ref = LinkPredictor.from_trainer(trainer)
    assert served.cfg == trainer.cfg
    src, dst, t, eidx = _requests(trainer, 0, 64)
    np.testing.assert_array_equal(served.score(src, dst, t),
                                  ref.score(src, dst, t))
    for lo in range(64, 184, 40):
        batch = _requests(trainer, lo, lo + 40)
        served.observe(*batch)
        ref.observe(*batch)
    assert torch.equal(served.index_state.data, ref.index_state.data)
    for x, y in zip(served.mem, ref.mem):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(served.score(src, dst, t),
                                  ref.score(src, dst, t))


def test_from_checkpoint_takes_a_config(state):
    trainer, path = state
    cfg = trainer.cfg.replace(data="other", lr=1.0)
    served = LinkPredictor.from_checkpoint(
        path, cfg=cfg, edge_feats=trainer.edge_feats.numpy(), device="cpu")
    assert served.cfg == cfg


def test_real_edge_features_are_required(state):
    _, path = state
    assert load_checkpoint(path)["cfg"]["real_edge_feats"] is True
    with pytest.raises(ValueError, match="4-dim edge features"):
        LinkPredictor.from_checkpoint(path, device="cpu")


def test_a_model_without_edge_features_serves_on_zeros(tmp_path):
    trainer = port_trainer(tmp_path, ignore_edge_feats=True)
    trainer.train_epoch()
    path = str(tmp_path / "plain.ckpt")
    trainer.save_state(path)
    served = LinkPredictor.from_checkpoint(path, device="cpu")
    assert served.edge_feats.shape == (trainer.cfg.n_edges, 1)
    assert not served.edge_feats.any()
    src, dst, t, _ = _requests(trainer, 0, 32)
    np.testing.assert_array_equal(
        served.score(src, dst, t),
        LinkPredictor.from_trainer(trainer).score(src, dst, t))


@pytest.mark.parametrize("kw,match", [
    (dict(ensemble=True), "needs a seed-parallel checkpoint"),
    (dict(run_index=1), "this checkpoint is single-seed"),
], ids=["ensemble", "run_index"])
def test_a_single_seed_file_has_no_seed_axis(state, kw, match):
    trainer, path = state
    with pytest.raises(ValueError, match=match):
        LinkPredictor.from_checkpoint(
            path, edge_feats=trainer.edge_feats.numpy(), device="cpu", **kw)
