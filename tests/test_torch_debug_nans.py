"""``--debug_nans`` in the port. JAX turns on ``jax_debug_nans``, which
raises ``FloatingPointError`` at the first operation that makes a NaN; torch
has no global counterpart, so the port's phase loop reads back after each
batch whether its loss, logits, updated params and written memory rows
are finite, and raises ``FloatingPointError`` naming the phase and the
batch.

Checks: a NaN planted in an edge-feature row that the first train batch
reads (its messages) raises in train batch 0, naming the written memory
rows, with the flag and under every tower kind;
one planted in a row that only the val stream reads passes the train
epoch and raises in the first val batch that reads it; without the flag
the same NaN trains on (a non-finite loss), the check is never called,
and a batch dispatches fewer aten operations than with the flag
(``utils/profiling.count_ops``). Last, the CLI with ``--debug_nans``
and every other ported option (mean, mlp, both message sources, the auto
lazy cap), with ``--task node`` and on the seed axis: the flags reach the
Trainer's config, fit runs to test(), and the state file serves."""

import numpy as np
import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_cli import _argv, _toy
from zebra_tpu_torch import cli
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.profile_train import train_batch
from zebra_tpu_torch.serve import LinkPredictor
from zebra_tpu_torch.train import phase
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.utils.profiling import count_ops

TOWERS = {
    "streaming": {},
    "pruning": dict(tppr_strategy="pruning", n_degree=4, n_layer=2),
    "graph_attention": dict(embedding_module="graph_attention", n_degree=3,
                            n_layer=1),
}


def _trainer(tmp_path, poison, **kw):
    """A small Trainer with a NaN in the edge-feature row of an event of
    stream ``poison``: the last event of the first train batch (its
    message wins the last-wins store for both its nodes), or the first
    val event."""
    data, ef = synthetic_stream(n_events=400, n_users=20, n_items=20,
                                edge_dim=4, seed=0)
    splits = split_data(data.sources, data.destinations, data.timestamps,
                        data.edge_idxs, data.labels)
    ef = ef.copy()
    event = 49 if poison == "train" else 0
    ef[getattr(splits, poison).edge_idxs[event], 1] = np.nan
    cfg = Config(bs=50, index_chunk=200, node_dim=8, time_dim=8,
                 memory_dim=8, topk=4, alpha_list=(0.1,), beta_list=(0.9,),
                 checkpoint_dir=str(tmp_path), **kw)
    return Trainer(cfg, splits, ef, device="cpu")


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_planted_nan_raises_in_the_first_batch(tmp_path, tower):
    trainer = _trainer(tmp_path, "train", debug_nans=True, **TOWERS[tower])
    with pytest.raises(FloatingPointError, match="train batch 0: .*memory"):
        trainer.train_epoch()


def test_nan_read_only_by_val_raises_there(tmp_path):
    trainer = _trainer(tmp_path, "val", debug_nans=True)
    r = trainer.train_epoch()
    assert np.isfinite(r.per_batch).all()
    with pytest.raises(FloatingPointError, match="val batch 0: .*memory"):
        trainer.validate()


def test_without_the_flag_nothing_is_added(tmp_path, monkeypatch):
    """The identity tower (``profile_train.train_batch`` drives a tower
    batch): without the flag the NaN trains on unchecked; a clean batch
    dispatches fewer operations without the flag than with it."""
    ident = dict(embedding_module="identity")

    def never(*args, **kw):
        raise AssertionError("check_finite ran without --debug_nans")

    with monkeypatch.context() as m:
        m.setattr(phase, "check_finite", never)
        r = _trainer(tmp_path, "train", **ident).train_epoch()
        assert not np.isfinite(r.per_batch[:, 0]).all()
        n_off = count_ops(train_batch(_trainer(tmp_path, "val", **ident), 1))
    n_on = count_ops(train_batch(
        _trainer(tmp_path, "val", debug_nans=True, **ident), 1))
    assert n_on > n_off
    with pytest.raises(FloatingPointError, match="train batch 0"):
        train_batch(_trainer(tmp_path, "train", debug_nans=True, **ident),
                    0)()


@pytest.mark.parametrize("extra", [
    ["--task", "node"],
    ["--parallel_runs", "2", "--parallel_lr", "1e-3", "3e-3"],
], ids=["node", "seeds"])
def test_cli_passes_every_option(tmp_path, extra):
    """The CLI with every ported option: the flags reach the Trainer's
    config, fit runs its epochs and test(), and the state file serves."""
    _toy(tmp_path, labels=True)
    (trainer, results), = cli.main(_argv(
        tmp_path, "toy", "--n_epoch", "2", "--state_every", "1",
        "--aggregator", "mean", "--message_function", "mlp",
        "--use_source_embedding_in_message",
        "--use_destination_embedding_in_message", "--lazy_unique_cap", "-1",
        "--debug_nans", "--device", "cpu", *extra))
    cfg = trainer.cfg
    assert (cfg.aggregator, cfg.message_function, cfg.lazy_unique_cap,
            cfg.debug_nans) == ("mean", "mlp", -1, True)
    assert cfg.use_source_embedding_in_message
    assert cfg.use_destination_embedding_in_message
    assert np.isfinite(results["test_ap"])
    if extra[1] == "node":
        assert np.isfinite(results["node_val_auc"])
    state = tmp_path / "ckpt" / (cfg.run_name() + ".state.ckpt")
    pred = LinkPredictor.from_checkpoint(
        str(state), edge_feats=trainer.edge_feats.numpy(), device="cpu",
        ensemble=cfg.parallel_runs > 1)
    fu = trainer.splits.full
    scores = pred.score(fu.sources[:20], fu.destinations[:20],
                        fu.timestamps[:20])
    assert scores.shape == (20,) and np.isfinite(scores).all()
