"""The port's Trainer (zebra_tpu_torch/train/loop.py) against the JAX
Trainer on one synthetic stream, at the sizes of test_train_loop.py (1,200
events, 40 + 40 nodes, bs 50, index_chunk 200, dims 16, top-5) and the
flagship (α, β) ensemble, started from the same params carried across with
bridge.load_trainer_params, with dropout 0 and n_devices 1: one
train_epoch, validate() and test(). f32 tables here, the bf16 default in
test_torch_trainer_bf16.py.

Bars:
- negatives, stream padding and wave counts: identical;
- f32 tables: every phase's loss, AP, AUC and accuracy within 1e-4
  absolute, and the params after the epoch within 1e-4 of each tensor's
  largest entry (measured on the CPU: 1.2e-7 and 3.0e-5). The two differ
  in summation order, the BCE formula's rounding, and an ulp of some index
  weights (XLA contracts a multiply-add);
- bf16 tables (the default): loss within 1e-3, AP and AUC within 3e-2,
  accuracy within 1e-1, params within 1e-1 of each tensor's largest entry
  (measured on the CPU: 2.4e-5, 1.2e-2, 1.4e-2, 4.5e-2 and 3.0e-2). One
  train step agrees within 1e-5 (test_torch_train.py); over an epoch a
  bf16 table entry that rounds the other way at a boundary changes later
  lazy updates and Adam's normalised steps, and the runs drift apart. AP,
  AUC and accuracy are step functions of the scores: on these weakly
  trained models many positives score close to their negatives, and a
  small drift flips some.

Port-only: the loss falls over three epochs, validate() from the same
train-end state twice gives identical results, and LinkPredictor
.from_trainer scores like a predictor built by hand from the same state."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.index.streaming import TpprState
from zebra_tpu_torch.models.memory import MemoryState
from zebra_tpu_torch.serve import LinkPredictor
from zebra_tpu_torch.train.loop import Trainer

SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), lr=3e-3)
PHASES = ("train", "val", "nn_val", "test", "nn_test")
# bars on (loss, ap, auc, acc) and on the params, relative to each
# tensor's largest entry
BARS = {"float32": ((1e-4,) * 4, 1e-4),
        "bfloat16": ((1e-3, 3e-2, 3e-2, 1e-1), 1e-1)}


def _stream():
    data, ef = synthetic_stream(n_events=1200, n_users=40, n_items=40,
                                edge_dim=4, seed=0)
    return (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels), ef


def _port(dtype="bfloat16", **kw):
    cols, ef = _stream()
    cfg = Config(**{**SMALL, "memory_dtype": dtype, "message_dtype": dtype,
                    **kw})
    return Trainer(cfg, split_data(*cols), ef, device="cpu")


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(zip(PHASES, (tr, val, nn_val, test, nn_test)))


def make_pair(dtype, ckpt_dir):
    """(dtype, JAX Trainer, port Trainer, JAX results, port results, train
    negatives of epochs 0 and 1 of both)."""
    cols, ef = _stream()
    jcfg = JaxConfig(**SMALL, dropout=0.0, memory_dtype=dtype,
                     message_dtype=dtype, checkpoint_dir=str(ckpt_dir))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    negs = [(jt._draw_train_negs(e), pt._draw_train_negs(e)) for e in (0, 1)]
    return dtype, jt, pt, _run(jt), _run(pt), negs


def check_streams(pair):
    _, jt, pt, _, _, negs = pair
    assert pt.cfg.n_nodes == jt.cfg.n_nodes and pt.cfg.n_edges == jt.cfg.n_edges
    for j, p in negs:
        np.testing.assert_array_equal(p, j)
    for name, ps in pt._streams.items():
        js = jt._streams[name]
        assert (ps.n_batches, ps.real_batches, ps.n_chunks) == (
            js.n_batches, js.real_batches, js.n_chunks), name
        for f, col in jt._host_streams[name].items():
            np.testing.assert_array_equal(ps.host[f], col, err_msg=name + f)


def check_phase(pair, phase):
    dtype, _, _, jres, pres, _ = pair
    bars, _ = BARS[dtype]
    for f, bar in zip(("loss", "ap", "auc", "acc"), bars):
        assert abs(getattr(pres[phase], f) - getattr(jres[phase], f)) <= bar, (
            f, getattr(pres[phase], f), getattr(jres[phase], f))


def check_params(pair):
    dtype, jt, pt, _, _, _ = pair
    _, bar = BARS[dtype]
    want = jax.tree.map(np.asarray, jt.params)
    for name, layer in bridge.params_to_numpy(pt.params).items():
        for key, got in layer.items():
            w = want[name][key]
            assert np.abs(got - w).max() <= bar * np.abs(w).max(), (name, key)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair("float32", tmp_path_factory.mktemp("ckpt"))


def test_streams_and_negatives_match_jax(pair):
    check_streams(pair)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_metrics_match_jax(pair, phase):
    check_phase(pair, phase)


def test_params_after_epoch_match_jax(pair):
    check_params(pair)


def test_loss_falls_over_three_epochs():
    trainer = _port()
    losses = [trainer.train_epoch().loss for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses


def test_validate_twice_from_train_end_state_is_identical():
    trainer = _port()
    trainer.train_epoch()
    mem = MemoryState(*(x.clone() for x in trainer.mem))
    idx = trainer.index_state.data.clone()
    first = trainer.validate()
    mem1 = [x.clone() for x in trainer.mem]
    trainer.mem, trainer.index_state = mem, TpprState(idx)
    second = trainer.validate()
    for a, b in zip(first, second):
        assert (a.loss, a.ap, a.auc, a.acc) == (b.loss, b.ap, b.auc, b.acc)
    for a, b in zip(mem1, trainer.mem):
        assert torch.equal(a, b)


def test_from_trainer_scores_like_a_predictor_built_by_hand():
    trainer = _port()
    trainer.train_epoch()
    pred = LinkPredictor.from_trainer(trainer)
    by_hand = LinkPredictor(trainer.cfg, trainer.params, trainer.mem,
                            trainer.index_state,
                            trainer.edge_feats.numpy(), device="cpu")
    fu = trainer.splits.full
    sl = slice(900, 964)
    src, dst, t = fu.sources[sl], fu.destinations[sl], fu.timestamps[sl]
    np.testing.assert_array_equal(pred.score(src, dst, t),
                                  by_hand.score(src, dst, t))
    # the predictor holds copies: observing moves it, not the trainer
    before = trainer.index_state.data.clone()
    pred.observe(src, dst, t, fu.edge_idxs[sl])
    assert torch.equal(trainer.index_state.data, before)
    assert not torch.equal(pred.index_state.data, before)


def test_dropout_masks_follow_the_seed():
    """Train-mode dropout draws from the Trainer's seeded generator: the
    same seed repeats an epoch exactly, and dropout changes it."""
    a, b = _port().train_epoch(), _port().train_epoch()
    np.testing.assert_array_equal(a.per_batch, b.per_batch)
    c = _port(dropout=0.0).train_epoch()
    assert not np.array_equal(a.per_batch[:, 0], c.per_batch[:, 0])
