"""The port's run loop (Trainer.fit, zebra_tpu_torch/train/loop.py) against
the JAX package's, and its resumes.

Port fit against JAX fit, from the same params (bridge.load_trainer_params),
f32 tables, dropout 0, patience 1, at the sizes of test_torch_trainer.py
(1,200 events, dims 16, top-5, index_chunk 200, the flagship (α, β)
ensemble) on synthetic stream 0 with seed 3 and lr 3e-3. On this stream
the transductive val AP falls by 2.8% at the second epoch (0.590303 →
0.573908), so early stopping fires there, far from a tie; the test then
runs from the first epoch's checkpoint. Bars: the same stop epoch and best
epoch, per-epoch val AP within 1e-6, test and inductive-test metrics within
1e-4 (test_torch_trainer.py's f32 bar; measured 3e-8).

Why a stream that stops at the second epoch: on the CPU the two packages'
params differ by about 3e-5 relative after one epoch (summation order), and
Adam training at this size amplifies a difference of that size: from the
third epoch on at lr 3e-3, and within the first at lr 1e-2, the two runs
part by 1e-3 in the params and 1e-4 to 1e-3 in val AP, as the port does
against itself after the same perturbation of its params. The index's entry
sets stay identical.

Port only: EarlyStopMonitor decides as the JAX one; a state_every resume,
a stop request mid-epoch and at an epoch boundary all resume bit for bit;
save_best keeps or removes the best checkpoint; trace_dir writes a trace."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.train.early_stopping import EarlyStopMonitor as JaxMonitor
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.train.checkpoint import load_checkpoint
from zebra_tpu_torch.train.early_stopping import EarlyStopMonitor
from zebra_tpu_torch.train.loop import Trainer

SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), lr=3e-3)
F32 = dict(dropout=0.0, memory_dtype="float32", message_dtype="float32")
TEST_KEYS = ("test_ap", "test_auc", "test_acc", "nn_test_ap", "nn_test_auc",
             "nn_test_acc")


def _cols(seed=0):
    data, ef = synthetic_stream(n_events=1200, n_users=40, n_items=40,
                                edge_dim=4, seed=seed)
    return (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels), ef


class _ValAps(logging.Handler):
    """The transductive val AP of each epoch, from fit's log lines."""

    def __init__(self):
        super().__init__()
        self.aps = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("val ap: "):
            self.aps.append(float(msg.split(",")[0].split(":")[1]))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """(JAX fit results, JAX val APs, port fit results, port Trainer, the
    JAX init params)."""
    tmp = tmp_path_factory.mktemp("fit")
    cols, ef = _cols()
    jcfg = JaxConfig(**SMALL, **F32, seed=3, patience=1, n_epoch=5,
                     checkpoint_dir=str(tmp / "jax"))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)).replace(
        checkpoint_dir=str(tmp / "port")), split_data(*cols), ef,
        device="cpu")
    init = jax.tree.map(np.asarray, jt.params)
    bridge.load_trainer_params(pt, init)
    grab = _ValAps()
    log = logging.getLogger("zebra_tpu")
    log.addHandler(grab)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        jres = jt.fit()
    finally:
        log.removeHandler(grab)
        log.setLevel(level)
    return jres, grab.aps, pt.fit(), pt, init


def test_fit_stops_at_the_jax_epoch(fits):
    jres, _, pres, _, _ = fits
    assert pres["stop_epoch"] == jres["stop_epoch"] == 2.0


def test_fit_val_aps_and_best_epoch_match_jax(fits):
    _, japs, _, pt, _ = fits
    paps = [r["val_ap"] for r in pt.epoch_log]
    assert len(paps) == len(japs) == 2
    np.testing.assert_allclose(paps, japs, rtol=0, atol=1e-6)
    assert int(np.argmax(paps)) == int(np.argmax(japs)) == 0
    # the stop decision is far from a tie
    assert (paps[0] - paps[1]) / paps[0] > 1e-2


@pytest.mark.parametrize("key", TEST_KEYS)
def test_fit_test_metrics_match_jax(fits, key):
    jres, _, pres, _, _ = fits
    assert abs(pres[key] - jres[key]) <= 1e-4, (pres[key], jres[key])


def test_early_stop_tests_the_best_epoch_state(fits, tmp_path):
    """After the stop the params are the best (first) epoch's, reloaded
    from the best checkpoint, which save_best keeps; without save_best the
    file is removed."""
    _, _, pres, pt, init = fits
    assert not os.path.exists(pt.checkpoint_path)
    again = Trainer(pt.cfg.replace(save_best=True,
                                   checkpoint_dir=str(tmp_path)),
                    pt.splits, pt.edge_feats.numpy(), device="cpu")
    bridge.load_trainer_params(again, init)
    assert again.fit() == pres
    best = load_checkpoint(again.checkpoint_path)
    for key, value in again.params.state_dict().items():
        assert torch.equal(value, best["params"][key]), key


MONITOR_CASES = {
    "rising": ([0.5, 0.6, 0.7, 0.8], 2, True),
    "falling": ([0.8, 0.7, 0.6, 0.5], 2, True),
    "plateau": ([0.6, 0.6, 0.6, 0.6], 3, True),
    "below_tolerance": ([0.5, 0.5 + 1e-12, 0.5 + 2e-12, 0.6], 2, True),
    "zigzag": ([0.5, 0.7, 0.6, 0.75, 0.74, 0.73], 2, True),
    "loss": ([1.0, 0.9, 0.95, 0.97, 0.8], 2, False),
}


@pytest.mark.parametrize("name", sorted(MONITOR_CASES))
def test_early_stop_monitor_decides_like_jax(name):
    values, max_round, higher = MONITOR_CASES[name]
    port = EarlyStopMonitor(max_round=max_round, higher_better=higher)
    ref = JaxMonitor(max_round=max_round, higher_better=higher)
    for v in values:
        assert port.early_stop_check(v) == ref.early_stop_check(v), v
        assert (port.best_epoch, port.num_round, port.epoch_count,
                port.last_best) == (ref.best_epoch, ref.num_round,
                                    ref.epoch_count, ref.last_best)


def _port(tmp_path, sub, **kw):
    cols, ef = _cols()
    cfg = Config(**{**SMALL, "checkpoint_dir": str(tmp_path / sub),
                    "patience": 5, **kw})
    return Trainer(cfg, split_data(*cols), ef, device="cpu")


def _assert_same_run(a, ra, b, rb):
    assert {k: ra[k] for k in TEST_KEYS} == {k: rb[k] for k in TEST_KEYS}
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.mem, b.mem):
        assert torch.equal(x, y)
    assert torch.equal(a.index_state.data, b.index_state.data)


def test_state_every_resume_equals_the_uninterrupted_run(tmp_path):
    full = _port(tmp_path, "a", state_every=2)
    ref = full.fit(n_epoch=3)
    state = os.path.join(full.cfg.checkpoint_dir,
                         full.cfg.run_name() + ".state.ckpt")
    saved = load_checkpoint(state)
    assert (saved["epoch"], saved["chunk"]) == (2, 0)
    assert saved["fit"]["epoch_count"] == 2
    resumed = _port(tmp_path, "b")
    out = resumed.fit(n_epoch=3, resume_from=state)
    _assert_same_run(full, ref, resumed, out)
    assert len(resumed.epoch_log) == 1 and resumed.epoch_log[0]["epoch"] == 3


@pytest.mark.parametrize("index_chunk,saved", [(200, (0, 1)), (65536, (1, 0))],
                         ids=["mid_epoch", "epoch_boundary"])
def test_request_stop_resumes_exactly(tmp_path, index_chunk, saved):
    """A stop request ends the first epoch after its current superchunk: a
    mid-epoch cursor with four superchunks; with one superchunk the epoch is
    complete, and the state file says (epoch 1, chunk 0), so the resume
    does not train that epoch again."""
    full = _port(tmp_path, "a", index_chunk=index_chunk)
    ref = full.fit(n_epoch=2)
    half = _port(tmp_path, "b", index_chunk=index_chunk)
    half.request_stop()
    out = half.fit(n_epoch=2)
    assert out["interrupted"] is True and os.path.exists(out["state_path"])
    ckpt = load_checkpoint(out["state_path"])
    assert (ckpt["epoch"], ckpt["chunk"]) == saved
    resumed = _port(tmp_path, "b", index_chunk=index_chunk)
    _assert_same_run(full, ref, resumed,
                     resumed.fit(n_epoch=2, resume_from=out["state_path"]))


@pytest.mark.parametrize("save_best", [True, False])
def test_save_best_keeps_or_removes_the_best_checkpoint(tmp_path, save_best):
    trainer = _port(tmp_path, "a", save_best=save_best)
    trainer.fit(n_epoch=2)
    assert os.path.exists(trainer.checkpoint_path) == save_best
    if save_best:
        best = load_checkpoint(trainer.checkpoint_path)
        assert set(best) == {"params", "mem"}


def test_trace_dir_writes_a_trace_of_the_chosen_epoch(tmp_path):
    trainer = _port(tmp_path, "a", trace_dir=str(tmp_path / "trace"),
                    trace_epoch=0, profile=True)
    trainer.fit(n_epoch=1)
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
