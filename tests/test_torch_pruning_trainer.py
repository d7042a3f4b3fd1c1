"""The port's Trainer under the pruning strategy (zebra_tpu_torch/train/
loop.py, phase.py, node_classification.py with index/pruning.py) against the
JAX package's, at the sizes of test_torch_trainer.py (1,200 events, 40 + 40
nodes, bs 50, index_chunk 200, dims 16, top-5) with the (α, β) of the MOOC
pruning run, (0.1, 0.1) and (0.5, 0.95), BFS width 5 and depth 2; f32
tables, dropout 0.

Bars:
- one epoch, ``validate()`` and ``test()``: every phase's loss, AP, AUC and
  accuracy within 1e-4, and the params within 1e-4 of each tensor's largest
  entry: test_torch_trainer.py's f32 bars (measured here on the CPU: 2.4e-7
  on the train loss, the eval metrics equal). The BFS needs no wider bar:
  the port's queries equal JAX's bit for bit on the CPU (test_torch_pruning
  .py). One train step and the node-classification replay:
  test_torch_pruning_step.py.

Port only: no index state, no wave and no santa kernel under pruning; a
stop request takes effect at the epoch's end and the resumed ``fit`` equals
the uninterrupted one bit for bit; a state file of one strategy is refused
by a Trainer of the other."""

import dataclasses
import os

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
from zebra_tpu_torch.index import merge, scan
from zebra_tpu_torch.train.checkpoint import load_checkpoint
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.node_classification import run_node_classification

PRUNING = dict(tppr_strategy="pruning", n_degree=5, n_layer=2,
               alpha_list=(0.1, 0.1), beta_list=(0.5, 0.95))
SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, lr=3e-3, **PRUNING)
F32 = dict(dropout=0.0, memory_dtype="float32", message_dtype="float32")
PHASES = ("train", "val", "nn_val", "test", "nn_test")


def _cols(n_events=1200, **kw):
    data, ef = synthetic_stream(n_events=n_events, n_users=40, n_items=40,
                                edge_dim=4, seed=0, **kw)
    return (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels), ef


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(zip(PHASES, (tr, val, nn_val, test, nn_test)))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cols, ef = _cols()
    jcfg = JaxConfig(**SMALL, **F32,
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    merge.SANTA_MERGE.launches = scan.SANTA_SCAN.launches = 0
    return jt, pt, _run(jt), _run(pt)


@pytest.mark.parametrize("phase_name", PHASES)
def test_phase_metrics_match_jax(pair, phase_name):
    _, _, jres, pres = pair
    for f in ("loss", "ap", "auc", "acc"):
        got, want = getattr(pres[phase_name], f), getattr(jres[phase_name], f)
        assert abs(got - want) <= 1e-4, (f, got, want)


def test_params_after_epoch_match_jax(pair):
    jt, pt, _, _ = pair
    want = jax.tree.map(np.asarray, jt.params)
    for name, layer in bridge.params_to_numpy(pt.params).items():
        for key, got in layer.items():
            w = want[name][key]
            assert np.abs(got - w).max() <= 1e-4 * np.abs(w).max(), (name, key)


def test_pruning_runs_no_index_state_and_no_kernel(pair):
    _, pt, _, pres = pair
    assert pt.index_state is None and pt.index_waves == 0
    assert all(r.waves == 0 for r in pres.values())
    assert pres["train"].index_seconds > 0       # the BFS calls' host time
    assert merge.SANTA_MERGE.launches == scan.SANTA_SCAN.launches == 0
    assert pt.train_nbr_index.ts.shape[0] == 2 * pt.splits.train.n_interactions
    assert pt.full_nbr_index.ts.shape[0] == 2 * pt.splits.full.n_interactions


def test_node_classification_protocol(tmp_path):
    cols, ef = _cols(label_users_frac=0.3)
    trainer = Trainer(Config(**SMALL, checkpoint_dir=str(tmp_path)),
                      split_data(*cols), ef, device="cpu")
    trainer.train_epoch()
    out = run_node_classification(trainer, n_steps=100)
    assert set(out) == {"node_train_auc", "node_val_auc", "node_test_auc"}
    assert all(np.isfinite(v) for v in out.values()), out
    assert trainer.index_waves == 0


def _port(tmp_path, sub, **kw):
    cols, ef = _cols()
    cfg = Config(**{**SMALL, "checkpoint_dir": str(tmp_path / sub), **kw})
    return Trainer(cfg, split_data(*cols), ef, device="cpu")


def test_stop_takes_effect_at_epoch_end_and_resumes_exactly(tmp_path):
    full = _port(tmp_path, "a")
    ref = full.fit(n_epoch=2)
    half = _port(tmp_path, "b")
    assert half._streams["train"].n_chunks == 4
    half.request_stop()
    out = half.fit(n_epoch=2)
    assert out["interrupted"] is True
    ckpt = load_checkpoint(out["state_path"])
    # the whole first epoch ran: the file resumes at the second
    assert (ckpt["epoch"], ckpt["chunk"]) == (1, 0)
    assert ckpt["index_state"] is None
    resumed = _port(tmp_path, "b")
    got = resumed.fit(n_epoch=2, resume_from=out["state_path"])
    assert {k: got[k] for k in ref} == ref
    for x, y in zip(full.params.parameters(), resumed.params.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(full.mem, resumed.mem):
        assert torch.equal(x, y)


@pytest.mark.parametrize("saved,live", [("streaming", "pruning"),
                                        ("pruning", "streaming")])
def test_state_file_of_the_other_strategy_is_refused(tmp_path, saved, live):
    a = _port(tmp_path, "a", tppr_strategy=saved)
    path = os.path.join(str(tmp_path), "state.ckpt")
    a.save_state(path)
    b = _port(tmp_path, "b", tppr_strategy=live)
    with pytest.raises(ValueError, match="tppr_strategy: checkpoint="):
        b.restore_state(path)
