"""The whole run with the graph_attention tower (zebra_tpu_torch/train/
loop.py, node_classification.py), at the sizes of
test_torch_towers_trainer.py:

- the ``--task node`` replay over the train stream (train graph) and the
  val stream (full graph) against the JAX package's, from the JAX init
  params: source embeddings ``hidden_dim = node_dim`` wide and memory
  within 1e-5 (test_torch_pruning_step.py's replay bar); the node
  classification protocol end to end on a labelled stream;
- a ``fit`` stopped by ``request_stop`` (at the epoch's end: no waves) and
  resumed equals the uninterrupted one bit for bit; its state file holds no
  index;
- a state file written under another ``n_layer`` or another tower is
  refused, in the JAX package's words."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_towers_trainer import F32, SMALL, _cols
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.train import node_classification as jnc
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu.train.loop import _fresh_epoch_state
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.train.checkpoint import load_checkpoint
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.node_classification import (
    collect_source_embeddings,
    run_node_classification,
)

TOWER = "graph_attention"


def _port(tmp_path, sub="ckpt", n_events=600, **kw):
    cols, ef = _cols(n_events)
    cfg = Config(**{**SMALL, "embedding_module": TOWER,
                    "checkpoint_dir": str(tmp_path / sub), **kw})
    return Trainer(cfg, split_data(*cols), ef, device="cpu")


def test_node_replay_matches_jax(tmp_path):
    cols, ef = _cols(800)
    jcfg = JaxConfig(**SMALL, **F32, embedding_module=TOWER,
                     checkpoint_dir=str(tmp_path))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    jmem, _ = _fresh_epoch_state(jt.cfg)
    jmem = jax.tree.map(jnp.asarray, jmem)
    pmem, pidx = pt._fresh_state()
    assert pidx is None
    for name, graph in (("train", "train_nbr_index"),
                        ("val", "full_nbr_index")):
        js = jt._streams[name]
        jmem, _, je = jnc.collect_source_embeddings(
            jt.cfg, js.n_batches, jt.params, jmem, (), jt.edge_feats,
            getattr(jt, graph), js.stream)
        valid = np.asarray(jt._host_streams[name]["valid"])
        want = np.asarray(je).reshape(-1, jt.cfg.hidden_dim)[valid]
        pmem, pidx, pe, waves = collect_source_embeddings(
            pt.cfg, pt.params, pmem, pidx, pt.edge_feats, pt._streams[name],
            getattr(pt, graph))
        assert waves == 0 and pidx is None
        got = pe.numpy()[pt._streams[name].host["valid"]]
        assert got.shape == want.shape and want.shape[1] == 16
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pmem.memory.numpy(), np.asarray(jmem.memory),
                               rtol=0, atol=1e-5)


def test_node_classification_protocol(tmp_path):
    cols, ef = _cols(600, label_users_frac=0.3)
    trainer = Trainer(Config(**SMALL, embedding_module=TOWER,
                             checkpoint_dir=str(tmp_path)),
                      split_data(*cols), ef, device="cpu")
    trainer.train_epoch()
    out = run_node_classification(trainer, n_steps=50)
    assert set(out) == {"node_train_auc", "node_val_auc", "node_test_auc"}
    assert all(np.isfinite(v) for v in out.values()), out
    assert trainer.index_waves == 0


def test_stop_takes_effect_at_epoch_end_and_resumes_exactly(tmp_path):
    full = _port(tmp_path, "a")
    ref = full.fit(n_epoch=2)
    half = _port(tmp_path, "b")
    assert half._streams["train"].n_chunks > 1
    half.request_stop()
    out = half.fit(n_epoch=2)
    assert out["interrupted"] is True
    ckpt = load_checkpoint(out["state_path"])
    assert (ckpt["epoch"], ckpt["chunk"]) == (1, 0)
    assert ckpt["index_state"] is None
    resumed = _port(tmp_path, "b")
    got = resumed.fit(n_epoch=2, resume_from=out["state_path"])
    assert {k: got[k] for k in ref} == ref
    for x, y in zip(full.params.parameters(), resumed.params.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(full.mem, resumed.mem):
        assert torch.equal(x, y)


@pytest.mark.parametrize("live,match", [
    (dict(n_layer=1), "n_layer: checkpoint=2 vs live=1"),
    (dict(embedding_module="graph_sum"),
     "embedding_module: checkpoint='graph_attention' vs live='graph_sum'"),
], ids=["n_layer", "tower"])
def test_state_file_of_another_shape_is_refused(tmp_path, live, match):
    a = _port(tmp_path, "a", n_events=300)
    path = os.path.join(str(tmp_path), "state.ckpt")
    a.save_state(path)
    b = _port(tmp_path, "b", n_events=300, **live)
    with pytest.raises(ValueError, match=match):
        b.restore_state(path)
