"""The single-device model options combined (``--aggregator mean
--message_function mlp --use_source_embedding_in_message
--use_destination_embedding_in_message``) through the port's Trainer
against the JAX Trainer, under the streaming and the pruning strategy, from
the same params, dropout 0, f32 tables, lr 1e-3: one train_epoch,
validate() and test(), then the node-classification replay.

Bars:
- every phase's loss, AP, AUC and accuracy within 1e-4, the params after
  the epoch within 1e-4 of each tensor's largest entry or 3e-3·lr
  (test_torch_aggregator_mean.py's Adam bar);
- the node-classification replay of the train and val streams from a
  fresh state with the trained params (store then commit, embeddings in
  the messages): source embeddings and memory within 1e-5
  (test_torch_node_classification.py's bars), last_update exact."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tests.test_torch_aggregator_mean import ADAM_ATOL
from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.dataset import split_data as jax_split_data
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.train import node_classification as jnc
from zebra_tpu.train.loop import Trainer as JaxTrainer
from zebra_tpu.train.loop import _fresh_epoch_state
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.train.node_classification import (
    collect_source_embeddings,
)

ALL = dict(aggregator="mean", message_function="mlp",
           use_source_embedding_in_message=True,
           use_destination_embedding_in_message=True)
SMALL = dict(bs=50, index_chunk=200, node_dim=8, time_dim=8, memory_dim=8,
             topk=4, lr=1e-3, dropout=0.0, memory_dtype="float32",
             message_dtype="float32", **ALL)
STRATEGIES = {
    "streaming": dict(alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95)),
    "pruning": dict(tppr_strategy="pruning", n_degree=4, n_layer=2,
                    alpha_list=(0.1, 0.1), beta_list=(0.5, 0.95)),
}
PHASES = ("train", "val", "nn_val", "test", "nn_test")


def _run(trainer):
    tr = trainer.train_epoch()
    val, nn_val = trainer.validate()
    test, nn_test = trainer.test()
    return dict(zip(PHASES, (tr, val, nn_val, test, nn_test)))


@pytest.fixture(scope="module", params=sorted(STRATEGIES))
def pair(request, tmp_path_factory):
    data, ef = synthetic_stream(n_events=600, n_users=30, n_items=30,
                                edge_dim=4, seed=0)
    cols = (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels)
    jcfg = JaxConfig(**SMALL, **STRATEGIES[request.param],
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    return jt, pt, _run(jt), _run(pt)


def test_phases_match_jax(pair):
    _, _, jres, pres = pair
    for name in PHASES:
        for f in ("loss", "ap", "auc", "acc"):
            got, want = getattr(pres[name], f), getattr(jres[name], f)
            assert abs(got - want) <= 1e-4, (name, f, got, want)


def test_params_after_epoch_match_jax(pair):
    jt, pt, _, _ = pair
    want = jax.tree.map(np.asarray, jt.params)
    for name, layer in bridge.params_to_numpy(pt.params).items():
        for key, got in layer.items():
            w = want[name][key]
            err = np.abs(got - w).max()
            assert err <= max(1e-4 * np.abs(w).max(),
                              ADAM_ATOL * pt.cfg.lr), (name, key, err)


def test_node_replay_matches_jax(pair):
    jt, pt, _, _ = pair
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    jmem, jidx = _fresh_epoch_state(jt.cfg)
    jmem = jax.tree.map(jnp.asarray, jmem)
    pmem, pidx = pt._fresh_state()
    nbr = {"train": (jt.train_nbr_index, pt.train_nbr_index),
           "val": (jt.full_nbr_index, pt.full_nbr_index)}
    for name in ("train", "val"):
        js = jt._streams[name]
        jmem, jidx, je = jnc.collect_source_embeddings(
            jt.cfg, js.n_batches, jt.params, jmem, jidx, jt.edge_feats,
            nbr[name][0] if pt.cfg.needs_adjacency else (), js.stream)
        pmem, pidx, pe, _ = collect_source_embeddings(
            pt.cfg, pt.params, pmem, pidx, pt.edge_feats, pt._streams[name],
            nbr[name][1])
        valid = pt._streams[name].host["valid"]
        want = np.asarray(je).reshape(-1, jt.cfg.hidden_dim)[valid]
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(pe.numpy()[valid], want, rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(pmem.memory.numpy(), np.asarray(jmem.memory),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pmem.last_update.numpy(),
                                  np.asarray(jmem.last_update))
