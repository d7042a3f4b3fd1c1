"""The port's node classification (zebra_tpu_torch/train/node_classification
.py) against the JAX package's:

- collect_source_embeddings from the same params and a fresh state over
  the train then the val stream (f32 tables): embeddings and memory within
  1e-5 (matrix-product summation order), the index at the merge bar of
  test_torch_merge.py;
- the decoder with the JAX params carried across: logits within 1e-6, and
  one Adam step with dropout 0 (loss and params within 1e-6);
- the pairwise AUC against JAX's on the same probabilities, ties included.

Port only: the decoder separates separable labels, and the whole protocol
runs through the Trainer's wave path."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tests.test_torch_merge import assert_entries_close
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
    NodeDecoder,
    collect_source_embeddings,
    decoder_step,
    eval_node_classification,
    pairwise_auc,
    run_node_classification,
    train_node_classifier,
)

SMALL = dict(bs=50, index_chunk=200, node_dim=16, time_dim=16, memory_dim=16,
             topk=5, alpha_list=(0.1, 0.1), beta_list=(0.05, 0.95), lr=3e-3)


def _cols(n_events=800, label_users_frac=0.0):
    data, ef = synthetic_stream(n_events=n_events, n_users=40, n_items=40,
                                edge_dim=4, seed=0,
                                label_users_frac=label_users_frac)
    return (data.sources, data.destinations, data.timestamps, data.edge_idxs,
            data.labels), ef


@pytest.fixture(scope="module")
def collected(tmp_path_factory):
    """Embeddings, memory and index of both packages after replaying the
    train and val streams from a fresh state with the JAX init params."""
    cols, ef = _cols()
    jcfg = JaxConfig(**SMALL, dropout=0.0, memory_dtype="float32",
                     message_dtype="float32",
                     checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    jt = JaxTrainer(jcfg, jax_split_data(*cols), ef)
    pt = Trainer(Config.from_dict(dataclasses.asdict(jcfg)), split_data(*cols),
                 ef, device="cpu")
    bridge.load_trainer_params(pt, jax.tree.map(np.asarray, jt.params))
    jmem, jidx = _fresh_epoch_state(jt.cfg)
    jmem = jax.tree.map(jnp.asarray, jmem)
    pmem, pidx = pt._fresh_state()
    out = {"jax": [], "port": []}
    for name in ("train", "val"):
        js = jt._streams[name]
        jmem, jidx, je = jnc.collect_source_embeddings(
            jt.cfg, js.n_batches, jt.params, jmem, jidx, jt.edge_feats, (),
            js.stream)
        valid = np.asarray(jt._host_streams[name]["valid"])
        out["jax"].append(np.asarray(je).reshape(-1, jt.cfg.hidden_dim)[valid])
        pmem, pidx, pe, waves = collect_source_embeddings(
            pt.cfg, pt.params, pmem, pidx, pt.edge_feats, pt._streams[name])
        assert waves > 0
        out["port"].append(pe.numpy()[pt._streams[name].host["valid"]])
    return out, (jmem, jidx), (pmem, pidx), pt.cfg


@pytest.mark.parametrize("leg", [0, 1], ids=["train", "val"])
def test_source_embeddings_match_jax(collected, leg):
    out, _, _, _ = collected
    got, want = out["port"][leg], out["jax"][leg]
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_replay_state_matches_jax(collected):
    _, (jmem, jidx), (pmem, pidx), cfg = collected
    np.testing.assert_allclose(pmem.memory.numpy(), np.asarray(jmem.memory),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pmem.last_update.numpy(),
                                  np.asarray(jmem.last_update))
    m, k = cfg.n_tppr, cfg.topk
    split = lambda d: (d[:, : 4 * m * k].reshape(-1, m, 4, k),
                       d[:, 4 * m * k:])
    assert_entries_close(*split(pidx.data.numpy()),
                         *split(np.asarray(jidx.data)))


def _port_decoder(jp) -> NodeDecoder:
    dec = NodeDecoder(jp["fc1"]["w"].shape[0], torch.Generator())
    dec.load_state_dict({f"{layer}.{key}": torch.from_numpy(
        np.array(jp[layer][key])) for layer in jp for key in jp[layer]})
    return dec


def _embs(n=300, dim=24, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    y = (x @ rng.randn(dim) > 0).astype(np.float32)
    return x, y


def test_decoder_matches_jax():
    jp = jnc.init_decoder(jax.random.PRNGKey(0), 24)
    x, _ = _embs()
    want = np.asarray(jax.jit(jnc.decoder_apply)(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_decoder(jp)(torch.from_numpy(x)).numpy()
    assert got.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_one_decoder_step_matches_jax():
    jp = jnc.init_decoder(jax.random.PRNGKey(1), 24)
    x, y = _embs()
    opt = optax.adam(1e-3)

    def loss_fn(p):
        logits = jnc.decoder_apply(p, jnp.asarray(x), None, dropout=0.0,
                                   train=True)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(logits,
                                                           jnp.asarray(y)))

    @jax.jit
    def step(p):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, _ = opt.update(grads, opt.init(p), p)
        return loss, optax.apply_updates(p, updates)

    loss, jp2 = step(jp)

    dec = _port_decoder(jp)
    adam = torch.optim.Adam(dec.parameters(), lr=1e-3)
    got = decoder_step(dec, adam, torch.from_numpy(x), torch.from_numpy(y),
                       dropout=0.0)
    assert abs(float(got) - float(loss)) <= 1e-6
    for layer in jp2:
        for key in jp2[layer]:
            np.testing.assert_allclose(
                getattr(dec, layer)[key].detach().numpy(),
                np.asarray(jp2[layer][key]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("ties", [False, True])
def test_auc_matches_jax(ties):
    jp = jnc.init_decoder(jax.random.PRNGKey(2), 24)
    x, y = _embs(seed=3)
    if ties:  # positives that share their embedding with a negative
        x[1::2] = x[0:-1:2]
        y[0::4], y[1::4] = 0.0, 1.0
    want = jnc.eval_node_classification(jp, jnp.asarray(x), jnp.asarray(y))
    got = eval_node_classification(_port_decoder(jp), torch.from_numpy(x),
                                   torch.from_numpy(y))
    assert abs(got - want) <= 1e-6, (got, want)


def test_pairwise_auc_counts_ties_half():
    probs = torch.tensor([0.1, 0.5, 0.5, 0.9, 0.3])
    labels = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0])
    # positives 0.5, 0.9, 0.3 against negatives 0.1, 0.5
    assert pairwise_auc(probs, labels) == (1.5 + 2 + 1) / 6
    assert np.isnan(pairwise_auc(probs, torch.zeros(5)))


def test_decoder_fits_separable_labels():
    x, y = _embs(n=600)
    dec = train_node_classifier(torch.from_numpy(x), torch.from_numpy(y),
                                seed=0, n_steps=300)
    assert eval_node_classification(dec, torch.from_numpy(x),
                                    torch.from_numpy(y)) > 0.9


def test_run_node_classification_protocol(tmp_path):
    """Link-train two epochs on a stream whose labels follow the source
    user, then the protocol: the three AUCs, the train one above chance;
    the replay runs through the wave path and counts its waves."""
    cols, ef = _cols(n_events=1200, label_users_frac=0.3)
    cfg = Config(**SMALL, checkpoint_dir=str(tmp_path))
    trainer = Trainer(cfg, split_data(*cols), ef, device="cpu")
    assert trainer.splits.train.labels.sum() > 0
    trainer.train_epoch()
    trainer.train_epoch()
    waves = trainer.index_waves
    out = run_node_classification(trainer, n_steps=300)
    assert set(out) == {"node_train_auc", "node_val_auc", "node_test_auc"}
    assert out["node_train_auc"] > 0.55, out
    assert np.isfinite(out["node_val_auc"]) and np.isfinite(
        out["node_test_auc"]), out
    assert trainer.index_waves > waves
