"""The message-source flags (``--use_source_embedding_in_message``,
``--use_destination_embedding_in_message``) of the port against the JAX
package's: a message's sender or receiver part is the batch's embedding
(``hidden_dim`` wide) instead of the memory row, and the sender part is
then stored (the compact layout is off).

Bars:
- ``Config.message_dim``, ``msg_table_dim`` and ``cell_input_dim``: equal
  to JAX's for every flag, tower and ensemble size;
- ``_store_messages`` with each flag, last and mean, from the same memory
  and embeddings (the cases of tests/test_message_sources.py:28-99):
  message rows within 1e-6 (the time encoding's cosine), times, counts
  and flags exact;
- serving, with mean, mlp and both flags, f32 tables, three ``observe``
  batches then ``score`` against JAX's predictor from the same state:
  memory and scores within 1e-5 (test_torch_serve.py's f32 bars), messages
  within 1e-5, last_update exact; under the streaming strategy the index
  at test_torch_merge.py's bar, each observe call one extracting scan;
  under pruning and for graph_attention the adjacency folded before the
  forward, as JAX folds it; an ensemble of three: member scores within
  1e-6 (test_torch_ensemble.py's bar).

Port only: a state file written under one flag setting is refused under
another, in ``state_compat_diff``'s words; ``from_checkpoint`` rebuilds
the layout from the stored config."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_aggregator_mean import _cfgs
from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from tests.test_torch_train import _memory, _params, _protocol_batch
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.neighbor_finder import build_neighbor_index as jax_build
from zebra_tpu.index.streaming import fill_scan as jax_fill
from zebra_tpu.index.streaming import init_tppr_state
from zebra_tpu.index.streaming import TpprParams as JaxTpprParams
from zebra_tpu.models.memory import init_memory
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu.serve import EnsemblePredictor as JaxEnsemblePredictor
from zebra_tpu.serve import LinkPredictor as JaxLinkPredictor
from zebra_tpu.train import step as jstep
from zebra_tpu_torch import bridge
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.index import scan
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor
from zebra_tpu_torch.train import step
from zebra_tpu_torch.train.loop import Trainer

B, BASE, S = 40, 200, 3
FLAGS = dict(use_source_embedding_in_message=True,
             use_destination_embedding_in_message=True)
ALL = dict(aggregator="mean", message_function="mlp", **FLAGS)


@pytest.mark.parametrize("kw", [
    {}, dict(use_source_embedding_in_message=True),
    dict(use_destination_embedding_in_message=True), FLAGS,
    dict(FLAGS, message_function="mlp"),
    dict(FLAGS, alpha_list=(0.1, 0.1, 0.2), beta_list=(0.5, 0.9, 0.95)),
    dict(FLAGS, embedding_module="graph_attention"),
    dict(use_source_embedding_in_message=True, embedding_module="time"),
], ids=["none", "src", "dst", "both", "both-mlp", "three-members",
        "graph_attention", "time"])
def test_message_dim_follows_flags(kw):
    jcfg = JaxConfig(node_dim=8, time_dim=8, memory_dim=8, edge_dim=2, **kw)
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    for f in ("hidden_dim", "message_dim", "compact_messages",
              "msg_table_dim", "cell_input_dim"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


@pytest.mark.parametrize("agg", ["last", "mean"])
@pytest.mark.parametrize("flags", ["src", "dst", "both"])
def test_store_messages_uses_embeddings(flags, agg):
    kw = dict(use_source_embedding_in_message=flags != "dst",
              use_destination_embedding_in_message=flags != "src")
    jcfg, cfg = _cfgs("float32", aggregator=agg, **kw)
    jp, pp = _params(jcfg)
    jmem, pmem = _memory(cfg, "float32")
    ef = np.random.RandomState(4).randn(401, 8).astype(np.float32)
    src, dst, t, eidx, valid = _protocol_batch(cfg.n_nodes)
    rng = np.random.RandomState(5)
    emb = [rng.randn(B, cfg.hidden_dim).astype(np.float32) for _ in "sd"]
    jm = jax.jit(jstep._store_messages, static_argnums=0)(
        jcfg, jp, jmem, jnp.asarray(ef),
        *(jnp.asarray(a) for a in (src, dst, t, eidx, valid, *emb)))
    tv = torch.from_numpy
    step._store_messages(cfg, pp, pmem, tv(ef), tv(src), tv(dst), tv(t),
                         tv(eidx), tv(valid), None, *map(tv, emb))
    assert pmem.messages.shape[1] == cfg.msg_table_dim + 1
    np.testing.assert_allclose(pmem.messages.numpy(), np.asarray(jm.messages),
                               rtol=0, atol=1e-6)
    for f in ("last_update", "msg_ts", "msg_count"):
        np.testing.assert_array_equal(getattr(pmem, f).numpy(),
                                      np.asarray(getattr(jm, f)), f)


def _pair(kind, n_models=0):
    """(the stream after the base events, JAX predictor, port predictor)
    at ALL's options, f32 tables: the same JAX init params (``n_models``
    stacked sets: an ensemble), zeroed memory, and the index of the first
    BASE events (streaming: filled by the JAX scan; pruning and
    graph_attention: the adjacency with those events as the base
    stream)."""
    data, ef = synthetic_stream(400, 30, 30, edge_dim=8, seed=0)
    tower = dict(streaming=dict(alpha_list=(0.1, 0.1),
                                beta_list=(0.05, 0.95)),
                 pruning=dict(tppr_strategy="pruning", n_degree=5, n_layer=2,
                              alpha_list=(0.1, 0.1), beta_list=(0.5, 0.95)),
                 graph_attention=dict(embedding_module="graph_attention",
                                      n_degree=4, n_layer=1))[kind]
    jcfg = JaxConfig(
        node_dim=16, time_dim=16, memory_dim=16, topk=5,
        n_nodes=int(max(data.sources.max(), data.destinations.max())) + 1,
        n_edges=int(data.edge_idxs.max()) + 1, edge_dim=8,
        memory_dtype="float32", message_dtype="float32", **tower, **ALL)
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    jmem = init_memory(jcfg.n_nodes, jcfg.memory_dim, jcfg.msg_table_dim,
                       msg_dtype=jnp.float32, mem_dtype=jnp.float32)
    keys = range(n_models) if n_models else [0]
    jp = [init_tgn_params(jax.random.PRNGKey(s), jcfg) for s in keys]
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs)
    base = tuple(c[:BASE] for c in cols)
    jidx, pidx, jnbr, pnbr, events = (), None, (), None, None
    if kind == "streaming":
        jidx = init_tppr_state(jcfg.n_tppr, jcfg.n_nodes, jcfg.topk)
        jidx = jax_fill(jidx, JaxTpprParams.create(
            jcfg.alpha_list, jcfg.beta_list, jcfg.topk),
            *(jnp.asarray(c) for c in base), jnp.ones(BASE, bool))
        pidx = bridge.tppr_from_numpy(jax.tree.map(np.asarray, jidx), "cpu")
    else:
        jnbr = jax_build(*base, jcfg.n_nodes)
        pnbr = build_neighbor_index(*base, cfg.n_nodes, "cpu")
        events = base
    if n_models:
        jp = jax.tree.map(lambda *x: jnp.stack(x), *jp)
        jmem = jax.tree.map(lambda x: jnp.stack([x] * n_models), jmem)
        jcls, pcls = JaxEnsemblePredictor, EnsemblePredictor
    else:
        jp = jp[0]
        jcls, pcls = JaxLinkPredictor, LinkPredictor
    ref = jcls(jcfg, jp, jmem, jidx, jnp.asarray(ef), jnbr, events=events)
    port = pcls(cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"),
                bridge.memory_from_numpy(jax.tree.map(np.asarray, jmem), cfg,
                                         "cpu"),
                pidx, ef, pnbr, events, device="cpu")
    return tuple(c[BASE:] for c in cols), ref, port


def _observe_three(ref, port, cols):
    for lo in range(0, 3 * B, B):
        batch = [c[lo: lo + B] for c in cols]
        ref.observe(*batch)
        port.observe(*batch)
    return [c[3 * B: 4 * B] for c in cols[:3]]


@pytest.mark.parametrize("kind", ["streaming", "pruning", "graph_attention"])
def test_observe_then_score_matches_jax(kind, monkeypatch):
    cols, ref, port = _pair(kind)
    extracting = []
    real = scan.scan_reference
    monkeypatch.setattr(scan, "scan_reference", lambda *a, **k: (
        extracting.append(k.get("extract", True)), real(*a, **k))[1])
    q = _observe_three(ref, port, cols)
    assert extracting == ([True] * 3 if kind == "streaming" else [])
    if kind == "streaming":
        m, k = ref.cfg.n_tppr, ref.cfg.topk
        split = lambda d: (d[:, : 4 * m * k].reshape(-1, m, 4, k),
                           d[:, 4 * m * k:])
        assert_entries_close(
            *split(bridge.tppr_to_numpy(port.index_state).data),
            *split(np.asarray(ref.index_state.data)))
    else:
        assert port.nbr_index.ts.shape[0] == 2 * (BASE + 3 * B)
    got, want = bridge.memory_to_numpy(port.mem), ref.mem
    assert got.messages.shape[1] == port.cfg.message_dim + 1
    assert np.abs(got.memory).max() > 0
    for f in ("memory", "messages"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(got.last_update,
                                  np.asarray(want.last_update))
    scores = port.score(*q)
    assert scores.shape == (B,) and np.isfinite(scores).all()
    np.testing.assert_allclose(scores, np.asarray(ref.score(*q)), rtol=0,
                               atol=1e-5)


def test_ensemble_matches_jax():
    cols, ref, port = _pair("streaming", n_models=S)
    q = _observe_three(ref, port, cols)
    members = port.member_scores(*q)
    assert members.shape == (S, B) and np.isfinite(members).all()
    np.testing.assert_allclose(members, np.asarray(ref.member_scores(*q)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        bridge.memory_to_numpy(port.mem, n_seeds=S).memory,
        np.asarray(ref.mem.memory), rtol=0, atol=1e-5)


def _trainer(tmp_path, **kw):
    data, ef = synthetic_stream(400, 30, 30, edge_dim=4, seed=0)
    splits = split_data(data.sources, data.destinations, data.timestamps,
                        data.edge_idxs, data.labels)
    cfg = Config(bs=50, index_chunk=200, node_dim=8, time_dim=8,
                 memory_dim=8, topk=4, alpha_list=(0.1, 0.1),
                 beta_list=(0.05, 0.95), checkpoint_dir=str(tmp_path), **kw)
    return Trainer(cfg, splits, ef, device="cpu"), ef


def test_state_file_is_refused_across_flags(tmp_path):
    flagged, ef = _trainer(tmp_path, **FLAGS)
    flagged.train_epoch()
    path = str(tmp_path / "flags.state.ckpt")
    flagged.save_state(path)
    plain, _ = _trainer(tmp_path)
    with pytest.raises(ValueError) as err:
        plain.restore_state(path)
    want = Config.state_compat_diff(flagged.cfg, plain.cfg)
    assert want == [
        "use_source_embedding_in_message: checkpoint=True vs live=False",
        "use_destination_embedding_in_message: checkpoint=True vs "
        "live=False"]
    for line in want:
        assert line in str(err.value)
    served = LinkPredictor.from_checkpoint(path, edge_feats=ef, device="cpu")
    assert served.cfg.message_dim == flagged.cfg.message_dim
    assert served.mem.messages.shape == flagged.mem.messages.shape
    by_hand = LinkPredictor.from_trainer(flagged)
    fu = flagged.splits.full
    sl = slice(300, 340)
    args = (fu.sources[sl], fu.destinations[sl], fu.timestamps[sl])
    np.testing.assert_array_equal(served.score(*args), by_hand.score(*args))

