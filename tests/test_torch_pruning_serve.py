"""Serving under the pruning strategy (zebra_tpu_torch/serve.py with an
adjacency index) against the JAX package's LinkPredictor and
EnsemblePredictor built from the same params, memory, adjacency index and
base stream, after the cases of tests/test_serve.py:105-170 and :204-245;
and the node-id check of ``score``, ``member_scores`` and ``observe``.

Bars, against JAX after three ``observe`` batches (each folded into the
index at ``rebuild_every=1``) and a ``score``:
- the queries of the scored candidates: the same entries, weights within
  1e-5 relative (test_torch_pruning.py's bar);
- f32 tables: memory within 1e-5, scores within 1e-5 (test_torch_serve.py's
  bars); bf16 tables: memory within 1e-2, scores within 2e-3 (the same);
- the ensemble, f32: member scores within 1e-6 and ``score`` their mean
  (test_torch_ensemble.py's bars).

Port only: a brand-new edge is visible to ``score``'s queries after the
fold; ``rebuild_every`` defers the fold until ``flush_index()``; a
predictor without a base stream warns once and keeps its index;
``from_checkpoint`` of a pruning state file needs ``events`` and then
scores as ``from_trainer`` does, a seed-parallel one as one seed or the
ensemble; the CLI trains under pruning and its state file serves. Node
ids of N or -1 raise ``ValueError`` before any upload."""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_cli import _argv, _toy
from tests.test_torch_pruning import assert_same_entries
from tests.test_torch_pruning_trainer import PRUNING, SMALL, _cols
from zebra_tpu.config import Config as JaxConfig
from zebra_tpu.data.synthetic import synthetic_stream
from zebra_tpu.index.neighbor_finder import build_neighbor_index as jax_build
from zebra_tpu.models.memory import init_memory
from zebra_tpu.models.tgn import init_tgn_params
from zebra_tpu.serve import EnsemblePredictor as JaxEnsemblePredictor
from zebra_tpu.serve import LinkPredictor as JaxLinkPredictor
from zebra_tpu_torch import bridge, cli
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.index.streaming import init_tppr_state
from zebra_tpu_torch.serve import EnsemblePredictor, LinkPredictor
from zebra_tpu_torch.train.loop import Trainer

B, BASE, S = 40, 200, 3


def _pair(dtype="float32", n_models=0):
    """(stream columns, JAX predictor, port predictor): the same JAX init
    params (``n_models`` stacked sets: an ensemble), zeroed memory, and the
    adjacency index of the first BASE events with those events as the
    base stream."""
    data, ef = synthetic_stream(400, 30, 30, edge_dim=8, seed=0)
    jcfg = JaxConfig(
        node_dim=16, time_dim=16, memory_dim=16, topk=5,
        n_nodes=int(max(data.sources.max(), data.destinations.max())) + 1,
        n_edges=int(data.edge_idxs.max()) + 1, edge_dim=8,
        memory_dtype=dtype, message_dtype=dtype, **PRUNING)
    cfg = Config.from_dict(dataclasses.asdict(jcfg))
    jmem = init_memory(jcfg.n_nodes, jcfg.memory_dim, jcfg.msg_table_dim,
                       msg_dtype=jnp.dtype(dtype), mem_dtype=jnp.dtype(dtype))
    if n_models:
        jp = jax.tree.map(lambda *x: jnp.stack(x), *(
            init_tgn_params(jax.random.PRNGKey(s), jcfg)
            for s in range(n_models)))
        jmem = jax.tree.map(lambda x: jnp.stack([x] * n_models), jmem)
        jcls, pcls = JaxEnsemblePredictor, EnsemblePredictor
    else:
        jp = init_tgn_params(jax.random.PRNGKey(0), jcfg)
        jcls, pcls = JaxLinkPredictor, LinkPredictor
    cols = (data.sources, data.destinations,
            data.timestamps.astype(np.float32), data.edge_idxs)
    base = tuple(c[:BASE] for c in cols)
    ref = jcls(jcfg, jp, jmem, (), jnp.asarray(ef),
               jax_build(*base, jcfg.n_nodes), events=base)
    port = pcls(cfg, bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                              "cpu"),
                bridge.memory_from_numpy(jax.tree.map(np.asarray, jmem), cfg,
                                         "cpu"),
                None, ef, build_neighbor_index(*base, cfg.n_nodes, "cpu"),
                base, device="cpu")
    return tuple(c[BASE:] for c in cols), ref, port


def _observe_three(ref, port, cols):
    for lo in range(0, 3 * B, B):
        batch = [c[lo: lo + B] for c in cols]
        ref.observe(*batch)
        port.observe(*batch)
    return [c[3 * B: 4 * B] for c in cols[:3]]


@pytest.mark.parametrize("dtype,mem_atol,score_atol", [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 1e-2, 2e-3),
])
def test_observe_then_score_matches_jax(dtype, mem_atol, score_atol):
    cols, ref, port = _pair(dtype)
    q = _observe_three(ref, port, cols)
    assert port._pending_n == ref._pending_n == 0
    assert port.index_state is None
    assert port.nbr_index.ts.shape[0] == 2 * (BASE + 3 * B)
    got = [x.numpy() for x in port._queries(*(torch.as_tensor(np.asarray(c))
                                              for c in q), with_neg=False)]
    want = [np.asarray(x) for x in ref._queries(*q, with_neg=False)]
    assert_same_entries(got, want)
    pm = bridge.memory_to_numpy(port.mem)
    assert np.abs(pm.memory).max() > 0
    np.testing.assert_allclose(pm.memory, np.asarray(ref.mem.memory,
                                                     np.float32),
                               rtol=0, atol=mem_atol)
    np.testing.assert_array_equal(pm.last_update,
                                  np.asarray(ref.mem.last_update))
    scores = port.score(*q)
    assert scores.shape == (B,) and np.isfinite(scores).all()
    np.testing.assert_allclose(scores, np.asarray(ref.score(*q)), rtol=0,
                               atol=score_atol)


def test_ensemble_matches_jax():
    cols, ref, port = _pair(n_models=S)
    assert port.n_models == ref.n_models == S
    q = _observe_three(ref, port, cols)
    members = port.member_scores(*q)
    assert members.shape == (S, B) and np.isfinite(members).all()
    np.testing.assert_allclose(members, np.asarray(ref.member_scores(*q)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.score(*q), np.asarray(ref.score(*q)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.score(*q), members.mean(0), rtol=0,
                               atol=1e-7)
    assert port.nbr_index.ts.shape[0] == 2 * (BASE + 3 * B)


def _visible(pred, src, eidx, t) -> bool:
    """Whether edge ``eidx`` is among the T-PPR entries of ``src`` at t."""
    q = pred._queries(torch.tensor([src]), torch.tensor([src]),
                      torch.tensor([t]), with_neg=False)
    return bool((q.eidx[:, 0, :] == eidx).any())


def test_observe_folds_a_new_edge_into_the_index():
    cols, _, port = _pair()
    t_new = float(cols[2][-1]) + 100.0
    eidx_new = int(cols[3].max()) + 1
    assert not _visible(port, 1, eidx_new, t_new + 1.0)
    port.observe([1], [59], [t_new], [eidx_new])
    assert port._pending_n == 0
    assert _visible(port, 1, eidx_new, t_new + 1.0)
    assert not _visible(port, 1, eidx_new, t_new)   # strictly before the cut
    assert np.isfinite(port.score([1], [59], [t_new + 1.0])).all()


def test_rebuild_every_defers_the_fold_until_flush():
    cols, _, port = _pair()
    port.rebuild_every = 1000
    t_new = float(cols[2][-1]) + 100.0
    eidx_new = int(cols[3].max()) + 1
    port.observe([1], [59], [t_new], [eidx_new])
    assert port._pending_n == 1
    assert not _visible(port, 1, eidx_new, t_new + 1.0)
    port.flush_index()
    assert port._pending_n == 0 and _visible(port, 1, eidx_new, t_new + 1.0)


def test_predictor_without_events_warns_once(caplog):
    cols, _, port = _pair()
    bare = LinkPredictor(port.cfg, port.params, port.mem, None,
                         port.edge_feats, port.nbr_index, device="cpu")
    before = bare.nbr_index
    t_new = float(cols[2][-1]) + 1.0
    with caplog.at_level(logging.WARNING, logger="zebra_tpu_torch"):
        bare.observe([1], [59], [t_new], [int(cols[3].max()) + 1])
        bare.observe([2], [58], [t_new + 1], [int(cols[3].max()) + 2])
    warned = [r for r in caplog.records if "NOT the adjacency" in r.message]
    assert len(warned) == 1
    assert bare.nbr_index is before and bare._pending_n == 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cols, ef = _cols()
    trainer = Trainer(Config(**SMALL, checkpoint_dir=str(tmp)),
                      split_data(*cols), ef, device="cpu")
    trainer.train_epoch()
    path = str(tmp / "pruning.state.ckpt")
    trainer.save_state(path)
    return trainer, path


def test_from_checkpoint_needs_events_and_scores_as_from_trainer(trained):
    trainer, path = trained
    ef = trainer.edge_feats.numpy()
    with pytest.raises(ValueError, match="adjacency"):
        LinkPredictor.from_checkpoint(path, edge_feats=ef, device="cpu")
    fu = trainer.splits.full
    served = LinkPredictor.from_checkpoint(
        path, edge_feats=ef, device="cpu",
        events=(fu.sources, fu.destinations, fu.timestamps, fu.edge_idxs))
    live = LinkPredictor.from_trainer(trainer)
    te = trainer.splits.test
    q = (te.sources[:64], te.destinations[:64], te.timestamps[:64])
    np.testing.assert_array_equal(served.score(*q), live.score(*q))
    for p in (served, live):
        p.observe(te.sources[64:128], te.destinations[64:128],
                  te.timestamps[64:128], te.edge_idxs[64:128])
    q = (te.sources[128:], te.destinations[128:], te.timestamps[128:])
    np.testing.assert_array_equal(served.score(*q), live.score(*q))
    assert trainer.full_nbr_index.ts.shape[0] == 2 * fu.n_interactions


def test_seed_parallel_state_file_serves_a_seed_or_the_ensemble(tmp_path):
    """A ``parallel_runs=2`` pruning state file: ``ensemble=True`` scores
    as ``EnsemblePredictor.from_trainer`` does, bit for bit, and member s
    as ``run_index=s`` within 1e-6 (test_torch_ensemble.py's bar); the
    members share one adjacency index, which one fold extends."""
    cols, ef = _cols()
    trainer = Trainer(Config(**SMALL, parallel_runs=2,
                             checkpoint_dir=str(tmp_path)),
                      split_data(*cols), ef, device="cpu")
    trainer.train_epoch()
    path = str(tmp_path / "seeds.state.ckpt")
    trainer.save_state(path)
    fu, te = trainer.splits.full, trainer.splits.test
    events = (fu.sources, fu.destinations, fu.timestamps, fu.edge_idxs)
    served = LinkPredictor.from_checkpoint(path, edge_feats=ef, device="cpu",
                                           events=events, ensemble=True)
    live = EnsemblePredictor.from_trainer(trainer)
    q = (te.sources[:64], te.destinations[:64], te.timestamps[:64])
    np.testing.assert_array_equal(served.score(*q), live.score(*q))
    members = served.member_scores(*q)
    for s in range(2):
        one = LinkPredictor.from_checkpoint(path, edge_feats=ef, device="cpu",
                                            events=events, run_index=s)
        np.testing.assert_allclose(one.score(*q), members[s], rtol=0,
                                   atol=1e-6)
    n = served.nbr_index.ts.shape[0]
    served.observe(te.sources[64:96], te.destinations[64:96],
                   te.timestamps[64:96], te.edge_idxs[64:96])
    assert served.nbr_index.ts.shape[0] == n + 64


def test_cli_trains_under_pruning_and_its_state_file_serves(tmp_path):
    _toy(tmp_path)
    (trainer, results), = cli.main(_argv(
        tmp_path, "toy", "--n_epoch", "1", "--state_every", "1",
        "--tppr_strategy", "pruning", "--n_degree", "4", "--n_layer", "2"))
    name = trainer.cfg.run_name()
    assert "_pruning_" in name and "_width_4_depth_2_" in name
    assert np.isfinite(results["test_ap"]) and trainer.index_waves == 0
    fu = trainer.splits.full
    served = LinkPredictor.from_checkpoint(
        str(tmp_path / "ckpt" / (name + ".state.ckpt")),
        edge_feats=trainer.edge_feats.numpy(), device="cpu",
        events=(fu.sources, fu.destinations, fu.timestamps, fu.edge_idxs))
    te = trainer.splits.test
    assert np.isfinite(served.score(te.sources, te.destinations,
                                    te.timestamps)).all()


def _streaming(n_models):
    """A streaming predictor (or ensemble) over init params."""
    data, ef = synthetic_stream(100, 30, 30, edge_dim=8, seed=0)
    cfg = Config(node_dim=16, time_dim=16, memory_dim=16, topk=5,
                 n_nodes=64, n_edges=101, edge_dim=8)
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in (
        "node_dim", "time_dim", "memory_dim", "topk", "n_nodes", "n_edges",
        "edge_dim")})
    jp = [jax.tree.map(np.asarray, init_tgn_params(jax.random.PRNGKey(s),
                                                   jcfg))
          for s in range(max(1, n_models))]
    if n_models:
        jp = [jax.tree.map(lambda *x: np.stack(x), *jp)]
    mem = bridge.memory_from_numpy(jax.tree.map(np.asarray, init_memory(
        cfg.n_nodes, cfg.memory_dim, cfg.msg_table_dim)), cfg, "cpu")
    if n_models:
        mem = type(mem)(*(torch.stack([x] * n_models) for x in mem))
    cls = EnsemblePredictor if n_models else LinkPredictor
    return cls(cfg, bridge.params_from_numpy(jp[0], "cpu"), mem,
               init_tppr_state(cfg.n_tppr, cfg.n_nodes, cfg.topk, "cpu"), ef,
               device="cpu")


CALLERS = {
    "score": (0, lambda p: p.score),
    "ensemble_score": (S, lambda p: p.score),
    "member_scores": (S, lambda p: p.member_scores),
    "observe": (0, lambda p: lambda s, d, t: p.observe(s, d, t, [1] * len(s))),
}


@pytest.mark.parametrize("strategy", ["streaming", "pruning"])
@pytest.mark.parametrize("bad", ["n", -1])
@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_node_ids_outside_the_tables_raise(strategy, bad, caller):
    n_models, call = CALLERS[caller]
    if strategy == "pruning":
        pred = _pair(n_models=n_models)[2]
    else:
        pred = _streaming(n_models)
    n = pred.cfg.n_nodes
    bad = n if bad == "n" else bad
    mem = [x.clone() for x in pred.mem]
    for src, dst in (([1, bad], [2, 3]), ([1, 2], [bad, 3])):
        with pytest.raises(ValueError,
                           match=rf"node ids must lie in \[0, {n}\)"):
            call(pred)(src, dst, [1.0, 2.0])
    # nothing moved, and a request in range still runs
    assert all(torch.equal(x, y) for x, y in zip(mem, pred.mem))
    call(pred)([1, n - 1], [2, 0], [1.0, 2.0])
