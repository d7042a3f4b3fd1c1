"""The lazy-update compaction (``--lazy_unique_cap``) of the port against the
JAX package's: the train forward's updater cell runs once per distinct
selected node, at most a static cap of them, and an epoch with a batch
past the cap is rerun per position.

Bars:
- ``make_lazy_plan`` on one batch's real queries, at the auto cap and at a
  cap the batch overflows: membership, overflow, the distinct ids, the
  position and query slots and the segment bounds equal to JAX's entry for
  entry, the id-sorted position order the same up to the order of equal
  ids (JAX's sort is not stable); per lane on the seed axis as alone;
- the dedup gather's backward (the sorted-segment sum) against JAX's
  custom VJP on the same cotangents: within 1e-6 of the largest entry,
  and against the plain gather's own backward within 1e-6 as well;
- Trainers with the auto cap and with a cap of 2 (every batch overflows:
  the epoch reruns per position) against the per-position Trainer, f32
  tables, two epochs and validate(): within JAX's bar
  (tests/test_train_loop.py:186-210, rtol 2e-4, atol 2e-5) — the first
  epoch's loss, the second's and val AP.

Port only: the overflow rerun is bit-equal to a per-position epoch from
the same start and logs JAX's warning; a windowed epoch logs JAX's error
instead; lane 1 of ``parallel_runs=2`` with the auto cap equals a
single-seed Trainer with seed 1 within 1e-5; under the pruning strategy
the auto cap's epoch agrees with per position at JAX's bar."""

import logging
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_aggregator_mean import _cfgs
from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_train import _jax_queries, _rows
from zebra_tpu.train import step as jstep
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.index.streaming import TpprQueries
from zebra_tpu_torch.train import phase, step
from zebra_tpu_torch.train.loop import Trainer

B = 40
PLAN_INT = ("jn", "j3", "start_pos", "end_pos")


def _plans(cap):
    jcfg, cfg = _cfgs("float32", aggregator="last", lazy_unique_cap=cap)
    _, (src, dst, neg, ts, _), rows = _rows(cfg, 1)
    nodes3 = np.concatenate([src, dst, neg]).astype(np.int32)
    jq = _jax_queries(jcfg, rows, ts)
    jplan = jax.jit(jstep.make_lazy_plan, static_argnums=0)(
        jcfg, jq, jnp.asarray(nodes3))
    q = phase.batch_queries(cfg, torch.from_numpy(rows), torch.from_numpy(ts))
    plan = step.make_lazy_plan(cfg, q, torch.from_numpy(nodes3))
    return cfg, q, nodes3, jplan, plan


@pytest.mark.parametrize("cap", [-1, 0, 16], ids=["auto", "off", "overflow"])
def test_plan_matches_jax_entry_for_entry(cap):
    cfg, q, _, jplan, plan = _plans(cap)
    np.testing.assert_array_equal(plan.in_sel.numpy(),
                                  np.asarray(jplan.in_sel))
    assert float(plan.overflow) == float(jplan.overflow) == float(cap == 16)
    if cap == 0:
        assert plan.uniq is None and jplan.uniq is None
        return
    n = int((np.asarray(jplan.uniq) < np.iinfo(np.int32).max).sum())
    uniq = plan.uniq.numpy()
    assert n == min(len(np.unique(q.nbr.numpy())), len(uniq))
    np.testing.assert_array_equal(uniq[:n], np.asarray(jplan.uniq)[:n])
    assert (uniq[n:] == np.iinfo(np.int64).max).all()
    np.testing.assert_array_equal(plan.gather_ids.numpy(),
                                  np.asarray(jplan.gather_ids))
    for f in PLAN_INT:
        np.testing.assert_array_equal(getattr(plan, f).numpy(),
                                      np.asarray(getattr(jplan, f)), f)
    ids = q.nbr.numpy().reshape(-1)
    np.testing.assert_array_equal(ids[plan.perm.numpy()],
                                  ids[np.asarray(jplan.perm)])


def test_plan_per_lane_equals_the_single_lane_plan():
    """Lane-moved ids [S, M, 3b, k] of two lanes (the second's queries a
    permutation of the first's) plan each lane as it would alone."""
    cfg, q, nodes3, _, _ = _plans(-1)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(3 * B))
    q2 = TpprQueries(*(x[:, perm] for x in q))
    n3 = [torch.from_numpy(nodes3), torch.from_numpy(nodes3)[perm]]
    off = cfg.n_nodes
    lanes = TpprQueries(*(torch.stack([a, b]) for a, b in zip(q, q2)))
    lanes = lanes._replace(nbr=lanes.nbr.long()
                           + torch.tensor([0, off]).view(2, 1, 1, 1))
    both = step.make_lazy_plan(cfg, lanes, torch.stack(n3).long()
                               + torch.tensor([[0], [off]]))
    for s, (qs, ns) in enumerate(((q, n3[0]), (q2, n3[1]))):
        alone = step.make_lazy_plan(cfg, qs, ns)
        shift = s * off
        assert torch.equal(both.in_sel[s], alone.in_sel)
        live = alone.uniq < torch.iinfo(torch.int64).max
        assert torch.equal(both.uniq[s][live], alone.uniq[live] + shift)
        assert torch.equal(both.gather_ids[s][live],
                           alone.gather_ids[live] + shift)
        for f in PLAN_INT:
            assert torch.equal(getattr(both, f)[s], getattr(alone, f)), f


def test_dedup_gather_backward_matches_jax():
    _, _, _, jplan, plan = _plans(-1)
    cap, d = plan.uniq.shape[0], 6
    rng = np.random.RandomState(1)
    rows_u = rng.randn(cap, d).astype(np.float32)
    g = rng.randn(*plan.jn.shape, d).astype(np.float32)
    out, vjp = jax.vjp(lambda r: jstep._dedup_gather(
        r, jplan.jn, jplan.perm, jplan.start_pos, jplan.end_pos),
        jnp.asarray(rows_u))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)
    x = torch.from_numpy(rows_u).requires_grad_(True)
    got = step.DedupGather.apply(x, plan.jn, plan.perm, plan.start_pos,
                                 plan.end_pos)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(g))
    scale = np.abs(want).max()
    assert np.abs(x.grad.numpy() - want).max() <= 1e-6 * scale
    plain = torch.from_numpy(rows_u).requires_grad_(True)
    plain[plan.jn].backward(torch.from_numpy(g))
    assert np.abs(x.grad.numpy() - plain.grad.numpy()).max() <= 1e-6 * scale


def _trainer(**kw):
    data, ef = synthetic_stream(n_events=800, n_users=40, n_items=40,
                                edge_dim=4, seed=0)
    splits = split_data(data.sources, data.destinations, data.timestamps,
                        data.edge_idxs, data.labels)
    cfg = Config(**{**dict(bs=50, index_chunk=200, node_dim=16, time_dim=16,
                           memory_dim=16, topk=5, alpha_list=(0.1,),
                           beta_list=(0.9,), lr=3e-3,
                           checkpoint_dir=tempfile.mkdtemp(),
                           memory_dtype="float32", message_dtype="float32"),
                    **kw})
    return Trainer(cfg, splits, ef, device="cpu")


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name, cap in (("off", 0), ("auto", -1), ("overflow", 2)):
        t = _trainer(lazy_unique_cap=cap)
        r1, r2 = t.train_epoch(), t.train_epoch()
        out[name] = (t, r1, r2, t.validate()[0])
    return out


@pytest.mark.parametrize("name", ["auto", "overflow"])
def test_caps_match_per_position_at_jax_bar(runs, name):
    off = runs["off"]
    got = runs[name]
    np.testing.assert_allclose(
        [got[1].loss, got[2].loss, got[3].ap],
        [off[1].loss, off[2].loss, off[3].ap], rtol=2e-4, atol=2e-5)
    assert got[0]._lazy_fallback == (name == "overflow")
    assert got[0]._lazy_compaction_active()


def test_overflow_rerun_is_bit_equal_to_per_position(runs):
    off, over = runs["off"], runs["overflow"]
    for i in (1, 2):
        np.testing.assert_array_equal(over[i].per_batch, off[i].per_batch)
    for key, v in off[0].params.state_dict().items():
        assert torch.equal(over[0].params.state_dict()[key], v), key
    for a, b in zip(over[0].mem, off[0].mem):
        assert torch.equal(a, b)


def test_overflow_logs_and_reruns(caplog):
    with caplog.at_level(logging.WARNING, logger="zebra_tpu_torch"):
        t = _trainer(lazy_unique_cap=2)
        r = t.train_epoch()
    assert "rerunning the epoch on the per-position path" in caplog.text
    assert r.overflow == 0.0 and t._lazy_fallback


def test_windowed_epoch_logs_the_error(caplog):
    t = _trainer(lazy_unique_cap=2)
    with caplog.at_level(logging.ERROR, logger="zebra_tpu_torch"):
        r = t.train_epoch(max_chunks=1)
    assert "overflowed during a windowed epoch" in caplog.text
    assert r.overflow == 1.0 and t._lazy_fallback
    assert t._chunk_cursor == 1


def test_seed_lane_with_the_auto_cap_equals_a_single_seed():
    kw = dict(lazy_unique_cap=-1, dropout=0.1, lr=1e-3)
    par = _trainer(parallel_runs=2, **kw)
    one = _trainer(seed=1, **kw)
    rp, r1 = par.train_epoch(), one.train_epoch()
    assert rp.overflow == r1.overflow == 0.0
    np.testing.assert_allclose(rp.per_batch[:, 1], r1.per_batch, rtol=0,
                               atol=1e-5)
    for key, v in one.params.state_dict().items():
        d = (par.params.state_dict()[key][1] - v).abs().max()
        assert float(d) <= 1e-5, key


def test_pruning_compaction_matches_per_position():
    """Under the pruning strategy the diffusion tower's BFS queries take the
    same plan: the auto cap against per position at JAX's bar."""
    prune = dict(tppr_strategy="pruning", n_degree=4, n_layer=2)
    auto, off = (_trainer(lazy_unique_cap=cap, **prune) for cap in (-1, 0))
    assert auto._lazy_compaction_active() and not off._lazy_compaction_active()
    ra, ro = auto.train_epoch(), off.train_epoch()
    assert ra.overflow == 0.0
    np.testing.assert_allclose(ra.per_batch[:, 0], ro.per_batch[:, 0],
                               rtol=2e-4, atol=2e-5)
