"""The port's wave-parallel index scan (zebra_tpu_torch/index/waves.py and
its scheduler, csrc/wave_schedule.cc) against the JAX package's scheduler
and wave scan, and against the port's sequential scan.

Bars: schedules identical; the wave scan bit-equal to the port's
sequential scan in the table and the extraction rows (the same plain merge
on the same rows, batched); against the JAX wave scan (XLA merge) the
merge tests' bar: identical entry sets, weights within 1e-5 relative
(XLA may contract a multiply-add, so near-equal entries can swap)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from zebra_tpu.index.streaming import TpprParams as JaxTpprParams
from zebra_tpu.index.streaming import TpprState as JaxTpprState
from zebra_tpu.index.waves import wave_flat_index as jax_wave_flat_index
from zebra_tpu.index.waves import wave_scan_chunk as jax_wave_scan_chunk
from zebra_tpu.native.ingest import wave_schedule as jax_wave_schedule
from zebra_tpu_torch.index import merge as pm
from zebra_tpu_torch.index import waves
from zebra_tpu_torch.index.layout import split_rows
from zebra_tpu_torch.index.streaming import (
    TpprParams,
    init_tppr_state,
    streaming_scan,
    unpack_queries,
)

N_NODES = 41


def _stream(seed, n=600, n_nodes=N_NODES, hot=True):
    """Events on a small node set (long dependency chains), node 1 hot in
    a third of them when ``hot``, with self-loops and negatives."""
    rs = np.random.RandomState(seed)
    src, dst, neg = (rs.randint(0, n_nodes, n).astype(np.int32)
                     for _ in range(3))
    if hot:
        src[rs.rand(n) < 0.3] = 1
    dst[::17] = src[::17]
    t = np.cumsum(rs.exponential(1.0, n)).astype(np.float32)
    eidx = np.arange(1, n + 1, dtype=np.int32)
    return src, dst, neg, t, eidx


@pytest.mark.parametrize("seed,cap", [(0, 64), (1, 8), (2, 1), (3, 200)])
def test_schedule_matches_jax(seed, cap):
    src, dst, neg, _, _ = _stream(seed, hot=seed % 2 == 0)
    got = waves.wave_schedule(src, dst, neg, N_NODES, cap)
    want = jax_wave_schedule(src, dst, neg, N_NODES, cap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    flat, n_waves = waves.wave_flat_index(src, dst, neg, N_NODES, cap)
    jflat, _ = jax_wave_flat_index(src, dst, neg, N_NODES, cap)
    np.testing.assert_array_equal(flat, jflat)
    assert n_waves == want[2]


@pytest.mark.parametrize("col,value", [(0, N_NODES), (1, -1), (2, N_NODES)])
def test_schedule_refuses_ids_out_of_range(col, value):
    cols = [c.copy() for c in _stream(0, n=20)[:3]]
    cols[col][11] = value
    with pytest.raises(ValueError, match="out of range"):
        waves.wave_schedule(*cols, N_NODES, 8)


def test_plan_waves_layout():
    """Waves are contiguous, node-disjoint and in stream order; unscheduled
    (invalid) events point at the zero row."""
    src, dst, neg, _, _ = _stream(4, n=300)
    valid = np.ones(300, bool)
    valid[::13] = False
    plan = waves.plan_waves(src, dst, neg, valid, N_NODES, 16, "cpu")
    order, inv = plan.order.numpy(), plan.inv.numpy()
    assert sorted(order) == list(np.flatnonzero(valid))
    assert (inv[~valid] == len(order)).all()
    np.testing.assert_array_equal(inv[order], np.arange(len(order)))
    for lo, hi in zip(plan.bounds[:-1], plan.bounds[1:]):
        ev = order[lo:hi]
        assert 0 < hi - lo <= 16 and (np.diff(ev) > 0).all()
        per_edge = [{int(src[i]), int(dst[i])} for i in ev]
        assert len(set().union(*per_edge)) == sum(map(len, per_edge))


def _run_port(cols, valid, params, cap, chunks=1):
    state = init_tppr_state(len(params.alpha), N_NODES, params.k, "cpu")
    rows = []
    n = len(cols[0])
    step_ = n // chunks
    for lo in range(0, n, step_):
        c = [x[lo: lo + step_] for x in cols]
        v = valid[lo: lo + step_]
        plan = waves.plan_waves(c[0], c[1], c[2], v, N_NODES, cap, "cpu")
        state, r = waves.wave_scan_chunk(state, params, *c, v, plan)
        rows.append(r)
    return state, torch.cat(rows)


@pytest.mark.parametrize("m,k,cap", [(2, 5, 64), (1, 3, 4), (3, 8, 16)])
def test_wave_scan_equals_sequential_scan(m, k, cap):
    """Bit for bit, over two chunks, with invalid events."""
    src, dst, neg, t, eidx = _stream(m + k)
    valid = np.ones(len(src), bool)
    valid[5::11] = False
    params = TpprParams.create((0.1, 0.2, 0.0)[:m], (0.05, 0.95, 0.5)[:m], k)
    state, rows = _run_port((src, dst, neg, t, eidx), valid, params, cap, 2)

    seq = init_tppr_state(m, N_NODES, k, "cpu")
    seq, q = streaming_scan(seq, params, src, dst, neg, t, eidx, valid)
    assert torch.equal(state.data, seq.data)
    got = unpack_queries(rows, torch.from_numpy(t), m, k)
    v = torch.from_numpy(valid)
    for g, w in zip(got, q):
        assert torch.equal(g[v], w[v])
    assert not rows[~v].any()


def test_wave_scan_matches_jax():
    m, k, cap = 2, 5, 16
    src, dst, neg, t, eidx = _stream(9)
    valid = np.ones(len(src), bool)
    valid[-40:] = False
    params = TpprParams.create((0.1, 0.1), (0.05, 0.95), k)
    state, rows = _run_port((src, dst, neg, t, eidx), valid, params, cap)

    flat_v, n_waves = jax_wave_flat_index(src[valid], dst[valid], neg[valid],
                                          N_NODES, cap)
    flat = np.full(len(src), n_waves * cap, np.int32)
    flat[valid] = flat_v
    jstate = JaxTpprState(jnp.zeros((N_NODES, m * (4 * k + 1)), jnp.float32))
    jstate, jrows = jax_wave_scan_chunk(
        jstate, JaxTpprParams.create((0.1, 0.1), (0.05, 0.95), k),
        *(jnp.asarray(a) for a in (src, dst, neg, t, eidx, valid, flat)),
        n_waves, cap)
    for got, want in ((state.data, np.asarray(jstate.data)),
                      (rows, np.asarray(jrows))):
        gf, gn = split_rows(got, m, k)
        wf, wn = split_rows(torch.from_numpy(np.array(want)), m, k)
        assert_entries_close(gf.numpy(), gn.numpy(), wf.numpy(), wn.numpy())


def test_wave_scan_merges_once_per_wave(monkeypatch):
    """Each wave is one merge call on its slice of contiguous lanes."""
    calls = []
    real = pm.merge_both_reference

    def spy(rows, *args):
        calls.append(rows.shape[0])
        return real(rows, *args)

    monkeypatch.setattr(pm, "merge_both_reference", spy)
    src, dst, neg, t, eidx = _stream(5, n=200)
    valid = np.ones(200, bool)
    plan = waves.plan_waves(src, dst, neg, valid, N_NODES, 32, "cpu")
    waves.wave_scan_chunk(init_tppr_state(1, N_NODES, 4, "cpu"),
                          TpprParams.create((0.1,), (0.9,), 4),
                          src, dst, neg, t, eidx, valid, plan)
    assert calls == list(np.diff(plan.bounds)) and sum(calls) == 200
