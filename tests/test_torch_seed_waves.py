"""The port's multi-negative wave scan (zebra_tpu_torch/index/waves.py and
csrc/wave_schedule.cc's zt_wave_schedule_multi): one scan of a chunk that
extracts one negative per seed, for the seed-parallel Trainer.

Bars: the schedule of [S, E] negatives identical to the JAX package's
scheduler, and [1, E] identical to [E]; the rows [E, 2+S, F] against the
JAX wave scan with [E, S] negatives at the merge tests' bar (identical entry
sets, weights within 1e-5 relative); negative block s bit-equal to a
single-negative scan with negative column s (the scan is exact under any
schedule), and the table bit-equal to it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from tests.test_torch_waves import N_NODES, _stream
from zebra_tpu.index.streaming import TpprParams as JaxTpprParams
from zebra_tpu.index.streaming import TpprState as JaxTpprState
from zebra_tpu.index.waves import wave_flat_index as jax_wave_flat_index
from zebra_tpu.index.waves import wave_scan_chunk as jax_wave_scan_chunk
from zebra_tpu.native.ingest import wave_schedule as jax_wave_schedule
from zebra_tpu_torch.index import waves
from zebra_tpu_torch.index.layout import split_rows
from zebra_tpu_torch.index.streaming import TpprParams, init_tppr_state

S = 3


def _negs(seed, n, n_seeds=S):
    """[S, E] negatives, one row per seed."""
    return np.random.RandomState(100 + seed).randint(
        0, N_NODES, (n_seeds, n)).astype(np.int32)


@pytest.mark.parametrize("seed,cap", [(0, 64), (1, 8), (2, 1)])
def test_multi_negative_schedule_matches_jax(seed, cap):
    src, dst, _, _, _ = _stream(seed, hot=seed % 2 == 0)
    negs = _negs(seed, len(src))
    got = waves.wave_schedule(src, dst, negs, N_NODES, cap)
    want = jax_wave_schedule(src, dst, negs, N_NODES, cap)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
    # more reads to order: never fewer waves than any one negative's
    assert got[2] >= max(waves.wave_schedule(src, dst, negs[s], N_NODES,
                                             cap)[2] for s in range(S))


@pytest.mark.parametrize("seed", [0, 3])
def test_one_row_of_negatives_is_the_single_schedule(seed):
    src, dst, neg, _, _ = _stream(seed)
    one = waves.wave_schedule(src, dst, neg[None], N_NODES, 16)
    single = waves.wave_schedule(src, dst, neg, N_NODES, 16)
    for a, b in zip(one[:2], single[:2]):
        np.testing.assert_array_equal(a, b)
    assert one[2] == single[2]


def test_multi_negative_schedule_refuses_bad_input():
    src, dst, _, _, _ = _stream(0, n=20)
    negs = _negs(0, 20)
    negs[2, 7] = N_NODES
    with pytest.raises(ValueError, match="out of range"):
        waves.wave_schedule(src, dst, negs, N_NODES, 8)
    with pytest.raises(ValueError, match="same edges"):
        waves.wave_schedule(src, dst, negs[:, :19], N_NODES, 8)


def _scan(cols, neg, valid, params, cap):
    """The port's wave scan of one chunk, ``neg`` [E] or [E, S]."""
    state = init_tppr_state(len(params.alpha), N_NODES, params.k, "cpu")
    src, dst, t, eidx = cols
    plan = waves.plan_waves(src, dst, neg, valid, N_NODES, cap, "cpu")
    return waves.wave_scan_chunk(state, params, src, dst, neg, t, eidx,
                                 valid, plan) + (plan,)


@pytest.fixture(scope="module")
def multi():
    """(columns, negatives [E, S], valid, params, the port's state, rows
    and plan)."""
    src, dst, _, t, eidx = _stream(7)
    negs = np.ascontiguousarray(_negs(7, len(src)).T)
    valid = np.ones(len(src), bool)
    valid[-30:] = False
    valid[4::19] = False
    params = TpprParams.create((0.1, 0.1), (0.05, 0.95), 5)
    cols = (src, dst, t, eidx)
    return (cols, negs, valid, params) + _scan(cols, negs, valid, params, 16)


def test_multi_negative_rows_have_one_block_per_seed(multi):
    cols, negs, valid, params, state, rows, plan = multi
    assert rows.shape == (len(cols[0]), 2 + S, state.data.shape[1])
    assert not rows[~torch.from_numpy(valid)].any()
    flat, n_waves = waves.wave_flat_index(
        cols[0][valid], cols[1][valid], negs[valid].T, N_NODES, 16)
    assert plan.n_waves == n_waves


@pytest.mark.parametrize("s", range(S))
def test_negative_block_equals_a_single_negative_scan(multi, s):
    """Block 2+s holds what a scan with seed s's negatives alone extracts,
    though the two schedules differ; src, dst and the table likewise."""
    cols, negs, valid, params, state, rows, plan = multi
    one_state, one_rows, one_plan = _scan(cols, negs[:, s].copy(), valid,
                                          params, 16)
    assert torch.equal(rows[:, [0, 1, 2 + s]], one_rows)
    assert torch.equal(state.data, one_state.data)


def test_multi_negative_scan_matches_jax(multi):
    cols, negs, valid, params, state, rows, _ = multi
    src, dst, t, eidx = cols
    m, k, cap = 2, 5, 16
    flat_v, n_waves = jax_wave_flat_index(src[valid], dst[valid],
                                          negs[valid].T, N_NODES, cap)
    flat = np.full(len(src), n_waves * cap, np.int32)
    flat[valid] = flat_v
    jstate = JaxTpprState(jnp.zeros((N_NODES, m * (4 * k + 1)), jnp.float32))
    jstate, jrows = jax_wave_scan_chunk(
        jstate, JaxTpprParams.create((0.1, 0.1), (0.05, 0.95), k),
        *(jnp.asarray(a) for a in (src, dst, negs, t, eidx, valid, flat)),
        n_waves, cap)
    assert np.asarray(jrows).shape == tuple(rows.shape)
    for got, want in ((state.data, np.asarray(jstate.data)),
                      (rows, np.asarray(jrows))):
        gf, gn = split_rows(got, m, k)
        wf, wn = split_rows(torch.from_numpy(np.array(want)), m, k)
        assert_entries_close(gf.numpy(), gn.numpy(), wf.numpy(), wn.numpy())
