"""The port's streaming T-PPR index (zebra_tpu_torch/index/streaming.py)
against JAX ``streaming_scan`` / ``read_topk`` on the same stream.

States and scan queries are held to the merge bar of test_torch_merge.py
(an FMA contraction inside XLA's fused scan may move a weight by an ulp);
``read_topk`` is a pure gather and must be exact."""

import numpy as np
import torch

import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_merge import assert_entries_close
from zebra_tpu.index import streaming as jst
from zebra_tpu_torch.bridge import tppr_from_numpy
from zebra_tpu_torch.index import streaming as pst

N_NODES, M, K = 40, 2, 10
ALPHA, BETA = (0.1, 0.0), (0.9, 0.5)


def _stream(n_edges=300, seed=0):
    """src/dst/neg/ts/eidx/valid with self-loops and invalid padding."""
    rng = np.random.RandomState(seed)
    src, dst, neg = (rng.randint(1, N_NODES, n_edges).astype(np.int32)
                     for _ in range(3))
    dst[::11] = src[::11]
    ts = np.cumsum(rng.exponential(1.0, n_edges)).astype(np.float32)
    eidx = np.arange(1, n_edges + 1, dtype=np.int32)
    valid = np.ones(n_edges, bool)
    valid[3::7] = False
    return src, dst, neg, ts, eidx, valid


def _scan_both(cols):
    j_state, j_q = jst.streaming_scan(
        jst.init_tppr_state(M, N_NODES, K), jst.TpprParams.create(ALPHA, BETA, K),
        *(jnp.asarray(c) for c in cols))
    p_state, p_q = pst.streaming_scan(
        pst.init_tppr_state(M, N_NODES, K, device="cpu"),
        pst.TpprParams.create(ALPHA, BETA, K), *cols)
    return j_state, j_q, p_state, p_q


def _fields(data):
    rows = np.asarray(data)
    fields = rows[:, : 4 * M * K].reshape(-1, M, 4, K)
    return fields, rows[:, 4 * M * K:]


def test_scan_state_matches_jax():
    j_state, _, p_state, _ = _scan_both(_stream())
    assert_entries_close(*_fields(p_state.data.numpy()),
                         *_fields(j_state.data))


def test_scan_queries_match_jax():
    """Per (edge, member, query row) the same entries: two weights one ulp
    apart in one scan can be equal in the other and swap slots, so the
    rows are compared as entry sets (dt in place of ts)."""
    cols = _stream()
    _, j_q, _, p_q = _scan_both(cols)
    assert p_q.nbr.shape == (len(cols[0]), M, 3, K)
    as_fields = lambda q: np.stack(
        [np.asarray(q.w), np.asarray(q.nbr, np.float32),
         np.asarray(q.eidx, np.float32), np.asarray(q.dt)], axis=-2)
    zeros = np.zeros(p_q.w.shape[:-1], np.float32)
    assert_entries_close(as_fields(p_q), zeros, as_fields(j_q), zeros)


def test_invalid_edges_leave_rows_untouched():
    src, dst, neg, ts, eidx, _ = _stream(40, seed=1)
    params = pst.TpprParams.create(ALPHA, BETA, K)
    state = pst.init_tppr_state(M, N_NODES, K, device="cpu")
    state, _ = pst.streaming_scan(state, params, src, dst, neg, ts, eidx,
                                  np.ones(40, bool))
    before = state.data.clone()
    state, q = pst.streaming_scan(state, params, src, dst, neg, ts + 100,
                                  eidx + 40, np.zeros(40, bool))
    torch.testing.assert_close(state.data, before, rtol=0, atol=0)
    # the extraction still reads the (unchanged) rows
    np.testing.assert_array_equal(
        q.nbr[:, :, 0].numpy(), pst.read_topk(
            state, torch.from_numpy(src)[:, None], torch.from_numpy(ts),
            M, K).nbr[:, :, 0].numpy())


def test_read_topk_exact():
    """Same state on both sides (copied across with the bridge): the
    read-only extraction is a gather and must agree bit for bit."""
    j_state, _, _, _ = _scan_both(_stream())
    rng = np.random.RandomState(2)
    nodes3 = rng.randint(0, N_NODES, (24, 3)).astype(np.int32)
    t_q = (400.0 + rng.rand(24)).astype(np.float32)
    j_q = jst.read_topk(j_state, jnp.asarray(nodes3), jnp.asarray(t_q), M, K)
    p_q = pst.read_topk(tppr_from_numpy(j_state, device="cpu"),
                        torch.from_numpy(nodes3), torch.from_numpy(t_q), M, K)
    for a, b in zip(p_q, j_q):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_edge_step_wave_matches_sequential():
    """edge_step on W node-disjoint edges at once (one wave) equals
    scanning them one by one."""
    src, dst, neg, ts, eidx, _ = _stream(200, seed=3)
    params = pst.TpprParams.create(ALPHA, BETA, K)
    warm = pst.init_tppr_state(M, N_NODES, K, device="cpu")
    warm, _ = pst.streaming_scan(warm, params, src, dst, neg, ts, eidx,
                                 np.ones(200, bool))
    w_src = np.arange(1, 17, 2, dtype=np.int32)       # 8 disjoint pairs
    w_dst = w_src + 1
    w_neg = np.full(8, 30, np.int32)                  # read, never written
    w_ts = np.full(8, ts[-1] + 1, np.float32)
    w_eidx = np.arange(201, 209, dtype=np.int32)
    valid = np.ones(8, bool)
    seq = pst.TpprState(warm.data.clone())
    seq, q_seq = pst.streaming_scan(seq, params, w_src, w_dst, w_neg, w_ts,
                                    w_eidx, valid)
    wave = pst.TpprState(warm.data.clone())
    wave, rows3 = pst.edge_step(wave, torch.from_numpy(w_src),
                                torch.from_numpy(w_dst), torch.from_numpy(w_neg),
                                torch.from_numpy(w_ts), torch.from_numpy(w_eidx),
                                torch.from_numpy(valid), params)
    torch.testing.assert_close(wave.data, seq.data, rtol=0, atol=0)
    q_wave = pst.unpack_queries(rows3, torch.from_numpy(w_ts), M, K)
    for a, b in zip(q_wave, q_seq):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
