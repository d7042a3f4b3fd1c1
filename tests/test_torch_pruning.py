"""The port's pruning T-PPR query (zebra_tpu_torch/index/pruning.py) against
the JAX package's ``pruned_topk`` (``pruned_topk_impl`` under jit), at the
four cases of tests/test_pruning_index.py:61-70 (C = 399 candidates in
the last, so the sorted dedup runs) and at the width, depth and top-k of
the MOOC pruning run (10, 2, 20) on a dense stream.

Bars: the same live entries, except entries within noise of the k-th
weight (the rule of test_pruning_index.py:108-116); weights within 1e-5
relative; dt equal where the entry is the same. (Measured on the CPU: both
packages give the same arrays bit for bit at these cases.) The port's two
dedup forms agree within 1e-6 relative, as at test_pruning_index.py:119-138,
and a batch of roots answers each root as a call of its own does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_neighbor_finder import random_stream
from zebra_tpu.index.neighbor_finder import build_neighbor_index as jax_build
from zebra_tpu.index.pruning import pruned_topk as jax_pruned_topk
from zebra_tpu_torch.index import pruning
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index

CASES = [
    ((0.1,), (0.9,), 4, 2, 6),
    ((0.1, 0.3), (0.9, 0.5), 3, 3, 5),
    ((0.0,), (0.6,), 5, 1, 8),
    ((0.1,), (0.9,), 7, 3, 6),          # C = 7 + 49 + 343 = 399 > 256
]
MOOC = ((0.1, 0.1), (0.5, 0.95), 10, 2, 20)


def _setup(n_events=200, n_nodes=25, seed=7, n_q=40, q_seed=3):
    cols = random_stream(n_events, n_nodes, seed)
    rng = np.random.RandomState(q_seed)
    nodes = rng.randint(1, n_nodes, n_q).astype(np.int32)
    t_q = rng.uniform(cols[2].min(), cols[2].max(), n_q).astype(np.float32)
    return cols, n_nodes, nodes, t_q


def _port(index, alpha, beta, nodes, t_q, width, depth, k):
    out = pruning.pruned_topk(index, torch.tensor(alpha), torch.tensor(beta),
                              torch.from_numpy(nodes), torch.from_numpy(t_q),
                              width, depth, k)
    return [x.numpy() for x in out]


def _jax(cols, n_nodes, alpha, beta, nodes, t_q, width, depth, k):
    out = jax_pruned_topk(jax_build(*cols, n_nodes),
                          jnp.asarray(alpha, jnp.float32),
                          jnp.asarray(beta, jnp.float32), jnp.asarray(nodes),
                          jnp.asarray(t_q), width, depth, k)
    return [np.asarray(x) for x in out]


def assert_same_entries(got, want):
    """TpprQueries fields as numpy [M, Q, k], port and JAX."""
    for m in range(want[3].shape[0]):
        for i in range(want[3].shape[1]):
            entries = []
            for nbr, eidx, dt, w in (got, want):
                live = w[m, i] > 0
                entries.append({(int(e), int(n)): (float(x), float(d))
                                for e, n, d, x in zip(eidx[m, i][live],
                                                      nbr[m, i][live],
                                                      dt[m, i][live],
                                                      w[m, i][live])})
            g, wt = entries
            cut = min(x for x, _ in wt.values()) if wt else 0.0
            for key in set(g) ^ set(wt):
                x = (wt.get(key) or g.get(key))[0]
                assert x == pytest.approx(cut, rel=1e-4), (m, i, key)
            for key in set(g) & set(wt):
                assert g[key][0] == pytest.approx(wt[key][0], rel=1e-5), (
                    m, i, key)
                assert g[key][1] == wt[key][1], (m, i, key)
    for f in (0, 1, 3):
        assert got[f].shape == want[f].shape


@pytest.mark.parametrize("alpha,beta,width,depth,k", CASES + [MOOC])
def test_pruned_topk_matches_jax(alpha, beta, width, depth, k):
    if width == 10:
        cols, n_nodes, nodes, t_q = _setup(3000, 60, 4, 120, 5)
    else:
        cols, n_nodes, nodes, t_q = _setup()
    index = build_neighbor_index(*cols, n_nodes, device="cpu")
    got = _port(index, alpha, beta, nodes, t_q, width, depth, k)
    want = _jax(cols, n_nodes, alpha, beta, nodes, t_q, width, depth, k)
    assert (got[3] > 0).sum() > 0.5 * got[3].size
    assert_same_entries(got, want)
    assert got[0].dtype == got[1].dtype == np.int32
    # dead slots: zeros, and dt equal to the query time
    dead = got[3] == 0
    assert not got[0][dead].any() and not got[1][dead].any()
    np.testing.assert_array_equal(got[2][dead],
                                  np.broadcast_to(t_q[None, :, None],
                                                  dead.shape)[dead])


@pytest.mark.parametrize("width,depth", [(4, 2), (7, 3)])
def test_dedup_forms_agree(monkeypatch, width, depth):
    cols, n_nodes, nodes, t_q = _setup(seed=11, n_q=32, q_seed=5)
    index = build_neighbor_index(*cols, n_nodes, device="cpu")
    args = (index, (0.1, 0.0), (0.9, 0.5), nodes, t_q, width, depth, 6)
    monkeypatch.setattr(pruning, "_MATCH_MATRIX_MAX_C", 10 ** 6)
    matrix = _port(*args)
    monkeypatch.setattr(pruning, "_MATCH_MATRIX_MAX_C", 0)
    by_sort = _port(*args)
    for a, b in zip(matrix, by_sort):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_a_batch_answers_each_root_as_alone():
    """The seed axis queries src, dst and every lane's negatives in one
    call: each slice of the batch equals a call on that slice alone."""
    cols, n_nodes, nodes, t_q = _setup(3000, 60, 4, 90, 6)
    index = build_neighbor_index(*cols, n_nodes, device="cpu")
    alpha, beta, width, depth, k = MOOC
    whole = _port(index, alpha, beta, nodes, t_q, width, depth, k)
    for lo in (0, 30, 60):
        sl = slice(lo, lo + 30)
        part = _port(index, alpha, beta, nodes[sl], t_q[sl], width, depth, k)
        for a, b in zip(whole, part):
            np.testing.assert_array_equal(a[:, sl], b)
