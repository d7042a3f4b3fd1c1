"""The port's padded-CSR adjacency index (zebra_tpu_torch/index/
neighbor_finder.py) against the JAX package's, after
tests/test_pruning_index.py: the arena arrays equal exactly, and
``count_before`` and ``most_recent_neighbors`` return the same values on
random streams (repeated timestamps and cuts on an arena time included)
and on the all-self-loop stream whose arena length is a power of two. Port
only: an empty stream answers no neighbours, and node ids outside the
table are refused."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu.index import neighbor_finder as jnf
from zebra_tpu_torch.index import neighbor_finder as nf


def random_stream(n_events, n_nodes, seed, repeat_ts=False):
    """test_pruning_index.py's stream; ``repeat_ts`` rounds the times so
    that many events share one."""
    rng = np.random.RandomState(seed)
    src = rng.randint(1, n_nodes, n_events).astype(np.int32)
    dst = rng.randint(1, n_nodes, n_events).astype(np.int32)
    dst = np.where(dst == src, (dst % (n_nodes - 1)) + 1, dst)
    ts = np.cumsum(rng.exponential(1.0, n_events))
    if repeat_ts:
        ts = np.floor(ts / 4.0)
    eidx = np.arange(1, n_events + 1, dtype=np.int32)
    return src, dst, ts, eidx


def _both(cols, n_nodes):
    return (jnf.build_neighbor_index(*cols, n_nodes),
            nf.build_neighbor_index(*cols, n_nodes, device="cpu"))


def _queries(ts, n_nodes, n, seed):
    """Query nodes (node 0 and an unused id included) and f32 cuts: random,
    exactly on arena times, and below and above every time."""
    rng = np.random.RandomState(seed)
    nodes = rng.randint(0, n_nodes, n).astype(np.int32)
    cuts = rng.uniform(ts.min() - 1, ts.max() * 1.1, n).astype(np.float32)
    cuts[: n // 4] = ts[rng.randint(0, len(ts), n // 4)].astype(np.float32)
    cuts[-2:] = (ts.min() - 5.0, ts.max() + 5.0)
    return nodes, cuts


CASES = {"distinct": (150, 20, 0, False), "repeated_ts": (300, 12, 1, True),
         "dense": (2000, 40, 2, False)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_arena_matches_jax(case):
    n_events, n_nodes, seed, rep = CASES[case]
    j, p = _both(random_stream(n_events, n_nodes, seed, rep), n_nodes)
    assert p.n_nodes == j.n_nodes == n_nodes
    for f in ("nbr", "eidx", "ts", "offsets"):
        got, want = getattr(p, f).numpy(), np.asarray(getattr(j, f))
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert p.ts.dtype == torch.float32 and p.nbr.dtype == torch.int32


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("n", [1, 5])
def test_lookups_match_jax(case, n):
    n_events, n_nodes, seed, rep = CASES[case]
    cols = random_stream(n_events, n_nodes, seed, rep)
    j, p = _both(cols, n_nodes)
    nodes, cuts = _queries(cols[2], n_nodes, 96, seed + 10)
    got = nf.count_before(p, torch.from_numpy(nodes), torch.from_numpy(cuts))
    want = jnf.count_before(j, jnp.asarray(nodes), jnp.asarray(cuts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = nf.most_recent_neighbors(p, torch.from_numpy(nodes),
                                   torch.from_numpy(cuts), n)
    want = jnf.most_recent_neighbors(j, jnp.asarray(nodes), jnp.asarray(cuts),
                                     n)
    for name, g, w in zip(("nbr", "eidx", "ts", "valid", "n_before"), got,
                          want):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[3].any() and not got[3].all()


def test_power_of_two_all_self_loop_arena():
    """Four self-loops on node 1: an arena of 8 slots, all node 1's
    (tests/test_pruning_index.py:141-166), every cut from 0.5 to 4.5."""
    e = 4
    cols = (np.ones(e, np.int64), np.ones(e, np.int64),
            np.arange(1, e + 1, dtype=np.float64),
            np.arange(1, e + 1, dtype=np.int64))
    j, p = _both(cols, 2)
    assert p.ts.shape[0] == 8
    cuts = np.arange(0.5, 5.0, 0.5, dtype=np.float32)
    nodes = np.ones(len(cuts), np.int32)
    got = nf.count_before(p, torch.from_numpy(nodes), torch.from_numpy(cuts))
    want = np.searchsorted(np.sort(np.concatenate([cols[2], cols[2]])), cuts)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnf.count_before(j, jnp.asarray(nodes),
                                                 jnp.asarray(cuts))))
    nbr, _, nts, valid, n_before = nf.most_recent_neighbors(
        p, torch.tensor([1]), torch.tensor([1.5]), 3)
    assert bool(valid[0, 0]) and float(nts[0, 0]) == 1.0
    assert valid[0].tolist() == [True, True, False] and int(n_before[0]) == 2


def test_empty_stream_answers_no_neighbors():
    p = nf.build_neighbor_index([], [], [], [], 5, device="cpu")
    nbr, eidx, ts, valid, n_before = nf.most_recent_neighbors(
        p, torch.tensor([0, 4]), torch.tensor([1.0, 1e9]), 3)
    assert not valid.any() and n_before.tolist() == [0, 0]
    assert not nbr.any() and not eidx.any() and not ts.any()


@pytest.mark.parametrize("bad", [5, -1])
def test_node_ids_outside_the_table_raise(bad):
    with pytest.raises(ValueError, match=r"node ids must lie in \[0, 5\)"):
        nf.build_neighbor_index([1, bad], [2, 3], [1.0, 2.0], [1, 2], 5,
                                device="cpu")
