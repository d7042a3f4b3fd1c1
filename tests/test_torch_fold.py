"""The adjacency fold of ``LinkPredictor.observe`` (``serve.py:
flush_index``, ``index/neighbor_finder.py:append_events``): whether the
new slots are appended on the index's device or the index is rebuilt on
the host, the folded index is ``torch.equal`` to ``build_neighbor_index``
over every event so far (arena, offsets, keys, times), with the same
``max_degree`` and host bookkeeping. Each case also holds the counts of
appends (``fold_appends``) and rebuilds (``fold_rebuilds``) it expects:

- a bipartite stream in time order, b = 200, with f32 ties inside and
  across batches (f64-equal times and f64-distinct ones that round to one
  f32): every fold appends;
- a non-bipartite stream with self-loops: a batch whose new source slot
  ties, at the newest time, with a node's destination-direction slot
  rebuilds; ties at the newest time that keep the build's order append;
- a batch holding a time below the newest rebuilds, and the next appends;
- folding from the empty placeholder rebuilds first, then appends;
- ``rebuild_every`` > 1, then ``flush_index``.

And the restore the serving benchmark makes: a saved ``(nbr_index,
_events)`` stays as it was through later folds, and folding other events
after putting it back equals a fresh rebuild. The same equality at MOOC's
size on CUDA is ``tests/test_torch_fold_card.py``."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.index.neighbor_finder import build_neighbor_index
from zebra_tpu_torch.models.memory import init_memory
from zebra_tpu_torch.models.tgn import init_tgn_params
from zebra_tpu_torch.serve import LinkPredictor

B = 200
N_NODES = 61   # ids 0..60


def _predictor(base, rebuild_every=1):
    """A small pruning predictor whose index holds the ``base`` stream."""
    cfg = Config(node_dim=8, time_dim=8, memory_dim=8, topk=3,
                 tppr_strategy="pruning", n_degree=3, n_layer=2,
                 alpha_list=(0.1,), beta_list=(0.9,), n_nodes=N_NODES,
                 n_edges=4_000, edge_dim=4, memory_dtype="float32",
                 message_dtype="float32")
    params = init_tgn_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mem = init_memory(N_NODES, cfg.memory_dim, cfg.msg_table_dim,
                      torch.float32, torch.float32, device="cpu")
    ef = np.random.RandomState(0).randn(cfg.n_edges, 4).astype(np.float32)
    return LinkPredictor(cfg, params, mem, None, ef,
                         build_neighbor_index(*base, N_NODES, "cpu"), base,
                         rebuild_every=rebuild_every, device="cpu")


def _stream(rng, n, t0, bipartite=True, ties=True):
    """``n`` events from time ``t0`` on, in time order: users 1..30 to
    items 31..60, or any two of 0..60 (self-loops among them). With
    ``ties``, times repeat and many f64 times round to one f32."""
    if bipartite:
        src, dst = rng.randint(1, 31, n), rng.randint(31, 61, n)
    else:
        src, dst = rng.randint(0, 61, n), rng.randint(0, 61, n)
        dst[::7] = src[::7]
    step = rng.choice([0.0, 0.01, 0.5], n) if ties else rng.rand(n) + 0.1
    t = t0 + np.cumsum(step)
    return [src, dst, t, rng.randint(1, 4_000, n)]


def _cat(*streams):
    return [np.concatenate(c) for c in zip(*streams)]


def _batches(cols, b=B):
    return [[c[i: i + b] for c in cols] for i in range(0, len(cols[0]), b)]


def assert_same_index(got, want):
    for f in ("arena", "offsets", "keys", "times"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.max_degree == want.max_degree
    np.testing.assert_array_equal(got.degree, want.degree)
    assert got.newest == want.newest
    np.testing.assert_array_equal(got.newest_dst, want.newest_dst)


def _in_order(rng):
    """Bipartite, in time order from 1e6 (f32 spacing 0.0625 there), the
    first event of each batch at its predecessor's time."""
    base = _stream(rng, 400, 1e6)
    new = _stream(rng, 5 * B, base[2][-1])
    new[2][B::B] = new[2][B - 1: -1: B]
    assert np.all(np.diff(new[2]) >= 0)
    return base, _batches(new), 1, (5, 0)


def _newest_tie(rng):
    """Non-bipartite with self-loops. Batch 2 opens at batch 1's newest
    time with a source that is batch 1's last destination (the build puts
    the new slot first: rebuild); batch 3 opens at the newest time with
    that time's destination again as a destination and a source that was
    a source there (the build's order: append)."""
    base = _stream(rng, 400, 10.0, bipartite=False)
    batches = []
    t0 = base[2][-1] + 1.0
    for _ in range(4):
        batches.append(_stream(rng, B, t0, bipartite=False, ties=False))
        t0 = batches[-1][2][-1] + 1.0
    last = batches[0]
    batches[1][2] += last[2][-1] - batches[1][2][0]
    batches[1][0][0], batches[1][1][0] = last[1][-1], 0
    batches[1][0][1] = batches[1][1][1] = 5    # a self-loop at the tie
    batches[1][2][1] = batches[1][2][0]
    prev = batches[1]
    batches[2][2] += prev[2][-1] - batches[2][2][0]
    batches[2][0][0], batches[2][1][0] = prev[0][-1], prev[1][-1]
    if prev[1][-1] == prev[0][-1]:
        batches[2][0][0] = 60 if prev[1][-1] != 60 else 59
        batches[2][1][0] = prev[1][-1]
    return base, batches, 1, (3, 1)


def _earlier(rng):
    """In order, but batch 2 holds a time below the newest held."""
    base = _stream(rng, 400, 0.0, ties=False)
    new = _batches(_stream(rng, 4 * B, base[2][-1] + 1, ties=False))
    new[1][2][50] = new[0][2][-1] - 3.0
    return base, new, 1, (3, 1)


def _from_empty(rng):
    """The empty placeholder's index: the first fold rebuilds."""
    none = np.zeros(0, np.int64)
    base = [none, none, np.zeros(0, np.float64), none]
    return base, _batches(_stream(rng, 4 * B, 3.0)), 1, (3, 1)


def _deferred(rng):
    """``rebuild_every`` 450: one fold at the third batch, then
    ``flush_index`` folds the last two."""
    base = _stream(rng, 400, 0.0)
    return base, _batches(_stream(rng, 5 * B, base[2][-1])), 450, (2, 0)


@pytest.mark.parametrize("case", [_in_order, _newest_tie, _earlier,
                                  _from_empty, _deferred])
def test_fold_equals_the_rebuild(case):
    base, batches, every, (appends, rebuilds) = case(
        np.random.RandomState(7))
    pred = _predictor(base, rebuild_every=every)
    seen = list(base)
    for batch in batches:
        pred.observe(*batch)
        seen = _cat(seen, batch)
        if pred._pending_n == 0:
            assert_same_index(pred.nbr_index,
                              build_neighbor_index(*seen, N_NODES, "cpu"))
    pred.flush_index()
    assert_same_index(pred.nbr_index,
                      build_neighbor_index(*seen, N_NODES, "cpu"))
    for got, want in zip(pred._events, seen):
        np.testing.assert_array_equal(got, want)
    assert (pred.fold_appends, pred.fold_rebuilds) == (appends, rebuilds)


def _snapshot(pred):
    """Copies of every tensor and array of the index and the events."""
    ix = pred.nbr_index
    return ([getattr(ix, f).clone() for f in ("arena", "offsets", "keys",
                                              "times")]
            + [ix.degree.copy(), ix.newest_dst.copy()]
            + [c.copy() for c in pred._events])


def test_restored_state_is_untouched_and_folds_again():
    """``benchmark/loops/serve_pruning.py``'s ``_state``/``_restore``: a
    saved (index, events) pair survives later folds as it was, and after
    putting it back, folding other events equals a fresh rebuild."""
    rng = np.random.RandomState(3)
    base = _stream(rng, 400, 0.0)
    pred = _predictor(base)
    first = _batches(_stream(rng, 2 * B, base[2][-1]))
    for batch in first:
        pred.observe(*batch)
    saved_at = _cat(base, *first)
    saved = (pred.nbr_index, pred._events)
    copies = _snapshot(pred)
    t0 = saved_at[2][-1]
    for batch in _batches(_stream(rng, 3 * B, t0)):
        pred.observe(*batch)
    ix = saved[0]
    now = ([getattr(ix, f) for f in ("arena", "offsets", "keys", "times")]
           + [ix.degree, ix.newest_dst] + list(saved[1]))
    for a, b in zip(now, copies):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(a, b))

    pred.nbr_index, pred._events = saved
    other = _stream(np.random.RandomState(11), 2 * B, t0)
    for batch in _batches(other):
        pred.observe(*batch)
    seen = _cat(saved_at, other)
    assert_same_index(pred.nbr_index,
                      build_neighbor_index(*seen, N_NODES, "cpu"))
    for got, want in zip(pred._events, seen):
        np.testing.assert_array_equal(got, want)
    assert (pred.fold_appends, pred.fold_rebuilds) == (7, 0)
