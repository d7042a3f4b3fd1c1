"""Serving's protocol graphs (``train/graphs.py:ProtocolGraphs``) against
the eager protocol, on the card: ``python3 -m pytest --noconftest -m card
tests/test_torch_serve_graphs_card.py`` (the package's conftest loads JAX,
which the card's machine does not hold). Each test skips without a CUDA
device.

Two predictors of one stream and weights observe and score the same
calls, one replaying the protocol and one running it eagerly (its holder
capped at no length). They ingest a history of five 200-event calls and a
74-event tail, then run two rounds of three score-then-observe steps of
200 events, each round from the post-history tables put back in place, as
the benchmark's serving loops do. Bit-equal after every call: the five
memory tables and the scores; the counters read (captures, replays,
eager). Cases: the streaming index under ``last`` and ``mean``, the
pruning strategy (a fold before each protocol), a three-seed ensemble;
then the rule: a message-source flag runs eagerly, a fifth length past
the cap of four runs eagerly, and new tables capture anew. Also the
unmasked protocol against an all-ones mask, bit-equal on the card."""

import numpy as np
import pytest
import torch

from torch_serve_cases import check_unmasked_protocol, predictor
from zebra_tpu_torch.models.memory import MemoryState

pytestmark = pytest.mark.card

B, TAIL, STEPS, ROUNDS = 200, 74, 3, 2
HISTORY = 5 * B + TAIL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(kind, card, n_events, **options):
    """(graph predictor, eager predictor, columns) of one case."""
    g, cols = predictor(kind, card, n_events, **options)
    e, _ = predictor(kind, card, n_events, **options)
    e._protocol.lengths = 0
    return g, e, cols


def _counts(pred):
    return (pred.protocol_captures, pred.protocol_replays,
            pred.protocol_eager)


def _same(g, e, where):
    for name, x, y in zip(MemoryState._fields, g.mem, e.mem):
        assert torch.equal(x, y), (where, name)


def _observe(g, e, cols, lo, hi):
    for pred in (g, e):
        pred.observe(*(c[lo: hi] for c in cols))
    _same(g, e, (lo, hi))


def _saved(pred):
    index = (pred.index_state.data.clone() if pred.index_state is not None
             else (pred.nbr_index, pred._events))
    return index, [x.clone() for x in pred.mem]


def _restore(pred, saved):
    index, tables = saved
    if pred.index_state is not None:
        pred.index_state.data.copy_(index)
    else:
        pred.nbr_index, pred._events = index
        pred._pending, pred._pending_n = [], 0
    for x, s in zip(pred.mem, tables):
        x.copy_(s)


@pytest.mark.parametrize("kind,options", [
    ("streaming", {}),
    ("streaming", dict(aggregator="mean")),
    ("pruning", {}),
    ("ensemble", {}),
])
def test_replayed_protocol_equals_eager(card, kind, options):
    n_events = HISTORY + STEPS * B
    g, e, cols = _pair(kind, card, n_events, **options)
    for lo in range(0, HISTORY, B):
        _observe(g, e, cols, lo, min(lo + B, HISTORY))
    assert _counts(g) == (2, 4, 0) and _counts(e) == (0, 0, 6)
    base = _saved(g), _saved(e)
    rng = np.random.RandomState(0)
    for r in range(ROUNDS):
        _restore(g, base[0])
        _restore(e, base[1])
        _same(g, e, ("round", r))
        for j in range(STEPS):
            lo, hi = HISTORY + j * B, HISTORY + (j + 1) * B
            src, dst, t = (c[lo: hi] for c in cols[:3])
            neg = rng.randint(301, 601, B)
            cand = (np.concatenate([src, src]), np.concatenate([dst, neg]),
                    np.concatenate([t, t]))
            np.testing.assert_array_equal(g.score(*cand), e.score(*cand))
            _observe(g, e, cols, lo, hi)
    calls = 6 + ROUNDS * STEPS
    assert _counts(g) == (2, calls - 2, 0)
    assert _counts(e) == (0, 0, calls)
    assert g.mem.memory.float().abs().max() > 0


def test_replay_rule(card):
    g, cols = predictor("streaming", card, 1_000,
                        use_source_embedding_in_message=True)
    g.observe(*(c[:B] for c in cols))
    g.observe(*(c[B: 2 * B] for c in cols))
    assert _counts(g) == (0, 0, 2)

    g, e, cols = _pair("streaming", card, 1_000)
    lo = 0
    for n in (10, 20, 30, 40, 50, 50, 10):
        _observe(g, e, cols, lo, lo + n)
        lo += n
    assert _counts(g) == (4, 1, 2)
    # new tables (the same values): every graph is dropped, then captured
    g.mem = MemoryState(*(x.clone() for x in g.mem))
    for n in (10, 20, 10):
        _observe(g, e, cols, lo, lo + n)
        lo += n
    assert _counts(g) == (6, 2, 2)
    assert _counts(e) == (0, 0, 10)


@pytest.mark.parametrize("aggregator,seeds", [
    ("last", 1), ("mean", 1), ("last", 3), ("mean", 3)])
def test_unmasked_protocol_equals_all_ones_mask_on_card(card, aggregator,
                                                        seeds):
    check_unmasked_protocol(card, aggregator, seeds, b=B)
