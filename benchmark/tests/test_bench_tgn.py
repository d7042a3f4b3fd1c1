"""The TGN cell's harness: the FLOP count against a hand count, its
neighbour search against the reference's, and the check, which passes the
program and fails the control (the reference in bfloat16), ``half_batch``
and the ``hop`` fault (each root's newest neighbour dropped). Tiny sizes
on the CPU, the cell's own limits."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import harness

from benchmark import calibrate_cells, run, streams, work, work_tgn
from benchmark.checks import verdict
from benchmark.reference import tgn

CELL = "wikipedia-tgn2l.train"


def test_flops_by_hand():
    # 2 roots, 2 neighbours, 2 hops, d = 2, t = 3, e = 4: query 5, keys 9.
    # A node: query and output projections 2·25 each, merge 2·(7·2 + 2·2);
    # a child: keys and values 2·2·9·5, scores and weighted sum 2·2·5
    node, child = 50 + 50 + 36, 180 + 20
    # level 1 (4 nodes, 8 children), then the roots (2 nodes, 4 children)
    assert work_tgn.tower_flops(2, 2, 2, 2, 3, 4) == (
        4 * node + 8 * child) + (2 * node + 4 * child)
    # a batch of b = 1 event: 3 roots, the head on 2 pairs, the GRU (message
    # 2·2 + 4 + 3 = 11) on 5 distinct pending nodes, twice 2 commits
    gru = lambda rows: 2 * rows * (11 * 6 + 2 * 6)
    assert work_tgn.train_batch_flops(1, 2, 2, 2, 3, 4, 5, 2) == (
        3 * (work_tgn.tower_flops(3, 2, 2, 2, 3, 4) + 2 * 2 * (2 * 4 + 2)
             + gru(5)) + gru(2))
    assert work.gru_flops(5, 11, 2) == gru(5)


def test_search_equals_the_reference():
    ev = streams.synthetic_events(800, 30, 12, 5)
    n_nodes = int(max(ev.src.max(), ev.dst.max())) + 1
    mine = work_tgn.Events(ev.src, ev.dst, ev.t, n_nodes)
    adj = tgn.Adjacency(ev.src, ev.dst, ev.t, ev.eidx, n_nodes)
    roots = np.concatenate([ev.src[400:450], ev.dst[400:450]])
    times = np.tile(ev.t[400:450], 2)
    got = work_tgn.tree_nodes(mine, roots, times, 4, 2)
    ref = tgn.hop_tree(adj, roots, times, 4, 2)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.nodes)


def test_gru_rows_by_hand():
    # nodes 1-4; batches of 1 event: (1, 3), (2, 3), (1, 4)
    src, dst = np.array([1, 2, 1]), np.array([3, 3, 4])
    t = np.array([1.0, 2.0, 3.0])
    neg = np.array([4, 4, 3])
    ev = work_tgn.Events(src, dst, t, 5)
    first = work.first_batches(src, dst, 1, 5)
    rows = work_tgn.gru_rows_per_batch(ev, src, dst, neg, t, 1, 2, 1, first,
                                       range(3))
    # batch 0: nothing pending; batch 1: {2, 3, 4} and neighbours {1}
    # (3's before t = 2), of which 1 and 3 sent in batch 0; batch 2: {1, 4,
    # 3} and neighbours {3, 2} (1's and 3's), all pending but 4
    assert rows == [0, 2, 3]


def test_program_is_correct(tiny):
    res = run.run_cell(harness(tiny, CELL, trace=True))
    assert res["correct"], res["checks"]
    assert res["checks"]["hops_gap"]["value"] == 0.0
    assert {"mfu_pct.tgn", "hops_ms_per_batch.tgn", "rows_ms_per_batch.tgn",
            "attention_ms_per_batch.tgn", "protocol_ms_per_batch.tgn",
            "backward_ms_per_batch.tgn"} <= set(res["metrics"])


@pytest.mark.parametrize("kind", ["control", "half_batch", "hop"])
def test_faults_are_not_correct(tiny, kind):
    h = harness(tiny, CELL)
    nums = calibrate_cells.readings(h, kind)
    assert not verdict(nums, h.limits)["correct"], nums
