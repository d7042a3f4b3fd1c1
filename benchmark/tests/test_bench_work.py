"""The arithmetic behind the rooflines and the MFU, against hand counts."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import work


def test_index_work_by_hand():
    # three events over nodes 1-4, one negative per event, M = 1, k = 2:
    # F = 9 floats, 36 bytes a row
    src, dst = np.array([1, 2, 1]), np.array([3, 4, 4])
    negs = np.array([[3, 2, 2]])
    valid = np.array([True, True, True])
    nbytes, ops = work.index_work(src, dst, negs, valid, 1, 2,
                                  live=np.zeros((3, 2, 1)))
    # reads {1,2,3,4}, writes {1,2,3,4}, extraction 3 events × 3 rows,
    # columns 3 × (17 + 4)
    assert nbytes == (4 + 4) * 36 + 3 * 3 * 36 + 3 * 21
    # empty rows: C = 1 candidate, 0·... + 0 + 8 per lane; 3 events × 2
    # directions
    assert ops == 6 * (1 * 1 + 0 + 8)
    # no extraction: src and dst rows read and written, 17 column bytes
    nbytes, _ = work.index_work(src, dst, None, valid, 1, 2)
    assert nbytes == (4 + 4) * 36 + 3 * 17


def test_merge_ops_by_hand():
    # L = 40 live entries: C = 41, ⌈log2 41⌉ = 6
    assert work.merge_ops([40]) == 41 * 6 + 80 + 8
    assert work.merge_ops([0, 3]) == (1 + 8) + (4 * 2 + 6 + 8)


def test_the_count_ignores_the_wave_plan():
    """Two wave plans of one chunk (caps 4 and 64) differ; the count, made
    from the columns alone, is the same for both."""
    from zebra_tpu_torch.index.waves import wave_schedule

    rng = np.random.RandomState(0)
    src = rng.randint(1, 30, 500)
    dst = rng.randint(31, 60, 500)
    neg = rng.randint(31, 60, 500)
    plans = [wave_schedule(src, dst, neg, 61, cap)[2] for cap in (4, 64)]
    assert plans[0] != plans[1]
    valid = np.ones(500, bool)
    counts = {work.index_work(src, dst, neg[None], valid, 2, 20)
              for _ in plans}
    assert len(counts) == 1


@pytest.mark.parametrize("lazy,commit", [(0, 0), (100, 30)])
def test_train_flops_by_hand(lazy, commit):
    b, d, t, e, m, k = 10, 4, 3, 2, 2, 5
    h, msg = d * (m + 1), 2 * d + e + t
    tower = 2 * 3 * b * 2 * d * d + 2 * m * 3 * b * k * ((d + t + e) * d
                                                         + d * d)
    head = 2 * 2 * b * (2 * h * h + h)
    gru = lambda r: 2 * r * (msg * 3 * d + d * 3 * d)
    want = 3 * (tower + head + gru(lazy)) + gru(commit)
    assert work.train_batch_flops(b, d, t, e, m, k, lazy, commit) == want


def test_serve_flops_by_hand():
    c, d, t, e, m, k = 8, 4, 3, 2, 2, 5
    h, msg = d * (m + 1), 2 * d + e + t
    want = (2 * 2 * c * 2 * d * d + 2 * m * 2 * c * k * ((d + t + e) * d
                                                         + d * d)
            + 2 * c * (2 * h * h + h) + 2 * 6 * (msg * 3 * d + d * 3 * d))
    assert work.serve_step_flops(c, d, t, e, m, k, 6) == want


def test_lazy_rows_count_distinct_pending_neighbours():
    # batch 0 sends from nodes 1, 2; batch 1 from 3, 4
    first = work.first_batches(np.array([1, 3]), np.array([2, 4]), 1, 6)
    assert list(first[1:5]) == [0, 0, 1, 1]
    nbr = [np.array([[1, 1, 5]]), np.array([[1, 2, 3, 3, 5, 0]])]
    w = [np.array([[1.0, 1.0, 1.0]]), np.array([[1, 1, 1, 1, 1, 0.0]])]
    # batch 0: nothing sent before; batch 1: 1 and 2 pending, 3 only in
    # this batch, 5 never sent, the empty slot not selected
    assert work.lazy_rows_per_batch(nbr, w, first, [0, 1]) == [0, 2]
    assert work.commit_rows(np.array([3]), np.array([1]), first, 1) == 1
    assert work.commit_rows(np.array([3]), np.array([1]), None, 1) == 2


def test_bound_names_what_bounds_it():
    s, by = work.bound_s(3.35e12, 1.0)
    assert by == "bytes" and s == pytest.approx(1.0)
    s, by = work.bound_s(1.0, 67e12)
    assert by == "operations" and s == pytest.approx(1.0)
