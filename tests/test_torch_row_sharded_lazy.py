"""The lazy-update compaction (``--lazy_unique_cap``) on the row-sharded
layout (one seed over D = 2 CPU ranks, tests/torch_rank_worker.py's
``sc_rows_lazy`` and ``sc_rows_overflow``). A block's plan keeps the whole
batch's membership and overflow flag, compacts its own selected positions
at the whole batch's cap (``train/step.py:block_lazy_plan``), and the
ranks agree on the overflow, so every rank reruns the epoch per position
together. The cap -1 (auto) is held against the one-process port and
JAX's ``Trainer(n_devices=2)`` with test_torch_row_sharded.py's option
bars (``option_tests``); a cap the batches overflow reruns the epoch, bit
for bit as per-position training on the ranks."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import option_runs, option_tests
from tests.torch_rank_worker import OVERFLOW_CAP

NAMES = ["lazy"]
globals().update(option_tests(NAMES))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_lazy")


@pytest.fixture(scope="module")
def runs(tmp):
    return option_runs(tmp, NAMES, extra=["rows_overflow"])


def test_auto_cap_does_not_overflow(runs):
    r = runs["lazy"]["ranks"][0]
    assert r["cfg"].lazy_unique_cap == -1


def test_overflow_rerun_is_per_position_training(runs):
    """The overflowing epoch switched to the per-position path (the
    result is the rerun's), and the rerun equals per-position training
    from the start, bit for bit, on both ranks."""
    for r in runs["extra"]["rows_overflow"]:
        over, plain = r[OVERFLOW_CAP], r[0]
        assert over["fallback"] and not plain["fallback"]
        assert over["overflow"] == plain["overflow"] == 0
        np.testing.assert_array_equal(over["per_batch"], plain["per_batch"])
        for k, v in plain["params"].items():
            assert torch.equal(over["params"][k], v), k
        for k, v in plain["mem"].items():
            assert torch.equal(over["mem"][k], v), k
