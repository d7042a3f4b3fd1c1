"""The ``mean`` aggregator on the row-sharded layout (one seed over D = 2
CPU ranks, tests/torch_rank_worker.py's ``sc_rows_mean``). One process
adds every valid message into its sender's row in batch order (the src
positions of the batch, then its dst positions); a block holds only its
own messages, so every rank's stored message rows are gathered and each
owner adds the ones of its senders in that same order
(``train/phase.py:_add_messages``), after the winning rows' memory and
update columns arrived. In eval the commit reads sums that several blocks
add to, so the owner commits its senders' rows after the addition. The
one-process order is kept, so the option bars of test_torch_row_sharded.py
hold unchanged (``option_tests``; its "options" section gives them)."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import option_runs, option_tests
from zebra_tpu_torch.models.memory import init_memory
from zebra_tpu_torch.train.step import accumulate_messages

NAMES = ["mean"]
globals().update(option_tests(NAMES))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_mean")


@pytest.fixture(scope="module")
def runs(tmp):
    return option_runs(tmp, NAMES)


def test_the_message_sums_cross_ranks(runs):
    """Every batch gathers the blocks' message rows once."""
    for r in runs["mean"]["ranks"]:
        n_batches = sum(len(p) for p in r["per_batch"].values())
        assert r["stats"]["msg_send"][0] >= n_batches


@pytest.mark.parametrize("order", [(0, 1, 2), (1, 2, 0)])
def test_accumulation_runs_in_the_given_order(order):
    """``accumulate_messages`` adds a row's messages in the order given:
    1, 2^-24, 2^-24 sum to 1 in f32, 2^-24, 2^-24, 1 to 1 + 2^-23."""
    parts = np.float32([1.0, 2.0 ** -24, 2.0 ** -24])[list(order)]
    mem = init_memory(4, 2, 1, torch.float32, torch.float32, device="cpu")
    msg = torch.stack([torch.from_numpy(parts), torch.ones(3)], dim=1)
    accumulate_messages(mem, torch.tensor([2, 2, 2]), msg,
                        torch.tensor([3.0, 1.0, 2.0]))
    want = np.float32(0.0)
    for x in parts:
        want = np.float32(want + x)
    assert float(mem.messages[2, 0]) == float(want)
    assert float(mem.msg_count[2]) == 3.0 and float(mem.msg_ts[2]) == 3.0
