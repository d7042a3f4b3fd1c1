"""The ``mlp`` message function with both message-source flags on the
row-sharded layout (one seed over D = 2 CPU ranks, tests/
torch_rank_worker.py's ``sc_rows_messages``): the params, ``msg_fc1`` and
``msg_fc2`` included, are replicated and their gradients ride the one
flat all-reduce; a block's messages take its own src and dst embeddings
(detached from the train forward, or the eval forward's), so the stored
and sent message row widens to message_dim + 1. Held against the
one-process port and JAX's ``Trainer(n_devices=2)`` from JAX's params at
test_torch_row_sharded.py's sizes with its option bars (``option_tests``;
its "options" section gives them and their reasons)."""

import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import option_runs, option_tests

NAMES = ["messages"]
globals().update(option_tests(NAMES))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_messages")


@pytest.fixture(scope="module")
def runs(tmp):
    return option_runs(tmp, NAMES)


def test_message_rows_carry_the_sender_part(runs):
    """Under use_source_embedding_in_message the stored row holds the
    whole message (no compact layout) plus the flag column."""
    r = runs["messages"]["ranks"][0]
    cfg = r["cfg"]
    assert not cfg.compact_messages
    assert r["mem"]["messages"].shape[1] == cfg.message_dim + 1
    assert any(k.startswith("msg_fc1") for k in r["params"])
