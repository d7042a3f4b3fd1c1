"""The ``graph_attention`` tower (2 heads, n_degree 4, n_layer 2) on the
row-sharded layout (one seed over D = 2 CPU ranks, tests/
torch_rank_worker.py's ``sc_rows_graph_attention``): the whole batch's hop
tree on every rank, each block's distinct ids fetched, the block's tree
combined over the fetched rows (test_torch_row_sharded_recursive.py holds
the fetch itself). Held against the one-process port and JAX's
``Trainer(n_devices=2)`` from JAX's params with test_torch_row_sharded.py's
option bars (``option_tests``; its "options" section gives them and their
reasons)."""

import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import option_runs, option_tests

NAMES = ["graph_attention"]
globals().update(option_tests(NAMES))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_attention")


@pytest.fixture(scope="module")
def runs(tmp):
    return option_runs(tmp, NAMES)


def test_the_fetch_takes_distinct_ids(runs):
    for r in runs["graph_attention"]["ranks"]:
        fetched, named = r["ids"]["tower_fetch"]
        assert 0 < fetched < named / 4, (fetched, named)
        assert set(r["waves"].values()) == {0} and r["index"] is None
