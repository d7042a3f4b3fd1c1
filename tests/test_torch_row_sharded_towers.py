"""The memory-only towers, ``identity`` and ``time``, on the row-sharded
layout (one seed over D = 2 CPU ranks, tests/torch_rank_worker.py's
``sc_rows_identity``, ``sc_rows_time``): a block fetches its distinct
query nodes' rows alone (the time tower reads their ``last_update``) and
embeds its roots at their event times. No index state, no wave and no
adjacency index. Held against the one-process port and JAX's
``Trainer(n_devices=2)`` from JAX's params with test_torch_row_sharded.py's
option bars (``option_tests``; its "options" section gives them and their
reasons)."""

import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import option_runs, option_tests

NAMES = ["identity", "time"]
globals().update(option_tests(NAMES))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_towers")


@pytest.fixture(scope="module")
def runs(tmp):
    return option_runs(tmp, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_fetch_is_the_query_rows_alone(runs, name):
    """3b' distinct query rows per block, no wave: the fetch names every
    block's roots once."""
    for r in runs[name]["ranks"]:
        assert set(r["waves"].values()) == {0} and r["index"] is None
        assert set(r["stats"]) == {"tower_fetch", "tower_send", "grad",
                                   "scores"}
        fetched, named = r["ids"]["tower_fetch"]
        assert fetched == named
