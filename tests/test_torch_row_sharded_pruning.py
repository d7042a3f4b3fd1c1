"""The pruning strategy on the row-sharded layout (one seed's node rows
over D = 2 CPU ranks, tests/torch_rank_worker.py's ``sc_rows_pruning``):
every rank runs the whole batch's BFS over the adjacency index it holds
whole and fetches the pruned neighbors' rows through the batch fetch; no
wave runs. Held against the one-process port and JAX's
``Trainer(n_devices=2)`` from JAX's params at test_torch_row_sharded.py's
sizes (1,200 events, 40 + 40 nodes, bs 50, dims 16, top-5, f32 tables,
dropout 0), BFS width 4, depth 2, β (0.5, 0.95), with that module's option
bars (``option_tests``; its "options" section gives them and their
reasons)."""

import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import option_runs, option_tests

NAMES = ["pruning"]
globals().update(option_tests(NAMES))


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_pruning")


@pytest.fixture(scope="module")
def runs(tmp):
    return option_runs(tmp, NAMES)


def test_no_wave_and_the_bfs_seconds_count(runs):
    """No index state, no wave, no wave fetch; every batch's BFS counts
    into the phase's index seconds, on every rank."""
    for r in runs["pruning"]["ranks"]:
        assert r["index"] is None and r["train_index"] is None
        assert set(r["waves"].values()) == {0}
        assert "wave" not in r["stats"] and "tower_fetch" in r["stats"]
        assert all(s > 0 for s in r["index_seconds"].values())
