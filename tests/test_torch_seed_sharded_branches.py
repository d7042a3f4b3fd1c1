"""The seed-sharded run off the wave scan (tests/test_seed_sharded.py:
134-155): the pruning strategy (a BFS per batch over each rank's own
negatives) and the ``time`` tower (no T-PPR query at all), S = 2 over D = 2
CPU ranks (one seed each) against the port's one-process S = 2 run, one
epoch and validate, at JAX's bar (AP within 5e-3); and ``fit`` with one
lane per rank, whose state stays stacked on a seed axis of one."""

import numpy as np
import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.torch_rank_worker import F32, run_group, trainer

ATOL = 5e-3
BRANCHES = {
    "pruning": dict(tppr_strategy="pruning", beta_list=(0.5, 0.95),
                    n_degree=4, n_layer=2),
    "time": dict(embedding_module="time"),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_group(["branches", "fit_one_lane"],
                     tmp_path_factory.mktemp("branches"))


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_branch_matches_one_process(ranks, tmp_path, name):
    one = trainer(str(tmp_path), parallel_runs=2, **F32, **BRANCHES[name])
    tr = one.train_epoch()
    val, nn_val = one.validate()
    want = dict(train=tr.ap, val=val.ap, nn_val=nn_val.ap)
    for r in ranks["branches"]:
        for phase, ap in want.items():
            got = r[name][phase]
            assert got.shape == (2,)
            np.testing.assert_allclose(got, ap, rtol=0, atol=ATOL,
                                       err_msg=f"{name} {phase}")
    assert one.index_state is None


def test_fit_with_one_lane_per_rank(ranks, tmp_path):
    r0, r1 = ranks["fit_one_lane"]
    assert (r0["lanes"], r1["lanes"]) == ([0], [1])
    assert r0["results"] == r1["results"]
    got = r0["results"]["per_seed"]
    want = trainer(str(tmp_path), parallel_runs=2, n_epoch=1,
                   **F32).fit()["per_seed"]
    for k in ("test_ap", "nn_test_ap"):
        assert len(got[k]) == 2
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                   err_msg=k)
    assert got["stop_epoch"] == want["stop_epoch"]
