"""The other paths of the row-sharded options (one seed over D = 2 CPU
ranks, tests/torch_rank_worker.py's ``sc_rows_paths``): for pruning,
``mean`` and ``graph_attention``, validate() and test() under host backups
from a train-end state file, bit-equal to the device protocol, and a
2-epoch ``fit`` resumed from the state file of a 1-epoch one, bit-equal to
the uninterrupted fit (test_torch_row_sharded.py's and
test_torch_row_sharded_fit.py's bars for the flagship)."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.torch_rank_worker import PATH_OPTIONS, run_group


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_group(["rows_paths"],
                     tmp_path_factory.mktemp("rows_paths"))["rows_paths"]


@pytest.mark.parametrize("name", PATH_OPTIONS)
def test_host_backup_is_bit_equal(ranks, name):
    for r in ranks:
        dev, host = r[name]["backups"][False], r[name]["backups"][True]
        for a, b in zip(dev["per_batch"], host["per_batch"]):
            np.testing.assert_array_equal(a, b)
        for k in dev["mem"]:
            assert torch.equal(dev["mem"][k], host["mem"][k]), k


@pytest.mark.parametrize("name", PATH_OPTIONS)
def test_resume_is_bit_equal(ranks, name):
    for r in ranks:
        got = r[name]
        assert got["out"] == got["ref"]
        assert got["params_equal"] and got["mem_equal"]
    assert ranks[0][name]["out"] == ranks[1][name]["out"]
