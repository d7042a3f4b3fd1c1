"""The JAX interleave regression on the row-sharded layout
(tests/test_interleave.py:64-71, the graph_attention case): two ranks with
owner-aligned waves and, by the auto rule, the node-id interleave, under
the graph_attention tower (tests/torch_rank_worker.py's
``sc_rows_graph_attention_il``). The adjacency index must live in the
permuted id space the streams query with.

Bars: against JAX's interleaved ``Trainer(n_devices=2)`` from the same
params, test_torch_row_sharded.py's option bars for JAX and the memory,
with no tie allowance (a one-process Trainer refuses the interleaved state
file, and the one-process port runs in the plain id space); against
the plain one-process port (the model is equivariant in node ids): the
train and val APs within JAX's 5e-3 (tests/test_interleave.py:73-97), the
memory mapped back through the permutation within 1e-6, and the state
file served on external ids within 1e-5 of the plain one-process file."""

import numpy as np
import pytest
import torch

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_row_sharded import (
    check_jax,
    check_memory,
    check_params_across_ranks,
    option_runs,
    served_scores,
)
from tests.torch_rank_worker import PHASES
from zebra_tpu_torch.parallel.sharding import interleave_permutation

NAME = "graph_attention_il"
AP_ATOL = 5e-3


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("rows_interleave")


@pytest.fixture(scope="module")
def run(tmp):
    return option_runs(tmp, [NAME])[NAME]


def test_the_ids_are_interleaved(run):
    for r in run["ranks"]:
        assert r["cfg"].interleave_shards == 2
    assert run["one"]["cfg"].interleave_shards == 0


@pytest.mark.parametrize("phase", PHASES)
def test_metrics_match_jax_row_sharded(run, phase):
    check_jax(run, phase, ties=False)


@pytest.mark.parametrize("when", ["train_mem", "mem"])
def test_memory_matches_jax(run, when):
    check_memory(run, when, "jax")


def test_params_bit_equal_across_ranks(run):
    check_params_across_ranks(run)


@pytest.mark.parametrize("phase", ["train", "val"])
def test_ap_matches_the_plain_run(run, phase):
    got = run["ranks"][0]["per_batch"][phase][:, 1].mean()
    want = run["one"]["per_batch"][phase][:, 1].mean()
    assert abs(got - want) <= AP_ATOL, (got, want)


@pytest.mark.parametrize("when", ["train_mem", "mem"])
def test_memory_is_the_plain_runs_relabelled(run, when):
    got = run["ranks"][0][when]["memory"]
    perm = torch.from_numpy(interleave_permutation(got.shape[0], 2).astype(
        np.int64))
    np.testing.assert_allclose(got[perm].numpy(),
                               run["one"][when]["memory"].numpy(), rtol=0,
                               atol=1e-6)


def test_state_file_serves_external_ids(run, tmp):
    got = served_scores(run["ranks"][0]["state"])
    want = served_scores(str(tmp / f"{NAME}_one.state.ckpt"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
