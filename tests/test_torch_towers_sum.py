"""The port's Trainer with the graph_sum tower against the JAX package's,
at the sizes and bars of test_torch_towers_trainer.py (1,200 events, dims
16, n_degree 4, n_layer 2, f32 tables, dropout 0): one train step, and an
epoch with ``validate()`` and ``test()``; no T-PPR index, no wave, no santa
kernel."""

import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_towers_trainer import (
    PHASES,
    _check_no_index,
    _check_params,
    _check_phase,
    _one_step,
    _pair,
)

TOWER = "graph_sum"


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _pair(tmp_path_factory, TOWER)


@pytest.mark.parametrize("phase_name", PHASES)
def test_phase_metrics_match_jax(pair, phase_name):
    _check_phase(pair, phase_name)


def test_params_after_epoch_match_jax(pair):
    _check_params(pair)


def test_no_index_no_wave_no_kernel(pair):
    _check_no_index(pair)


@pytest.mark.parametrize("n_layer", [1, 2])
def test_one_train_step_matches_jax(n_layer):
    _one_step(TOWER, n_layer=n_layer)
