"""The port's Trainer with the memory-only towers, identity and time,
against the JAX package's, at the sizes and bars of
test_torch_towers_trainer.py (1,200 events, dims 16, f32 tables, dropout
0): one train step, and an epoch with ``validate()`` and ``test()``. These
towers read neither T-PPR queries nor the adjacency index: no index state,
no wave, no santa kernel, and no adjacency index is built under the
streaming strategy."""

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

TOWERS = ("identity", "time")


@pytest.fixture(scope="module", params=TOWERS)
def pair(request, tmp_path_factory):
    return _pair(tmp_path_factory, request.param)


@pytest.mark.parametrize("phase_name", PHASES)
def test_phase_metrics_match_jax(pair, phase_name):
    _check_phase(pair, phase_name)


def test_params_after_epoch_match_jax(pair):
    _check_params(pair)


def test_no_index_no_wave_no_kernel(pair):
    _check_no_index(pair)
    assert pair[1].train_nbr_index is pair[1].full_nbr_index is None


@pytest.mark.parametrize("tower", TOWERS)
def test_one_train_step_matches_jax(tower):
    _one_step(tower)
