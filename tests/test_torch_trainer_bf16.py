"""The port's Trainer against the JAX Trainer at the default bf16 memory
and message tables: test_torch_trainer.py's comparison, with the bf16 bars
stated and measured there."""

import pytest

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from tests.test_torch_trainer import (
    PHASES,
    check_params,
    check_phase,
    check_streams,
    make_pair,
)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair("bfloat16", tmp_path_factory.mktemp("ckpt"))


def test_streams_and_negatives_match_jax(pair):
    check_streams(pair)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_metrics_match_jax(pair, phase):
    check_phase(pair, phase)


def test_params_after_epoch_match_jax(pair):
    check_params(pair)
