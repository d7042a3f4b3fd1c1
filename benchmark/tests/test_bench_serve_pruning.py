"""The pruning serving cell's check: it passes the program and fails the
control (the reference one precision down), ``stale`` (no observed event
folded into the adjacency index) and ``half_batch`` (each observe ingests
half its events). Tiny sizes on the CPU, the cell's own limits."""

from __future__ import annotations

import json

import pytest

from conftest import TINY_SERVE, harness

from benchmark import calibrate_cells, run
from benchmark.checks import verdict

CELL = "mooc-pruning.serve"


@pytest.fixture
def tiny_pruning(tiny):
    f = tiny / "benchmark" / "traffic" / "serve-pruning.json"
    f.write_text(json.dumps(dict(json.loads(f.read_text()), **TINY_SERVE)))
    return tiny


def test_program_is_correct(tiny_pruning):
    res = run.run_cell(harness(tiny_pruning, CELL, trace=True))
    assert res["correct"], res["checks"]
    for name in ("fold_ms_per_observe.pruning-serve",
                 "protocol_ms_per_observe.pruning-serve", "mfu_pct.serve"):
        assert res["metrics"][name]["value"] > 0, name


@pytest.mark.parametrize("kind", ["control", "stale", "half_batch"])
def test_faults_are_not_correct(tiny_pruning, kind):
    h = harness(tiny_pruning, CELL)
    nums = calibrate_cells.serve_readings(h, kind, 1.0)
    got = verdict(nums, h.limits)
    assert not got["correct"], nums
    if kind == "control":
        # the control fails by its memory; its scores may lie within
        # score_gap's limit
        over = {k for k, c in got["checks"].items() if c["value"] > c["limit"]}
        assert over & {"memory_gap", "memory_gap_start"}, nums
