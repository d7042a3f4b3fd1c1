"""The check fails what it must: the control (the reference in the
precision below the configuration's) and each fault a cell can have,
planted in the timed path, come out not correct; the sound program comes
out correct. Tiny sizes on the CPU, the cells' own limits."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from conftest import ROOT, harness

from benchmark import calibrate, run

TRAIN = ["wikipedia.train", "mooc-pruning.train", "wikipedia.train-s5"]
# seeds at which a ReLU of the link head tipped in one lane of the first
# step, so the first gradient read 1.8e-4 and 7.8e-5 against the reference
TIPPED_S5 = [5000213842, 7000316763]


@contextlib.contextmanager
def unchanged_train_state():
    """Every Adam step returns the parameters unchanged."""
    import zebra_tpu_torch.train.loop as loop

    orig = loop.make_optimizer

    def make(*a, **kw):
        opt = orig(*a, **kw)
        opt.step = lambda *x, **y: None
        return opt

    loop.make_optimizer = make
    try:
        yield
    finally:
        loop.make_optimizer = orig


@contextlib.contextmanager
def patched(cls, name, fn):
    orig = getattr(cls, name)
    setattr(cls, name, fn(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


def serve_fault(kind: str):
    from zebra_tpu_torch.serve import LinkPredictor

    if kind == "unchanged":
        return patched(LinkPredictor, "observe",
                       lambda orig: lambda self, *a: None)
    if kind == "half_batch":
        def half(orig):
            def observe(self, src, dst, t, eidx):
                n = len(src) // 2
                return orig(self, src[:n], dst[:n], t[:n], eidx[:n])
            return observe
        return patched(LinkPredictor, "observe", half)

    def altered(orig):
        def score(self, *a):
            p = np.array(orig(self, *a))
            p[0] = 1.0 - p[0]
            return p
        return score
    return patched(LinkPredictor, "score", altered)


@pytest.mark.parametrize("workload", TRAIN + ["wikipedia.serve"])
def test_sound_program_is_correct(tiny, workload):
    res = run.run_cell(harness(tiny, workload))
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
@pytest.mark.parametrize("workload", TRAIN)
def test_train_fault_is_caught(tiny, workload, fault):
    ctx = (unchanged_train_state() if fault == "unchanged"
           else calibrate.planted(fault))
    with ctx:
        res = run.run_cell(harness(tiny, workload))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
def test_serve_fault_is_caught(tiny, fault):
    with serve_fault(fault):
        res = run.run_cell(harness(tiny, "wikipedia.serve"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN + ["wikipedia.serve"])
def test_control_is_not_correct(tiny, workload):
    """The control's numbers, against the cell's limits."""
    from benchmark.checks import verdict

    h = harness(tiny, workload)
    if h.traffic["loop"] == "train":
        nums = calibrate.train_readings(h, "control")
    else:
        nums = calibrate.serve_readings(h, "control", 0.5)
    assert not verdict(nums, h.limits)["correct"], nums


@pytest.mark.card
@pytest.mark.parametrize("seed", TIPPED_S5)
def test_tipped_seed_is_correct(card, seed):
    """At the cell's real size, a seed whose first step tips a ReLU is
    within the cell's limits."""
    from benchmark.checks import verdict

    h = harness(ROOT, "wikipedia.train-s5", seed=seed, device=card)
    nums = calibrate.train_readings(h, "program")
    assert verdict(nums, h.limits)["correct"], nums
