"""The span reducer (``benchmark/spans.py``) and the readers of the span
metrics: a CPU trace of a toy nest of spans (calls, self seconds adding up
to the outermost span's, the idle gap given to the part open at its middle
or to ``unnamed``), a made-up trace with device work (each kernel to the
span of its launch), and the readers: per-call figures from a table, and
silence on a program that records no span or a context without a table."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import spans, trace


def _nest(layout):
    """Run ``layout`` — [(span name or None, seconds)] inside one
    ``zebra.batch`` — in the segment, under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.SEGMENT):
            with record_function("zebra.batch"):
                for name, sec in layout:
                    if name is None:
                        time.sleep(sec)
                        continue
                    with record_function(name):
                        with record_function("zebra.read_ids"):
                            time.sleep(sec / 4)
                        time.sleep(sec)
    return spans.reduce(prof)


@pytest.mark.parametrize("layout,idle_to", [
    ([("zebra.query", 0.02), (None, 0.2), ("zebra.forward", 0.02)],
     "unnamed"),
    ([("zebra.query", 0.02), ("zebra.forward", 0.2), (None, 0.02),
      ("zebra.query", 0.02)], "zebra.forward")])
def test_toy_nest(layout, idle_to):
    table = _nest(layout)
    named = [n for n, _ in layout if n]
    for name in set(named):
        assert table[name]["calls"] == named.count(name)
    assert table["zebra.read_ids"]["calls"] == len(named)
    assert table["zebra.batch"]["calls"] == 1
    host = table["zebra.batch"]["host_s"]
    assert sum(r["self_s"] for r in table.values()) == pytest.approx(
        host, rel=1e-9)
    leaf = table["zebra.read_ids"]
    assert leaf["self_s"] == leaf["host_s"]
    for name in set(named):
        assert 0 < table[name]["self_s"] < table[name]["host_s"]
    bare = sum(sec for n, sec in layout if n is None)
    assert table["zebra.batch"]["self_s"] == pytest.approx(bare, abs=0.01)
    # no device work on the CPU: the segment is one gap, named by its middle
    idle = {n: r["idle_s"] for n, r in table.items() if r["idle_s"]}
    assert list(idle) == [idle_to]
    assert all(r["device_s"] == 0 for r in table.values())


class _Event:
    def __init__(self, name, start, end, device=False, corr=0, thread=1):
        self._v = (name, start, end, device, corr, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return SimpleNamespace(name="CUDA" if self._v[3] else "CPU")

    def is_user_annotation(self):
        return self._v[0].startswith("zebra.") or self._v[0] == "bench.x"

    def correlation_id(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def _fake(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_kernels_go_to_the_span_of_their_launch():
    """Two launches in a batch's query and forward run after the batch has
    ended; a launch on another thread inside backward's range goes to it;
    a device annotation is no kernel; the idle stretch between the last
    part and the kernels, and the segment's tail, are unnamed."""
    ev = [
        _Event(trace.SEGMENT, 0, 1000),
        _Event("zebra.batch", 10, 400),
        _Event("zebra.query", 20, 100),
        _Event("cudaLaunchKernel", 30, 35, corr=7),
        _Event("zebra.forward", 100, 200),
        _Event("cudaLaunchKernel", 150, 155, corr=8),
        _Event("zebra.backward", 200, 300),
        _Event("cudaLaunchKernel", 250, 255, corr=9, thread=2),
        _Event("aten::mm", 140, 160, corr=8),
        _Event("gemm", 500, 600, device=True, corr=8),
        _Event("kern", 600, 700, device=True, corr=7),
        _Event("bwd", 700, 800, device=True, corr=9),
        _Event("bench.x", 500, 900, device=True, corr=9),
    ]
    table = spans.reduce(_fake(ev))
    assert table["zebra.forward"]["device_s"] == pytest.approx(100e-9)
    assert table["zebra.query"]["device_s"] == pytest.approx(100e-9)
    assert table["zebra.backward"]["device_s"] == pytest.approx(100e-9)
    assert table["zebra.batch"]["device_s"] == 0
    # gaps [0, 500) (middle 250: backward) and [800, 1000) (none open)
    assert table["zebra.backward"]["idle_s"] == pytest.approx(500e-9)
    assert table["unnamed"]["idle_s"] == pytest.approx(200e-9)
    assert table["zebra.batch"]["self_s"] == pytest.approx(110e-9)


def test_no_span_no_table_no_number():
    ev = [_Event(trace.SEGMENT, 0, 1000), _Event("aten::mm", 10, 20, corr=1),
          _Event("gemm", 30, 40, device=True, corr=1)]
    assert spans.reduce(_fake(ev)) == {}
    for ctx in ({}, {"spans": {}}, {"spans": None}):
        assert spans.total(ctx, ["zebra.wave_plan"], "host_s") is None
        assert spans.per(ctx, ["zebra.protocol"], "host_s", "zebra.batch",
                         1e3) is None
        assert spans.idle_unnamed_pct(ctx) is None


def test_readers_per_call():
    row = dict.fromkeys(spans.FIELDS, 0.0)
    table = {"zebra.batch": dict(row, calls=4, host_s=0.8),
             "zebra.forward": dict(row, calls=4, host_s=0.2, device_s=0.1,
                                   idle_s=0.3),
             "zebra.adam": dict(row, calls=4, host_s=0.1, device_s=0.02),
             spans.UNNAMED: dict(row, idle_s=0.1)}
    ctx = {"spans": table}
    assert spans.per(ctx, ["zebra.forward", "zebra.adam"], "device_s",
                     "zebra.batch", 1e3) == pytest.approx(30.0)
    assert spans.per(ctx, ["zebra.backward"], "host_s", "zebra.batch",
                     1e3) is None
    assert spans.idle_unnamed_pct(ctx) == pytest.approx(25.0)
