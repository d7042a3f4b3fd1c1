"""The port's spans (``zebra_tpu_torch/utils/profiling.py:span``): named
``record_function`` ranges that split a ``torch.profiler`` trace of a
train epoch, an evaluation phase, ``observe`` and ``score`` by the part of
the program the host was in.

Checks, on the CPU profiler at tiny sizes: a streaming train superchunk
runs reset, negatives, wave plan and wave scan (with the id read inside),
then one batch span per batch holding its parts in order, then the
readback; a pruning superchunk queries in every batch and plans and scans
no wave, and a memory-only tower neither; evaluation's batches hold no
backward or Adam; ``observe`` and ``score`` hold their parts. With no
profiler, ``span`` hands back one shared no-op object and never enters
``record_function``; the phase's metrics are bit-equal with and without a
profiler recording."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.test_torch_checkpoint import one_torch_thread  # noqa: F401
from zebra_tpu_torch.config import Config
from zebra_tpu_torch.data.dataset import split_data
from zebra_tpu_torch.data.synthetic import synthetic_stream
from zebra_tpu_torch.serve import LinkPredictor
from zebra_tpu_torch.train.loop import Trainer
from zebra_tpu_torch.utils import profiling
from zebra_tpu_torch.utils.profiling import NO_SPAN, span, span_table

BS, CHUNK = 50, 200
STRATEGIES = {
    "streaming": {},
    "pruning": dict(tppr_strategy="pruning", n_degree=4, n_layer=2),
    "identity": dict(embedding_module="identity"),
}
TRAIN_PARTS = ["zebra.forward", "zebra.backward", "zebra.adam",
               "zebra.protocol", "zebra.metrics"]
EVAL_PARTS = ["zebra.forward", "zebra.protocol", "zebra.metrics"]


def _trainer(tmp_path, **kw) -> Trainer:
    data, ef = synthetic_stream(n_events=600, n_users=20, n_items=20,
                                edge_dim=4, seed=0)
    cfg = Config(bs=BS, index_chunk=CHUNK, node_dim=8, time_dim=8,
                 memory_dim=8, topk=4, alpha_list=(0.1,), beta_list=(0.9,),
                 checkpoint_dir=str(tmp_path), **kw)
    return Trainer(cfg, split_data(data.sources, data.destinations,
                                   data.timestamps, data.edge_idxs,
                                   data.labels), ef, device="cpu")


def _spans(prof):
    """The trace's spans in start order: [(name, start µs, end µs)]."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name in profiling.SPANS),
                  key=lambda x: (x[1], -x[2]))


def _inside(spans, outer):
    """The spans that lie in the interval of ``outer`` (itself left out)."""
    _, lo, hi = outer
    return [s for s in spans if s is not outer and lo <= s[1] and s[2] <= hi]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof), prof


@pytest.mark.parametrize("strategy,phase", [
    ("streaming", "train"), ("pruning", "train"), ("identity", "train"),
    ("streaming", "val"), ("pruning", "val")])
def test_phase_spans(tmp_path, strategy, phase):
    tr = _trainer(tmp_path, **STRATEGIES[strategy])
    if phase == "train":
        r, spans, prof = _traced(lambda: tr.train_epoch(max_chunks=1))
        parts = TRAIN_PARTS
    else:
        tr.train_epoch()
        (r, _), spans, prof = _traced(tr.validate)
        # the val phase's spans, to its readback (the nn_val phase follows)
        spans = spans[:[s[0] for s in spans].index("zebra.readback") + 1]
        parts = EVAL_PARTS
    names = [n for n, _, _ in spans]
    batches = [s for s in spans if s[0] == "zebra.batch"]
    assert len(batches) == len(r.per_batch)
    waves = strategy == "streaming"
    query = strategy == "pruning"
    head = names[:names.index("zebra.batch")]
    if phase == "train":
        want = ["zebra.reset", "zebra.negatives"]
        if waves:
            want += ["zebra.wave_plan", "zebra.wave_scan", "zebra.read_ids"]
        assert head == want
        assert names.count("zebra.wave_plan") == int(waves)
    else:
        # the first phase over a stream plans all its superchunks at once
        n = tr._streams["val"].n_chunks
        assert head == (["zebra.wave_plan"] * n
                        + ["zebra.wave_scan", "zebra.read_ids"] if waves
                        else [])
    if waves:
        scan = spans[names.index("zebra.wave_scan")]
        assert [s[0] for s in _inside(spans, scan)] == ["zebra.read_ids"]
    else:
        assert not {"zebra.wave_plan", "zebra.wave_scan",
                    "zebra.read_ids"} & set(names)
    for batch in batches:
        got = [s[0] for s in _inside(spans, batch)]
        assert got == (["zebra.query"] if query else []) + parts
    assert names[-1] == "zebra.readback"
    assert spans[-1][1] >= batches[-1][2]
    if phase == "train":
        table = span_table(prof)
        assert table["zebra.batch"]["calls"] == len(batches)
        assert table["zebra.readback"]["calls"] == 1


def _predictor(tmp_path, **kw):
    tr = _trainer(tmp_path, **kw)
    tr.train_epoch()
    pred = LinkPredictor.from_trainer(tr)
    te = tr.splits.test
    cols = (te.sources[:BS], te.destinations[:BS],
            te.timestamps[:BS].astype(np.float32), te.edge_idxs[:BS])
    return pred, cols


@pytest.mark.parametrize("call,parts", [
    ("observe", ["zebra.request", "zebra.scan", "zebra.read_ids",
                 "zebra.protocol"]),
    ("score", ["zebra.request", "zebra.query", "zebra.forward",
               "zebra.readback"])])
def test_serving_spans(tmp_path, call, parts):
    pred, cols = _predictor(tmp_path)
    args = cols if call == "observe" else cols[:3]
    _, spans, _ = _traced(lambda: getattr(pred, call)(*args))
    assert spans[0][0] == f"zebra.{call}"
    assert [s[0] for s in _inside(spans, spans[0])] == parts
    assert len(spans) == 1 + len(parts)
    if call == "observe":
        scan = spans[[s[0] for s in spans].index("zebra.scan")]
        assert [s[0] for s in _inside(spans, scan)] == ["zebra.read_ids"]


def test_no_profiler_no_record_function(tmp_path, monkeypatch):
    """Without a profiler ``span`` returns the shared no-op and never builds
    a ``record_function``: a train superchunk, an observe and a score run
    with it made to raise."""
    pred, cols = _predictor(tmp_path)
    tr = _trainer(tmp_path)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert span("zebra.batch") is NO_SPAN
    assert span(profiling.QUERY) is span(profiling.SCAN)
    with span(profiling.BATCH) as got:
        assert got is None
    tr.train_epoch(max_chunks=1)
    pred.observe(*cols)
    pred.score(*cols[:3])
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="without a profiler"):
            span(profiling.BATCH)


@pytest.mark.parametrize("strategy", ["streaming", "pruning"])
def test_metrics_equal_with_and_without_profiler(tmp_path, strategy):
    plain = _trainer(tmp_path, **STRATEGIES[strategy])
    traced = _trainer(tmp_path, **STRATEGIES[strategy])
    a = plain.train_epoch()
    b, spans, _ = _traced(traced.train_epoch)
    assert spans
    np.testing.assert_array_equal(a.per_batch, b.per_batch)
    for x, y in zip(plain.mem, traced.mem):
        assert torch.equal(x, y)
    for x, y in zip(plain.params.parameters(), traced.params.parameters()):
        assert torch.equal(x, y)


class _Event:
    """A stand-in for a profiler's raw event: (name, start ns, end ns, on
    the device, correlation id)."""

    def __init__(self, name, start, end, device=False, corr=0):
        self._v = (name, start, end, device, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return SimpleNamespace(name="CUDA" if self._v[3] else "CPU")

    def is_user_annotation(self):
        return self._v[0].startswith("zebra.")

    def correlation_id(self):
        return self._v[4]


def test_span_table_gives_kernels_to_the_span_of_their_launch():
    """Kernels run after the host left the span that launched them; one
    launched by the autograd thread while backward waits counts there; a
    device-side annotation and a launch outside every span count nowhere;
    host ms hold the nested spans."""
    ms = 1_000_000
    ev = [
        _Event("zebra.batch", 0, 10 * ms),
        _Event("zebra.query", 1 * ms, 2 * ms),
        _Event("cudaLaunchKernel", 1 * ms, 1 * ms + 5, corr=7),
        _Event("zebra.backward", 3 * ms, 6 * ms),
        _Event("cudaLaunchKernel", 4 * ms, 4 * ms + 5, corr=8),
        _Event("cudaLaunchKernel", 11 * ms, 11 * ms + 5, corr=9),
        _Event("bwd", 20 * ms, 23 * ms, device=True, corr=8),
        _Event("bfs", 23 * ms, 24 * ms, device=True, corr=7),
        _Event("late", 24 * ms, 25 * ms, device=True, corr=9),
        _Event("zebra.backward", 20 * ms, 30 * ms, device=True, corr=8),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    table = span_table(prof)
    assert table == {
        "zebra.batch": dict(calls=1, host_ms=10.0, device_ms=0.0),
        "zebra.query": dict(calls=1, host_ms=1.0, device_ms=1.0),
        "zebra.backward": dict(calls=1, host_ms=3.0, device_ms=3.0)}
