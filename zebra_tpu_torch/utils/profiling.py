"""Observability: phase timers, the program's spans and device tracing
(counterpart of ``zebra_tpu/utils/profiling.py``).

- ``span``: a named range of the program (``SPANS``) that lands in a
  ``torch.profiler`` trace beside the aten operations and kernels it
  encloses, and costs one flag read when no profiler records;
  ``span_table`` reads a profile's spans back by name.
- ``part``: the span of a part of a train batch (or of the wave scan),
  which also marks its end on the device while the recorder is armed
  (``marking``: ``Trainer.train_epoch(marks=...)``).
- ``PhaseTimers``: named wall-clock accumulators with an event counter,
  which give the per-epoch log line (tppr/train/val seconds) and the
  events/s rate.
- ``trace_context``: a ``torch.profiler`` trace of a region, with CUDA
  activity where a card is present, exported as a Chrome trace into a
  directory (``with trace_context("/tmp/trace"): ...``).
- ``device_ms``: a call's median device time on the card (CUDA events).
- ``count_ops``: the aten operations a call enqueues;
- ``add_option_args``/``option_overrides``: the model options' flags of
  the profilers (``profile_train``, ``profile_serve``)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

# the single-device model options a profiler run may turn on, under the
# training command line's names and defaults
OPTION_FLAGS = {
    "aggregator": dict(default="last", choices=["last", "mean"]),
    "message_function": dict(default="identity", choices=["identity", "mlp"]),
    "use_source_embedding_in_message": dict(action="store_true"),
    "use_destination_embedding_in_message": dict(action="store_true"),
    "lazy_unique_cap": dict(type=int, default=0),
}


# The program's spans. A parent holds parts; a part encloses all the host
# work of its layer in one call, the Python between its operations too.
# Training and serving share the part names; the parent tells them apart.
RESET = "zebra.reset"            # a train epoch's zeroed memory and index
NEGATIVES = "zebra.negatives"    # the epoch's train negatives, drawn, uploaded
WAVE_PLAN = "zebra.wave_plan"    # one superchunk's host wave plan and upload
WAVE_SCAN = "zebra.wave_scan"    # one superchunk's wave scan
READ_IDS = "zebra.read_ids"      # the host read of the columns' id range
BATCH = "zebra.batch"            # parent: one batch of a phase
CAPTURE = "zebra.capture"        # the CUDA graphs of a train batch, or of
                                 # serving's protocol, captured
QUERY = "zebra.query"            # T-PPR queries: the BFS, or the index rows
FORWARD = "zebra.forward"        # towers, scores and loss
HOPS = "zebra.hops"              # a recursive tower's hop tree (forward)
ROWS = "zebra.rows"              # its memory rows, level by level, lazily
                                 # updated in training (forward)
ATTENTION = "zebra.attention"    # its layers, deepest first (forward)
BACKWARD = "zebra.backward"
ALLREDUCE = "zebra.allreduce"    # a row-sharded batch's gradients summed
ADAM = "zebra.adam"
PROTOCOL = "zebra.protocol"      # the memory protocol
METRICS = "zebra.metrics"        # a batch's metrics on the device
FETCH = "zebra.fetch"            # a row-sharded block's rows fetched
SEND = "zebra.send"              # the rows a block wins sent to their owners
READBACK = "zebra.readback"      # the host reads of metrics or scores
OBSERVE = "zebra.observe"        # parent: LinkPredictor.observe
SCORE = "zebra.score"            # parent: LinkPredictor.score
REQUEST = "zebra.request"        # host columns checked, mapped and uploaded
SCAN = "zebra.scan"              # serving's index scan
FOLD = "zebra.fold"              # serving's adjacency rebuild (observe)
PARENTS = (BATCH, OBSERVE, SCORE)
SPANS = (RESET, NEGATIVES, WAVE_PLAN, WAVE_SCAN, READ_IDS, BATCH, CAPTURE,
         QUERY, FORWARD, HOPS, ROWS, ATTENTION, BACKWARD, ALLREDUCE, ADAM,
         PROTOCOL, METRICS, FETCH, SEND, READBACK, OBSERVE, SCORE, REQUEST,
         SCAN, FOLD)


class _NoSpan:
    """The span of a run that no profiler records: enters and exits."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """``with span(QUERY): ...``: a ``record_function`` range named
    ``name`` while a ``torch.profiler`` records, else the shared
    ``NO_SPAN``. Adds no device operation and no synchronisation."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return NO_SPAN


# The recorder: the list that ``marking`` armed, else None.
_marks: Optional[list] = None


def mark_event():
    """The recorder's event factory: a CUDA event recorded after the work
    enqueued so far."""
    import torch

    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


@contextlib.contextmanager
def marking(marks: Optional[list]) -> Iterator[None]:
    """Arm the recorder for the block: ``marks``, a list, receives a
    (name, event) pair at each ``mark`` and at the end of each ``part``;
    None records nothing."""
    global _marks
    armed, _marks = _marks, marks
    try:
        yield
    finally:
        _marks = armed


def mark(name: str) -> None:
    """A mark named ``name`` while the recorder is armed."""
    if _marks is not None:
        _marks.append((name, mark_event()))


@contextlib.contextmanager
def _marked(name: str) -> Iterator[None]:
    with span(name):
        yield
    mark(name.split(".", 1)[1])


def part(name: str):
    """``with part(FORWARD): ...``: ``span(name)``, which marks its end
    (``forward``) while the recorder is armed. Only the parts of a batch
    and the wave scan take it; parents and nested spans take ``span``."""
    return span(name) if _marks is None else _marked(name)


def span_table(prof) -> Dict[str, Dict[str, float]]:
    """The spans of a finished ``torch.profiler`` run by name: calls, host
    ms (the ranges' summed durations) and device ms (the kernels and
    copies whose runtime call lies in a range of the name, the innermost
    span owning it; matched by correlation id, so the autograd thread's
    launches count under the ``backward`` range that waits for them, and a
    launch from outside any aten operation counts too). A span's host ms
    hold the spans nested in it: a batch its parts, a scan its id read."""
    from bisect import bisect_right

    spans, launch, kernels = [], {}, []
    for e in prof.profiler.kineto_results.events():
        t = e.start_ns()
        if e.device_type().name == "CUDA":
            if not e.is_user_annotation():
                kernels.append((e.correlation_id(), t, e.duration_ns()))
            continue
        name = e.name()
        if name in SPANS:
            spans.append((t, t + e.duration_ns(), name))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = t     # a runtime or driver call
    spans.sort(key=lambda x: (x[0], -x[1]))
    parent, stack = [], []
    for i, (t0, t1, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < t1:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    out: Dict[str, Dict[str, float]] = {}
    for t0, t1, name in spans:
        row = out.setdefault(name, dict(calls=0, host_ms=0.0, device_ms=0.0))
        row["calls"] += 1
        row["host_ms"] += (t1 - t0) / 1e6
    starts = [x[0] for x in spans]
    for corr, t, dur in kernels:
        at = launch.get(corr, t) if corr else t
        i = bisect_right(starts, at) - 1
        while i >= 0 and spans[i][1] < at:
            i = parent[i]
        if i >= 0:
            out[spans[i][2]]["device_ms"] += dur / 1e6
    return out


class PhaseTimers:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.events: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str, n_events: int = 0) -> Iterator[None]:
        t0 = time.time()
        try:
            yield
        finally:
            self.seconds[name] += time.time() - t0
            self.events[name] += n_events

    def rate(self, name: str) -> float:
        """events/s for a phase (0 when untimed)."""
        s = self.seconds.get(name, 0.0)
        return self.events.get(name, 0) / s if s > 0 else 0.0

    def summary(self) -> str:
        parts = []
        for name in sorted(self.seconds):
            part = f"{name}: {self.seconds[name]:.2f}s"
            if self.events.get(name):
                part += f" ({self.rate(name):.0f} ev/s)"
            parts.append(part)
        return ", ".join(parts)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the region with ``torch.profiler`` (CPU, and CUDA where a card
    is present) and write ``trace_<pid>_<ns>.json`` into ``log_dir``; a
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_ms(fn: Callable[[], object], n: int = 100, per_round: int = 100,
              warmup: int = 10) -> float:
    """Median device time of ``fn()`` in ms over ``n`` calls (CUDA events).
    Calls run in rounds of ``per_round``; before each round a spin kernel
    holds the stream while the round is enqueued, so the events time the
    device's work and not the host's launch latency. A round must fit the
    device's queue of pending launches (about a thousand, events included):
    once it is full the host waits, and the calls after the spin would be
    timed at the host's enqueue rate."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 10
    times = []
    for lo in range(0, n, per_round):
        m = min(per_round, n - lo)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(m)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(m)]
        # ≥ 2 GHz·(2·enqueue time) cycles outlasts the enqueue at any clock
        torch.cuda._sleep(int(min(2 * m * host_s * 2e9, 2e10)))
        for s, e in zip(starts, ends):
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return float(np.median(times))


def count_ops(fn: Callable[[], object]) -> int:
    """The aten operations one call of ``fn`` dispatches (each one a
    launch or a host-side tensor operation)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def add_option_args(parser) -> None:
    """Add the model options' flags (``OPTION_FLAGS``) to an argparse
    parser."""
    for name, kw in OPTION_FLAGS.items():
        parser.add_argument(f"--{name}", **kw)


def option_overrides(ns) -> Dict[str, object]:
    """The options of parsed arguments ``ns`` as Config overrides."""
    return {name: getattr(ns, name) for name in OPTION_FLAGS}
