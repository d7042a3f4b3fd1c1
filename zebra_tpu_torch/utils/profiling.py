"""Observability: phase timers and device tracing (counterpart of
``zebra_tpu/utils/profiling.py``).

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

# the single-device model options a profiler run may turn on, under the
# training command line's names and defaults
OPTION_FLAGS = {
    "aggregator": dict(default="last", choices=["last", "mean"]),
    "message_function": dict(default="identity", choices=["identity", "mlp"]),
    "use_source_embedding_in_message": dict(action="store_true"),
    "use_destination_embedding_in_message": dict(action="store_true"),
    "lazy_unique_cap": dict(type=int, default=0),
}


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
