"""Observability: phase timers and device tracing (counterpart of
``zebra_tpu/utils/profiling.py``).

- ``PhaseTimers``: named wall-clock accumulators with an event counter,
  which give the per-epoch log line (tppr/train/val seconds) and the
  events/s rate.
- ``trace_context``: a ``torch.profiler`` trace of a region, with CUDA
  activity where a card is present, exported as a Chrome trace into a
  directory (``with trace_context("/tmp/trace"): ...``)."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


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
