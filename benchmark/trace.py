"""Reduction of a ``torch.profiler`` trace of one bounded segment: device
time by operation, the union of device intervals (busy seconds), and the
idle gaps by what the host was doing.

Device operations are the trace's CUDA-side events (kernels, copies,
sets) other than user annotations. A gap is a stretch of the segment with
no device operation running; it is named by the innermost host operation
running at its middle (a span the harness records around its own calls is
the outermost there)."""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

SEGMENT = "bench.segment"


def _raw(prof):
    """(name, is_device, start_ns, end_ns) of every event but annotations
    on the device."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type().name == "CUDA"
        if dev and e.is_user_annotation():
            continue
        out.append((e.name(), dev, e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def reduce(prof, top: int = 10) -> Dict:
    """{busy_s, span_s, kernels: {name: [count, s]}, device_ops, idle_gaps}
    of the events inside the ``SEGMENT`` span."""
    events = _raw(prof)
    seg = [(s, e) for n, dev, s, e in events if not dev and n == SEGMENT]
    if not seg:
        raise RuntimeError(f"no {SEGMENT} span in the trace")
    lo, hi = min(s for s, _ in seg), max(e for _, e in seg)
    kernels: Dict[str, List] = {}
    spans = []
    for name, dev, s, e in events:
        if dev and e > lo and s < hi:
            s, e = max(s, lo), min(e, hi)
            got = kernels.setdefault(name, [0, 0.0])
            got[0] += 1
            got[1] += (e - s) / 1e9
            spans.append((s, e))
    spans.sort()
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for s, e in spans:
        if s > cur_e:
            gaps.append((cur_e, s))
            if cur_s is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            if cur_s is None:
                cur_s = s
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < hi:
        gaps.append((cur_e, hi))
    host = sorted((s, e, n) for n, dev, s, e in events
                  if not dev and e > lo and s < hi)
    idle = _name_gaps(gaps, host)
    ops = sorted(((n, v[1]) for n, v in kernels.items()), key=lambda x: -x[1])
    return dict(busy_s=busy / 1e9, span_s=(hi - lo) / 1e9, kernels=kernels,
                device_ops=[[n, s] for n, s in ops[:top]],
                idle_gaps=[[n, s] for n, s in sorted(
                    idle.items(), key=lambda x: -x[1])[:top]])


def _name_gaps(gaps: List[Tuple[int, int]], host) -> Dict[str, float]:
    """Seconds of idle device time by the innermost host operation running
    at each gap's middle ('none' where nothing ran)."""
    out: Dict[str, float] = {}
    active: list = []          # heap of (end, start, name)
    j = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
        mid = (s + e) // 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (host[j][1], host[j][0], host[j][2]))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        name = "none"
        if active:
            # the latest start still running is the innermost
            name = max(active, key=lambda a: a[1])[2]
        out[name] = out.get(name, 0.0) + (e - s) / 1e9
    return out


def kernel_seconds(kernels: Dict, name: str) -> Tuple[int, float]:
    """(launches, seconds) of the device operations whose name contains
    ``name``."""
    n, s = 0, 0.0
    for k, (c, sec) in kernels.items():
        if name in k:
            n, s = n + c, s + sec
    return n, s
