"""The program's spans in a ``torch.profiler`` trace of one bounded
segment: host, self, device and idle seconds per ``zebra.*`` span name.

The program (``zebra_tpu_torch/utils/profiling.py``) opens a
``record_function`` range per part of its work; parents (a batch, an
observe, a score) hold parts. Within ``trace.SEGMENT``, per span name:

- ``calls``, ``host_s`` (the ranges' summed durations) and ``self_s``
  (``host_s`` less the ``zebra.*`` ranges each one encloses);
- ``device_s``: the durations of the kernels and copies whose launching
  runtime call (matched by correlation id) lies in a range of the name,
  the innermost ``zebra.*`` range owning the launch;
- ``idle_s``: the segment's device-idle gaps (as ``trace.reduce`` finds
  them), each given to the innermost part range open at its middle.

The entry ``unnamed`` holds the idle seconds no part range covers and the
device seconds of launches outside every span. A trace without ``zebra.*``
spans (a program that records none) gives an empty table.

No loop calls ``reduce`` yet: a loop whose traced path puts
``reduce(prof)`` into the layer context under the key ``spans`` lets the
readers at the end (``total``, ``per``, ``idle_unnamed_pct``) give the
span metrics, and they give None without that key."""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.trace import SEGMENT

PREFIX = "zebra."
PARENTS = ("zebra.batch", "zebra.observe", "zebra.score")
UNNAMED = "unnamed"
FIELDS = ("calls", "host_s", "self_s", "device_s", "idle_s")


def _events(prof):
    """(segment ranges, spans (start, end, name, thread), runtime call
    start by correlation id, device (start, end, correlation id)) of the
    trace; device-side annotations left out, as ``trace._raw`` does."""
    seg, spans, launch, device = [], [], {}, []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        if e.device_type().name == "CUDA":
            if not e.is_user_annotation():
                device.append((s, s + e.duration_ns(), e.correlation_id()))
            continue
        name = e.name()
        if name.startswith(PREFIX):
            spans.append((s, s + e.duration_ns(), name, e.start_thread_id()))
        elif name == SEGMENT:
            seg.append((s, s + e.duration_ns()))
        elif name.startswith("cu"):
            # a runtime or driver call: a launch, a copy, a set
            launch[e.correlation_id()] = s
    return seg, spans, launch, device


def _gaps(device: Sequence[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] with no device interval running, found as
    ``trace.reduce`` finds them."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in device
                   if e > lo and s < hi)
    gaps, cur_e = [], lo
    for s, e in spans:
        if s > cur_e:
            gaps.append((cur_e, s))
        cur_e = max(cur_e, e)
    if cur_e < hi:
        gaps.append((cur_e, hi))
    return gaps


def _innermost(points: Sequence[int], ranges) -> List[Optional[int]]:
    """For each time in ``points``, the index into ``ranges`` ((start, end,
    ...) sorted by start) of the latest-starting range still open there,
    or None."""
    order = sorted(range(len(points)), key=points.__getitem__)
    out: List[Optional[int]] = [None] * len(points)
    active: list = []          # heap of (end, -start, index)
    j = 0
    for i in order:
        t = points[i]
        while j < len(ranges) and ranges[j][0] <= t:
            heapq.heappush(active, (ranges[j][1], -ranges[j][0], j))
            j += 1
        while active and active[0][0] < t:
            heapq.heappop(active)
        if active:
            # the latest start; of two starting together, the shorter
            out[i] = min(active, key=lambda a: (a[1], a[0]))[2]
    return out


def _self_ns(spans) -> List[int]:
    """Each span's duration less those of the spans directly inside it
    (same thread; ``spans`` sorted by start, then by longest)."""
    own = [e - s for s, e, _, _ in spans]
    open_: Dict[int, list] = {}            # thread → stack of indices
    for i, (s, e, _, th) in enumerate(spans):
        stack = open_.setdefault(th, [])
        while stack and spans[stack[-1]][1] <= s:
            stack.pop()
        if stack and spans[stack[-1]][1] >= e:
            own[stack[-1]] -= e - s
        stack.append(i)
    return own


def reduce(prof) -> Dict[str, Dict[str, float]]:
    """{span name or ``unnamed``: {calls, host_s, self_s, device_s,
    idle_s}} of the ``zebra.*`` spans inside the ``SEGMENT`` span."""
    seg, spans, launch, device = _events(prof)
    if not seg:
        raise RuntimeError(f"no {SEGMENT} span in the trace")
    lo, hi = min(s for s, _ in seg), max(e for _, e in seg)
    spans = sorted((x for x in spans if x[0] >= lo and x[1] <= hi),
                   key=lambda x: (x[0], -x[1]))
    if not spans:
        return {}
    table = {n: dict.fromkeys(FIELDS, 0.0) for n in
             sorted({x[2] for x in spans}) + [UNNAMED]}
    for (s, e, name, _), own in zip(spans, _self_ns(spans)):
        row = table[name]
        row["calls"] += 1
        row["host_s"] += (e - s) / 1e9
        row["self_s"] += own / 1e9
    inside = [(max(s, lo), min(e, hi), c) for s, e, c in device
              if e > lo and s < hi]
    # a kernel whose launch the trace lacks counts as launched at its start
    when = [launch.get(c, s) if c else s for s, _, c in inside]
    for (s, e, _), k in zip(inside, _innermost(when, spans)):
        table[UNNAMED if k is None else spans[k][2]]["device_s"] += (
            e - s) / 1e9
    parts = [x for x in spans if x[2] not in PARENTS]
    gaps = _gaps([(s, e) for s, e, _ in device], lo, hi)
    mids = [(s + e) // 2 for s, e in gaps]
    for (s, e), k in zip(gaps, _innermost(mids, parts)):
        table[UNNAMED if k is None else parts[k][2]]["idle_s"] += (
            e - s) / 1e9
    for row in table.values():
        row["calls"] = int(row["calls"])
    return table


# ------------------------------------------------------------ the readers

def total(ctx, names: Sequence[str], field: str) -> Optional[float]:
    """The sum of ``field`` over the spans ``names`` of the traced
    segment's table; None where the table lacks any of them."""
    table = ctx.get("spans") or {}
    if not all(n in table for n in names):
        return None
    return sum(table[n][field] for n in names)


def per(ctx, names: Sequence[str], field: str, unit: str,
        scale: float) -> Optional[float]:
    """``scale`` × the sum of ``field`` over ``names``, per call of the
    span ``unit`` (a batch, an observe); None where a span is missing."""
    got = total(ctx, names, field)
    n = total(ctx, [unit], "calls")
    if got is None or not n:
        return None
    return scale * got / n


def idle_unnamed_pct(ctx) -> Optional[float]:
    """The share of the segment's idle seconds that no part span covers."""
    table = ctx.get("spans") or {}
    idle = sum(row["idle_s"] for row in table.values())
    if not idle:
        return None
    return 100.0 * table[UNNAMED]["idle_s"] / idle
