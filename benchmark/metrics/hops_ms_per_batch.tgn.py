"""Device milliseconds per train batch launched inside the program's
``zebra.hops`` span (``spans.reduce`` of the traced superchunk); None
where the program records no such span."""

from benchmark import spans


def read(ctx):
    return spans.per(ctx, ["zebra.hops"], "device_s", "zebra.batch", 1e3)
