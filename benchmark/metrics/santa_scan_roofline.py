"""``santa_scan``'s share of its roofline in the traced segment: the least time
its work needs (``work.bound_s`` of the bytes and compares counted from
the segment's columns) over the kernel's device time in the trace."""

from benchmark import trace, work

KERNEL = "santa_scan_kernel"


def read(ctx):
    got = ctx.get("santa_scan_work")
    if got is None or ctx.get("trace") is None:
        return None
    launches, seconds = trace.kernel_seconds(ctx["trace"]["kernels"], KERNEL)
    if not launches or seconds <= 0:
        return None
    least, _ = work.bound_s(*got)
    return 100.0 * least / seconds
