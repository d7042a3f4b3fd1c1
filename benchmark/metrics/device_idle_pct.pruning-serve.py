"""The share of the traced segment in which no device operation ran:
1 - (union of kernel and copy intervals) / the segment's span."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or tr["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
