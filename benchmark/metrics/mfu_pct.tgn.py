"""The model FLOPs of the window (``work_tgn``: the two-hop tree's
projections, attention and merge layers on every slot, the head, the GRU
once per distinct tree node with a pending message and once per committed
positive) over its seconds, as a share of the H100's published float32
peak."""

from benchmark import work


def read(ctx):
    if not ctx.get("window_s") or ctx.get("model_flops") is None:
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / work.F32_FLOPS_PER_S
