"""The model FLOPs of the window (``work``: towers, head, lazy and commit
GRU at the reference's counts) over its seconds, as a share of the H100's
published float32 peak."""

from benchmark import work


def read(ctx):
    if not ctx.get("window_s"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / work.F32_FLOPS_PER_S
