"""K2's share of its roofline (lib/roofline.py's counts of the traced
scans over K2's summed time in the trace), percent."""
from portbench.lib.roofline import kernel_seconds, share_pct


def read(ctx):
    if ctx.trace is None or "K2" not in ctx.work:
        return None
    ops, nbytes = ctx.work["K2"]
    return share_pct(ops, nbytes, kernel_seconds(ctx.trace.kernels, "K2"))
