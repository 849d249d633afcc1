"""K1's share of its roofline (lib/roofline.py's counts of the traced
scans over K1's summed time in the trace), percent."""
from portbench.lib.roofline import kernel_seconds, share_pct


def read(ctx):
    if ctx.trace is None or "K1" not in ctx.work:
        return None
    ops, nbytes = ctx.work["K1"]
    return share_pct(ops, nbytes, kernel_seconds(ctx.trace.kernels, "K1"))
