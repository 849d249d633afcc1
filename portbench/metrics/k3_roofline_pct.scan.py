"""K3's share of its roofline in the scan's ICP (lib/roofline.py's
counts of the traced scans' iterations over K3's summed time in the
trace), percent."""
from portbench.lib.roofline import kernel_seconds, share_pct


def read(ctx):
    if ctx.trace is None or "K3" not in ctx.work:
        return None
    ops, nbytes = ctx.work["K3"]
    return share_pct(ops, nbytes, kernel_seconds(ctx.trace.kernels, "K3"))
