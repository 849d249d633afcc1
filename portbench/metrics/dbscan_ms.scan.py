"""Per-block DBSCAN, kernel K1 (kernels/csrc/dbscan_block.cu), device ms
of one scan from the profiler's trace, mean over the traced scans."""
from portbench.lib.roofline import kernel_seconds


def read(ctx):
    if ctx.trace is None or not ctx.traced_jobs:
        return None
    sec = kernel_seconds(ctx.trace.kernels, "K1")
    return sec * 1e3 / ctx.traced_jobs if sec > 0 else None
