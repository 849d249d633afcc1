"""Shapes in both coordinate systems, kernel K2 (kernels/csrc/shapes.cu),
device ms of one scan from the profiler's trace, mean over the traced
scans."""
from portbench.lib.roofline import kernel_seconds


def read(ctx):
    if ctx.trace is None or not ctx.traced_jobs:
        return None
    sec = kernel_seconds(ctx.trace.kernels, "K2")
    return sec * 1e3 / ctx.traced_jobs if sec > 0 else None
