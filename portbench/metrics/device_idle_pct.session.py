"""The device's idle share of the traced window: 100 (1 - busy / window),
busy the union of the kernels, copies and sets in the profiler's trace.
Nothing where the trace holds no device activity."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
