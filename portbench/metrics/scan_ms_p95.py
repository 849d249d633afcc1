"""The 95th percentile, over every job of the window, of one scan's
latency: host clock from the call to the synchronised result, ms."""
from portbench.lib.timing import percentile


def read(ctx):
    if ctx.window is None or not ctx.window.latencies:
        return None
    return percentile([s * 1e3 for s in ctx.window.latencies], 95.0)
