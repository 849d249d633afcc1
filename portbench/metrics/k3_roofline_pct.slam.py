"""K3's share of its roofline at the survey's N = M = 2,048 (one call's
counts times the calls the program's counter counted, over K3's summed
time in the trace), percent."""
from portbench.lib.roofline import kernel_seconds, share_pct


def read(ctx):
    if ctx.trace is None or "K3_call" not in ctx.work:
        return None
    calls = ctx.counters.get("k3_launches", 0) * ctx.traced_jobs
    # the harness sums each traced job's work: one call's counts a job
    ops, nbytes = (v / ctx.traced_jobs for v in ctx.work["K3_call"])
    return share_pct(ops * calls, nbytes * calls,
                     kernel_seconds(ctx.trace.kernels, "K3"))
