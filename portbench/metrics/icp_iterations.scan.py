"""ICP iterations of one scan (the counter `iterations` of the span `icp`
of register/icp.py: icp_loop), mean over the traced scans."""
from portbench.lib.spans import counter


def read(ctx):
    return counter(ctx, "iterations", under=("icp",))
