"""ICP of the centres onto the truth (the span `icp` of register/icp.py:
icp_loop), host ms of one scan as the program runs it, mean over the
traced scans."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, "icp")
