"""Fusion with the noise re-cluster (the span `fusion` of
cluster/pipeline.py: cluster_scan, `noise` inside it), host ms of one scan
as the program runs it, mean over the traced scans."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, "fusion")
