"""Partition (the span `partition` of cluster/pipeline.py: cluster_scan),
host ms of one scan as the program runs it (no synchronise around it, its
own reads inside), mean over the traced scans."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, "partition")
