"""Statistics and payload tables (the spans `stats` and `bucket` of
cluster/pipeline.py: cluster_scan), host ms of one scan as the program runs
it, mean over the traced scans."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, "stats", "bucket")
