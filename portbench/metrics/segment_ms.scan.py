"""Statistics and payload tables (ops/segment.py: cluster_stats,
bucket_payload_by_cluster), host wall ms of one scan ending in a
synchronise; median over the traced scans."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("stats", "bucket")]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
