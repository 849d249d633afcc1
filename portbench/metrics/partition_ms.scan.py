"""Partition (cluster/blocks.py: partition_gather_sorted), host wall ms
of one scan ending in a synchronise; median over the traced scans."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("partition",)]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
