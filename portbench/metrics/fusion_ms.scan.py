"""Fusion and the noise re-cluster (cluster/fusion.py: merge_blocks),
host wall ms of one scan ending in a synchronise; median over the traced
scans."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("fusion",)]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
