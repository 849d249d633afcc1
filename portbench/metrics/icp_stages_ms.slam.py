"""Odometry plus loop closures (slam/trajectory.py through
register/icp.py), wall ms of one job from the program's own stage hook."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("odometry", "closures")]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
