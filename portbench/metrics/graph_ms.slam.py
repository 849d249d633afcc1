"""Pose graph, observations and bundle adjustment (slam/ba.py,
slam/posegraph.py), wall ms of one job from the program's own stage
hook."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("posegraph", "observations", "ba")]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
