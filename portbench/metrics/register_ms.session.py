"""The three registrations (engine.py register_to_truth: coarse ICP,
multi-start, RANSAC), host wall ms of one session ending in a
synchronise."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("register", "register_multistart", "register_ransac")]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
