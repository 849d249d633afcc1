"""ICP of the centres onto the truth (register/icp.py: icp), host wall
ms of one scan ending in a synchronise; median over the traced scans."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("icp",)]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
