"""Import (io/ingest.py, data/: range gate, conversion, dedup, padding),
host wall ms of one session ending in a synchronise."""
from portbench.lib.timing import median


def read(ctx):
    runs = [ctx.spans.get(s) for s in ("import",)]
    if not all(runs):
        return None
    return median([sum(v) for v in zip(*runs)])
