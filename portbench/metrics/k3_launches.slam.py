"""K3 launches of one SLAM job (the program's counter
kernels/neighbor.launches, one a wrapper call)."""


def read(ctx):
    n = ctx.counters.get("k3_launches")
    return float(n) if n else None
