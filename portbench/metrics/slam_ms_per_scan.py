"""The window over the scans of the SLAM jobs completed in it, ms a
scan."""


def read(ctx):
    if ctx.window is None:
        return None
    n = sum(u.get("scans", 0) for u in ctx.units)
    return ctx.window.window_s * 1e3 / n if n else None
