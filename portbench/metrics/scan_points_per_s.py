"""Points of every scan completed in the window over the window's
seconds."""


def read(ctx):
    if ctx.window is None:
        return None
    points = sum(u.get("points", 0) for u in ctx.units)
    return points / ctx.window.window_s if points else None
