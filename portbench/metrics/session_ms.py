"""The window over the Engine sessions completed in it, ms."""


def read(ctx):
    if ctx.window is None:
        return None
    n = sum(u.get("sessions", 0) for u in ctx.units)
    return ctx.window.window_s * 1e3 / n if n else None
