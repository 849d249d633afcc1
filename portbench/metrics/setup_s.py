"""Set-up: process start to the window's start (imports, CUDA context,
kernel library, inputs from the seed, warm jobs), host clock."""


def read(ctx):
    return ctx.setup_s
