"""The three registrations (the spans `register_to_truth` of engine.py:
Engine.register_to_truth: coarse ICP, multi-start, RANSAC), host ms of one
session as the program runs it."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, "register_to_truth")
