"""The program's own spans and counters (vtkcloudpoint_tpu_torch.utils.
profiling), as the traced pass recorded them.

The program records while a torch profiler is active, and only the traced
pass runs under one, so the spans that started inside the traced window
are that pass's. Each reader sums them over the pass and divides by the
traced jobs; a program without the recorder, or a pass that recorded
none of the spans named, gives None.
"""
from __future__ import annotations


def traced_spans(ctx):
    """The spans of the traced pass, or None."""
    if ctx.trace is None or not ctx.traced_jobs:
        return None
    try:
        from vtkcloudpoint_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    lo = ctx.trace.enter_ns
    spans = [s for s in read() if s.start_ns >= lo and s.end_ns is not None]
    return spans or None


def subtree(spans, names):
    """The spans named ``names`` and every span they opened, in order."""
    ids, out = set(), []
    for s in spans:
        if s.name in names or s.parent in ids:
            ids.add(s.id)
            out.append(s)
    return out


def span_ms(ctx, *names):
    """The summed ms of the spans named, a traced job."""
    spans = traced_spans(ctx)
    sel = [s for s in spans or () if s.name in names]
    if not sel:
        return None
    return sum(s.end_ns - s.start_ns for s in sel) * 1e-6 / ctx.traced_jobs


def counter(ctx, name, under=None):
    """The counter ``name`` summed over every span, or over the spans named
    ``under`` and those they opened, a traced job."""
    spans = traced_spans(ctx)
    if spans is None:
        return None
    if under is not None:
        spans = subtree(spans, under)
        if not spans:
            return None
    return sum(s.counters.get(name, 0) for s in spans) / ctx.traced_jobs
