"""Spans and counters of the port, and the operator's trace exporter.

A span records a stage of the program as it runs: its name, its start and
end on ``time.time_ns()`` (the clock of the profiler's events, so a span
lays over a device trace), its own id, the id of the span that opened it
and the id of its root span (the request: one ``cluster_scan``, one SLAM
job, one Engine call), and its counters, a ``{name: int}`` that ``count``
adds to while the span is the innermost open one.

Recording is on while a torch profiler is active and inside
``recording()``. Otherwise ``span`` returns one shared null context,
``count`` returns at once and ``sync`` calls its function: one check a
site. Spans stay in memory (``records()``, in the order they opened) until
``clear()``; reading them clears nothing.

- span(name): ``with span("fusion"): ...``;
- spanned: a decorator giving a function one span of its own name;
- count(name, n): adds n to the innermost open span's counter (a count
  made with no span open is not kept);
- sync(fn, *args): every read of a device value on the host (``bool``,
  ``int``, ``.item()``, ``.tolist()``, ``.cpu()``, a boolean-mask index,
  a copy from the host, a ``torch.linalg`` error check) goes through it:
  it adds 1 to ``host_syncs`` of the innermost open span, then runs
  ``fn(*args)`` inside a span ``sync``, and returns what ``fn`` returns;
- recording(): a context that turns recording on and yields a
  ``Recording`` of the spans opened inside it;
- device_trace(logdir): a torch.profiler scope writing ``trace.json``
  (Chrome trace format) and ``spans.json`` (the spans recorded in it).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time

import torch
from torch._C._autograd import _profiler_enabled


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns",
                 "counters")

    def __init__(self, name, sid, parent, root):
        self.name, self.id, self.parent, self.root = name, sid, parent, root
        self.start_ns = self.end_ns = None
        self.counters = {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


_SPANS = []                  # every span recorded, in the order opened
_ids = itertools.count(1)
_local = threading.local()   # each thread's stack of open spans
_forced = 0                  # depth of open recording() blocks
_NULL = contextlib.nullcontext()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """The context of one recorded span."""

    __slots__ = ("span", "stack")

    def __init__(self, name):
        self.span = Span(name, next(_ids), None, None)

    def __enter__(self):
        sp, stack = self.span, _stack()
        if stack:
            sp.parent, sp.root = stack[-1].id, stack[-1].root
        else:
            sp.root = sp.id
        self.stack = stack
        _SPANS.append(sp)
        stack.append(sp)
        sp.start_ns = time.time_ns()
        return sp

    def __exit__(self, *exc):
        sp = self.span
        sp.end_ns = time.time_ns()
        stack = self.stack
        while stack and stack.pop() is not sp:
            pass
        return False


def on() -> bool:
    """Whether spans and counts record now."""
    return bool(_forced or _profiler_enabled())


def span(name: str):
    """A context recording a span ``name`` (the shared null context while
    recording is off)."""
    if not (_forced or _profiler_enabled()):
        return _NULL
    return _Open(name)


def spanned(fn):
    """``fn`` with one span, named by its function name, around each
    call."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if not (_forced or _profiler_enabled()):
            return fn(*args, **kw)
        with _Open(name):
            return fn(*args, **kw)

    return wrapper


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost open span."""
    if not (_forced or _profiler_enabled()):
        return
    stack = _stack()
    if stack:
        c = stack[-1].counters
        c[name] = c.get(name, 0) + n


def sync(fn, *args, **kw):
    """``fn(*args, **kw)``, a point where the host waits on the card: one
    ``host_syncs`` of the innermost open span, and a span ``sync`` around
    the call. The value and its type are ``fn``'s own."""
    if not (_forced or _profiler_enabled()):
        return fn(*args, **kw)
    count("host_syncs")
    with _Open("sync"):
        return fn(*args, **kw)


def records() -> list:
    """Every span recorded in this process, in the order they opened
    (the list itself: read it, do not change it)."""
    return _SPANS


def clear() -> None:
    """Forget every recorded span."""
    _SPANS.clear()


class Recording:
    """The spans opened inside one ``recording()`` block."""

    def __init__(self):
        self.first, self.last = len(_SPANS), None

    @property
    def spans(self) -> list:
        return _SPANS[self.first:self.last]


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the block (with or without a
    profiler); yields its ``Recording``."""
    global _forced
    rec = Recording()
    _forced += 1
    try:
        yield rec
    finally:
        _forced -= 1
        rec.last = len(_SPANS)


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler scope over the CPU and, where there is one, the card;
    writes ``trace.json`` (Chrome trace format) and ``spans.json`` (the
    spans recorded inside the scope, on the trace's clock) into ``logdir``
    and yields the profiler (``key_averages()`` for tables)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = len(_SPANS)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump([s.as_dict() for s in _SPANS[first:]], f)
