"""Reading the profiler's trace: the device's busy time, the time of each
kernel by name, and the idle gaps by what the host was doing.

The arithmetic is that of the repository's profiling tools (wall against
device time, and the idle share): device activities are the kernels, copies
and sets on the card; their union over the traced window is the busy time.
"""
from __future__ import annotations

import bisect
import time

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return f()
    return getattr(ev, f"{what}_us")() * 1000


def _on_device(ev) -> bool:
    """A kernel, copy or set on the card (the profiler's device-side
    activities), told by the event's activity type where the profiler
    gives one and by its device type otherwise."""
    kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") \
        else ""
    if kind:
        return any(k in kind for k in DEVICE_KINDS)
    return "cuda" in str(ev.device_type()).lower()


def events(result):
    """(device [(start_ns, end_ns, name)], host [(start_ns, end_ns, name)])
    of a finished profile's raw results: the device's activities, and the
    host's runtime calls (and operators, where they were recorded)."""
    dev, host = [], []
    for ev in result.events():
        start = _ns(ev, "start")
        item = (start, start + _ns(ev, "duration"), ev.name())
        (dev if _on_device(ev) else host).append(item)
    return dev, host


class _Profiler:
    """The profiler's own start and stop, without the per-event Python
    objects that torch.profiler builds when it stops (a million device
    events a SLAM job would take minutes)."""

    def __init__(self, cuda: bool):
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, _ExperimentalConfig)

        args = (ProfilerState.KINETO, False, False, False, False, False,
                _ExperimentalConfig())
        try:
            self.config = ProfilerConfig(*args, "")
        except TypeError:
            self.config = ProfilerConfig(*args)
        self.activities = {ProfilerActivity.CUDA if cuda
                           else ProfilerActivity.CPU}

    def start(self):
        from torch.autograd import _enable_profiler, _prepare_profiler

        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities)

    def stop(self):
        from torch.autograd import _disable_profiler

        return _disable_profiler()


def union(intervals):
    """Merged, sorted [(start, end)] of the intervals."""
    out = []
    for s, e in sorted((s, e) for s, e, *_ in intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def by_name(intervals):
    """{name: summed seconds} of the intervals."""
    tot = {}
    for s, e, name in intervals:
        tot[name] = tot.get(name, 0.0) + (e - s) * 1e-9
    return tot


def top(totals: dict, k: int = 10):
    """The k largest [name, seconds] pairs."""
    return [[n, v] for n, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:k]]


def _covering(spans, starts, t, depth=8):
    """The name of the innermost span covering time t (the covering span
    that started last, looking back ``depth`` spans: runtime calls nest a
    few deep at most), or None."""
    j = bisect.bisect_right(starts, t)
    for h in range(j - 1, max(j - 1 - depth, -1), -1):
        s, e, n = spans[h]
        if e >= t:
            return n
    return None


def idle_gaps(dev, host, lo, hi, marks=()):
    """{what the host was doing: summed seconds} of the device's idle time
    inside [lo, hi] (ns). Each gap goes to the host's innermost recorded
    call at the gap's middle, or to "host between calls" (Python and the
    framework's dispatch) where none covers it; prefixed with the name of
    the mark (a job's top-level call) that covers it, where marks are
    given."""
    gaps, cur = [], lo
    for s, e in union(dev):
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        gaps.append((cur, hi))
    host = sorted(host)
    starts = [h[0] for h in host]
    marks = sorted(marks)
    mstarts = [m[0] for m in marks]
    out = {}
    for gs, ge in gaps:
        if ge <= gs:
            continue
        mid = (gs + ge) // 2
        name = _covering(host, starts, mid) or "host between calls"
        mark = _covering(marks, mstarts, mid, depth=len(marks))
        if mark:
            name = f"{mark}: {name}"
        out[name] = out.get(name, 0.0) + (ge - gs) * 1e-9
    return out


class Traced:
    """A profiled window: ``with Traced() as tr: ...`` runs the block under
    torch.profiler and then reads ``busy_s``, ``window_s``, ``kernels``
    ({name: seconds}), ``device_ops`` and ``idle_gaps`` (each the ten
    largest [name, seconds]).

    On the card the profiler records the card's activities and the CUDA
    runtime calls only: recording every host operator as well slows a
    host-bound loop by a third or more, which would misstate the idle
    share. ``marks`` collects (name, start_ns, end_ns) of the job's
    top-level calls on the host clock (``mark``), which name the gaps."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.marks = []

    def mark(self, name):
        """``with tr.mark(name): ...`` records a host-clock span."""
        return _Mark(self.marks, name)

    def __enter__(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._prof = _Profiler(self.cuda)
        self._prof.start()
        self.enter_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = self._prof.stop()
        self._prof = None
        if exc[0] is not None:
            return False
        t1 = time.perf_counter()
        dev, host = events(result)
        del result
        self.stop_s, self.read_s = t1 - t0, time.perf_counter() - t1
        every = dev + host
        lo = min(s for s, _, _ in every)
        hi = max(e for _, e, _ in every)
        self.clock_offset_ms = (lo - self.enter_ns) * 1e-6
        self.window_s = (hi - lo) * 1e-9
        self.busy_s = sum(e - s for s, e in union(dev)) * 1e-9
        self.kernels = by_name(dev)
        self.device_ops = top(self.kernels)
        self.idle_gaps = top(idle_gaps(dev, host, lo, hi, self.marks))
        self.n_device_events = len(dev)
        return False


class _Mark:
    def __init__(self, marks, name):
        self.marks, self.name = marks, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.marks.append((self.t0, time.time_ns(), self.name))
        return False
