"""Host-clock timing: the measured window and the step timer.

``StepTimer`` is copied from the repository's chip smoke script: host wall
ending in a synchronise, and the CUDA events' span on the stream.
"""
from __future__ import annotations

import contextlib
import time


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of ``values``, linear between the two
    nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def median(values) -> float:
    return percentile(values, 50.0)


class Window:
    """Whole jobs back to back (a closed loop with one client).

    The window opens when the first timed job is called and closes at the
    end of the first job that completes ``seconds`` or more after it
    opened. Each job's latency runs from its call to its synchronised
    result. ``run(call)`` calls ``call(i)`` for i = 0, 1, ...: it returns
    the job's output, or raises; either way the job counts as attempted.
    Time spent in ``record`` between jobs is inside the window.
    """

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = float(seconds)
        self.clock = clock
        self.latencies = []        # seconds, one a job
        self.start = self.end = None

    def run(self, call, record):
        """Run jobs until the window closes; after each job, outside its
        latency, ``record(i, output, error)`` (output None and error the
        exception's text where the job raised)."""
        self.start = self.clock()
        i = 0
        while True:
            t0 = self.clock()
            try:
                out, err = call(i), None
            except Exception as exc:          # a job that raises has failed
                out, err = None, f"{type(exc).__name__}: {exc}"
            t1 = self.clock()
            self.latencies.append(t1 - t0)
            record(i, out, err)
            i += 1
            if t1 - self.start >= self.seconds:
                self.end = t1
                return self

    @property
    def window_s(self) -> float:
        return self.end - self.start

    @property
    def attempted(self) -> int:
        return len(self.latencies)


class StepTimer:
    """Per-step host wall ms (ending in a synchronise) and CUDA-event ms
    (the stream's span between two events) of the steps run under it. A
    step run several times keeps every reading, in order."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.wall, self.device = {}, {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        if not self.cuda:
            t0 = time.perf_counter()
            yield
            self.wall.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        yield
        end.record()
        end.synchronize()
        self.wall.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)
        self.device.setdefault(name, []).append(start.elapsed_time(end))
