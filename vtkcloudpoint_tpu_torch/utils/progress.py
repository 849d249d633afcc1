"""Host driver-loop progress infrastructure.

The reference runs compute on BackgroundWorkers with a modal progress bar
and a poll-until-drained barrier (C28, FrmMain.cs:68-142, 1320-1399,
WaitingForm.cs). A TPU engine's async analog: XLA dispatch is already
asynchronous, so "progress" is per-stage callbacks around jitted calls plus
wall-clock accounting -- no polling, no fake ticker.

The port's own copy of vtkcloudpoint_tpu/utils/progress.py (numpy and the
stdlib only), so the port never imports the JAX package.
"""
from __future__ import annotations

import sys
import time
from typing import Callable, Optional


class ProgressReporter:
    """Stage-level progress callbacks with timing.

    reporter = ProgressReporter(total_stages=4)
    with reporter.stage("dbscan"):
        out = jitted(...)
    """

    def __init__(self, total_stages: Optional[int] = None,
                 sink: Callable[[str], None] = None):
        self.total = total_stages
        self.done = 0
        self.timings = {}
        self._sink = sink or (lambda s: print(s, file=sys.stderr, flush=True))

    def stage(self, name: str):
        reporter = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                reporter.done += 1
                reporter.timings[name] = dt
                frac = (f"{reporter.done}/{reporter.total}"
                        if reporter.total else str(reporter.done))
                reporter._sink(f"[{frac}] {name}: {dt * 1000:.1f}ms")
                return False

        return _Ctx()

    def summary(self) -> dict:
        return dict(self.timings)
