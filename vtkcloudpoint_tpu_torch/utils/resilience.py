"""Failure detection / retry / heartbeat for long and multi-host runs.

The reference has NO failure handling (SURVEY.md §5: MessageBox + swallow,
poll-barrier with no timeout). Long tier-4/5 jobs need three primitives:

- retry(): transient-failure retry with exponential backoff (device tunnel
  hiccups, preempted hosts re-joining, flaky filesystem);
- Heartbeat: a timestamp file the job touches at every unit of progress, so
  an external watchdog (or the next run) can tell "slow" from "dead";
- check_heartbeat(): staleness test against a timeout.

slam.trajectory.slam_pipeline_checkpointed touches a heartbeat per
checkpointed chunk; combined with its npz resume, kill -> restart -> resume
is the elastic-recovery story (tested in tests/test_slam.py kill-resume).
"""
from __future__ import annotations

import functools
import os
import time


def retry(attempts: int = 3, backoff: float = 1.0, factor: float = 2.0,
          exceptions=(Exception,), on_retry=None):
    """Decorator: retry up to ``attempts`` times with exponential backoff.

    on_retry(exc, attempt) is called before each sleep (logging hook)."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            delay = backoff
            for attempt in range(attempts):
                try:
                    return fn(*args, **kw)
                except exceptions as exc:
                    if attempt == attempts - 1:
                        raise
                    if on_retry is not None:
                        on_retry(exc, attempt)
                    time.sleep(delay)
                    delay *= factor
            raise AssertionError("unreachable")

        return run

    return wrap


class Heartbeat:
    """Progress liveness file: beat() rewrites mtime + a monotone counter."""

    def __init__(self, path: str):
        self.path = path
        self.count = 0
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)

    def beat(self, note: str = ""):
        self.count += 1
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{time.time():.3f}\t{self.count}\t{note}\n")
        os.replace(tmp, self.path)
        return self.count


def check_heartbeat(path: str, timeout: float):
    """Returns (alive: bool, age_seconds: float | None). Missing file ->
    (False, None)."""
    try:
        with open(path) as f:
            ts = float(f.read().split("\t", 1)[0])
    except (OSError, ValueError):
        return False, None
    age = time.time() - ts
    return age <= timeout, age
