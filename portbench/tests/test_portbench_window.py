"""The window arithmetic: whole jobs, the p95 over every sample, the rate
over the window, failures counted."""
from types import SimpleNamespace

import pytest

from portbench.lib import harness
from portbench.lib.timing import Window, median, percentile


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def run_window(durations, seconds, fail=()):
    clock = Clock()
    seen = []

    def call(i):
        clock.t += durations[i]
        if i in fail:
            raise RuntimeError("boom")
        return i

    def record(i, out, err):
        seen.append((i, out, err))

    return Window(seconds, clock=clock).run(call, record), seen


def test_window_holds_whole_jobs():
    win, seen = run_window([0.4, 0.4, 0.4, 0.4, 0.4], 1.0)
    # the third job ends at 1.2 s, the first end at or after 1 s
    assert win.attempted == 3 and len(seen) == 3
    assert win.window_s == pytest.approx(1.2)
    assert win.latencies == pytest.approx([0.4, 0.4, 0.4])


def test_a_job_that_raises_is_attempted_and_reported():
    win, seen = run_window([0.5, 0.5, 0.5], 1.0, fail={1})
    assert win.attempted == 2
    assert seen[1][1] is None and "boom" in seen[1][2]


def test_p95_over_every_sample():
    values = list(range(1, 101))
    assert percentile(values, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    assert median([1, 2, 3, 10]) == pytest.approx(2.5)


def reader_value(name, **ctx):
    return harness.reader(name)(SimpleNamespace(**ctx))


def test_rate_over_the_window():
    win, _ = run_window([0.25] * 10, 1.0)
    units = [{"points": 1000, "scans": 1}] * win.attempted
    assert reader_value("scan_points_per_s", window=win,
                        units=units) == pytest.approx(4000.0)
    assert reader_value("scan_ms_p95", window=win,
                        units=units) == pytest.approx(250.0)


def test_session_and_slam_time_per_unit():
    win, _ = run_window([0.5] * 4, 1.0)
    assert reader_value("session_ms", window=win,
                        units=[{"sessions": 1}] * 2) == pytest.approx(500.0)
    assert reader_value("slam_ms_per_scan", window=win,
                        units=[{"scans": 100}] * 2) == pytest.approx(5.0)


def test_failed_jobs_add_no_work():
    win, _ = run_window([0.5] * 4, 1.0)
    assert reader_value("scan_points_per_s", window=win, units=[]) is None


def test_reservoir_is_seeded_and_bounded():
    picks = []
    for _ in range(2):
        r = harness.Reservoir(3, 99)
        for i in range(1000):
            r.offer(i)
        picks.append(list(r.items))
    assert picks[0] == picks[1] and len(picks[0]) == 3
