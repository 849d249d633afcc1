"""Profiling and op accounting (port of vtkcloudpoint_tpu.utils.profiling).

- Stopwatch: wall-clock seconds of a block, ending in a synchronise with
  the card when the value it is told to wait for holds a CUDA tensor
  (FrmMain.cs:1342-1344);
- dbscan_distance_evals / nn_distance_evals: the shape-derived
  distance-evaluation counts of the dense kernels (the reference's
  iritatorNum counter, DBImproved.cs:12,19);
- device_trace: a torch.profiler scope writing a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


def _has_cuda_tensor(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    if isinstance(tree, dict):
        return any(_has_cuda_tensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_cuda_tensor(v) for v in tree)
    return False


class Stopwatch:
    """with Stopwatch() as sw: ...; sw.elapsed (seconds, device-synced)."""

    def __init__(self, sync_on=None):
        self._sync_on = sync_on
        self.elapsed = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if _has_cuda_tensor(self._sync_on):
            torch.cuda.synchronize()
        self.elapsed = time.perf_counter() - self._t0
        return False

    def sync(self, value):
        self._sync_on = value
        return value


def dbscan_distance_evals(n_blocks: int, capacity: int, iters: int = 1) -> int:
    """Distance evaluations of the dense blocked DBSCAN: every block computes
    its full [cap, cap] metric once (adjacency), label propagation reuses it.
    The reference's counter (iritatorNum) counts the same quantity for its
    O(n^2) isKeyPoint scans."""
    return n_blocks * capacity * capacity * iters


def nn_distance_evals(n_query: int, n_ref: int, iterations: int = 1) -> int:
    """ICP correspondence distance evals: full bipartite per iteration
    (ICP.cs:224-250 brute force does exactly this)."""
    return n_query * n_ref * iterations


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler scope over the CPU and, where there is one, the card;
    writes ``trace.json`` (Chrome trace format) into ``logdir`` and yields
    the profiler (``key_averages()`` for tables)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
