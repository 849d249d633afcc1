"""Scan ingestion: folder -> PointBatch with gating, conversion and dedup
(port of vtkcloudpoint_tpu.io.ingest).

The AddFolder import path (FrmMain.cs:916-1134, typpe 1/2): parse files with
the port's loaders, range-gate (Distance == 0 or > 1000 dropped) and convert
motor angles to XYZ on the device in the batch dtype, remove exact
duplicates with ``loaders.dedup_exact`` (first-occurrence order),
and pad to a multiple of 1024.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import ImportConfig
from ..data.convert import motor_to_xyz, range_gate
from ..data.pointbatch import PointBatch, _host
from ..device import DEFAULT_DEVICE, resolve_device
from ..utils import profiling as prof
from .loaders import dedup_exact, load_folder


def _round_capacity(n: int) -> int:
    """The next multiple of 1024, at least 1024."""
    return max(((n + 1023) // 1024) * 1024, 1024)


def import_scan_arrays(motor, rng, cfg: ImportConfig = ImportConfig(),
                       capacity: Optional[int] = None,
                       device=DEFAULT_DEVICE,
                       dtype=torch.float32, path_id=None) -> PointBatch:
    """PointBatch on ``device`` (default the card) from raw (motor [N, 2],
    distance [N]).

    ``path_id`` (each point's source-file index) follows the points through
    the range gate and the dedup, which keeps the first occurrence's file."""
    device = resolve_device(device)
    motor_t = prof.sync(torch.as_tensor(_host(motor)).to, device=device,
                        dtype=dtype)
    rng_t = prof.sync(torch.as_tensor(_host(rng)).to, device=device,
                      dtype=dtype)
    keep = range_gate(rng_t, cfg)
    motor_t = prof.sync(lambda: motor_t[keep])
    rng_t = prof.sync(lambda: rng_t[keep])
    pid = (None if path_id is None
           else np.asarray(path_id, np.int32)[_host(keep)])
    xyz = _host(motor_to_xyz(motor_t, rng_t, cfg))
    motor_h, rng_h = _host(motor_t), _host(rng_t)
    mult = np.ones(len(xyz), np.int32)
    if cfg.dedup:
        idx, counts = dedup_exact(xyz)
        xyz, motor_h, rng_h = xyz[idx], motor_h[idx], rng_h[idx]
        if pid is not None:
            pid = pid[idx]
        mult = counts.astype(np.int32)
    return PointBatch.from_arrays(
        xyz, motor=motor_h, rng=rng_h, mult=mult, path_id=pid,
        capacity=capacity or _round_capacity(len(xyz)), device=device,
        dtype=dtype)


def import_scan_folder(folder: str, cfg: ImportConfig = ImportConfig(),
                       pattern: str = "*.txt",
                       capacity: Optional[int] = None,
                       device=DEFAULT_DEVICE,
                       dtype=torch.float32):
    """Folder import (reference typpe 1/2). Returns (PointBatch with
    per-point path_id, names indexed by path_id)."""
    device = resolve_device(device)
    raw, pid, names = load_folder(folder, pattern)
    batch = import_scan_arrays(raw[:, :2], raw[:, 2], cfg, capacity, device,
                               dtype, path_id=pid)
    return batch, names
