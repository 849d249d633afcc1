"""Scan ingestion: folder -> PointBatch with gating, conversion and dedup
(port of vtkcloudpoint_tpu.io.ingest).

The AddFolder import path (FrmMain.cs:916-1134, typpe 1/2): parse files with
the port's loaders, then, on the device in the batch dtype: range-gate
(Distance == 0 or > 1000 dropped), convert motor angles to XYZ, remove exact
duplicates (``dedup_rows``: numpy's ``np.unique(axis=0)`` semantics, with
``loaders.dedup_exact`` as its oracle; first-occurrence order) and pad to a
multiple of 1024. The batch stays on the device from upload to PointBatch.
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
from .loaders import load_folder


def _round_capacity(n: int) -> int:
    """The next multiple of 1024, at least 1024."""
    return max(((n + 1023) // 1024) * 1024, 1024)


def _row_keys(xyz: torch.Tensor) -> list:
    """int64 keys, equal for two rows exactly when the rows' bits are equal
    (after -0.0 -> +0.0). float32 packs two columns in a key."""
    x = (xyz + 0.0).contiguous()          # -0.0 + 0.0 is +0.0
    if x.element_size() == 8:
        return list(x.view(torch.int64).unbind(1))
    b = x.view(torch.int32).to(torch.int64).unbind(1)
    # b_hi * 2**32 + (b_lo mod 2**32): in int64 range, no overflow
    return [b[i] * 4294967296 + (b[i + 1] & 0xFFFFFFFF)
            if i + 1 < len(b) else b[i] for i in range(0, len(b), 2)]


def dedup_rows(xyz: torch.Tensor):
    """Exact-duplicate rows of ``xyz`` [N, D] on its device, as
    ``loaders.dedup_exact`` finds them: -0.0 equals 0.0, and a row holding a
    NaN is never a duplicate.

    Returns (first bool[N]: the row is the first occurrence of its value,
    mult int32[N]: at a first occurrence its number of copies, 1 elsewhere).
    ``xyz[first]`` lists the unique rows in first-occurrence order, with
    ``mult[first]`` their multiplicities: ``dedup_exact``'s (index, count).
    No value is read back to the host."""
    n = xyz.shape[0]
    keys = _row_keys(xyz)
    # stable sorts from the last key to the first: equal rows end adjacent,
    # in their original order
    perm = torch.arange(n, device=xyz.device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    nan = torch.isnan(xyz).any(dim=1)[perm]
    differ = nan[1:] | nan[:-1]
    for k in keys:
        ks = k[perm]
        differ |= ks[1:] != ks[:-1]
    start = torch.ones(n, dtype=torch.bool, device=xyz.device)
    start[1:] = differ
    run = torch.cumsum(start, 0) - 1
    counts = torch.zeros(n, dtype=torch.int32, device=xyz.device)
    counts.scatter_add_(0, run, torch.ones_like(counts))
    first = torch.empty_like(start).scatter_(0, perm, start)
    mult = torch.ones_like(counts).scatter_(
        0, perm, torch.where(start, counts[run], 1))
    return first, mult


def import_scan_arrays(motor, rng, cfg: ImportConfig = ImportConfig(),
                       capacity: Optional[int] = None,
                       device=DEFAULT_DEVICE,
                       dtype=torch.float32, path_id=None) -> PointBatch:
    """PointBatch on ``device`` (default the card) from raw (motor [N, 2],
    distance [N]).

    The range gate, the conversion and the dedup (``dedup_rows``, which
    ``loaders.dedup_exact`` is the oracle of) run on the device; the one
    read of the device is the pair (rows the gate keeps, unique rows), which
    sizes the capacity (the next multiple of 1024 when ``capacity`` is None)
    and is recorded as the counters ``rows``, ``kept`` and ``unique``.
    ``path_id`` (each point's source-file index) follows the points through
    the range gate and the dedup, which keeps the first occurrence's file."""
    device = resolve_device(device)
    motor_t = prof.sync(torch.as_tensor(_host(motor)).to, device=device,
                        dtype=dtype)
    rng_t = prof.sync(torch.as_tensor(_host(rng)).to, device=device,
                      dtype=dtype)
    pid = (None if path_id is None else
           prof.sync(torch.as_tensor(np.asarray(path_id, np.int32)).to,
                     device))
    keep = range_gate(rng_t, cfg)
    xyz = motor_to_xyz(motor_t, rng_t, cfg)
    if cfg.dedup:
        # a gated row reads as NaN: a run of its own, never merged
        first, mult = dedup_rows(torch.where(keep[:, None], xyz, torch.nan))
        first &= keep
    else:
        first, mult = keep, torch.ones_like(rng_t, dtype=torch.int32)
    kept, unique = prof.sync(
        lambda: torch.stack([keep.sum(), first.sum()]).tolist())
    prof.count("rows", rng_t.shape[0])
    prof.count("kept", kept)
    prof.count("unique", unique)
    cap = capacity or _round_capacity(unique)
    if cap < unique:
        raise ValueError(f"capacity {cap} < point count {unique}")
    # a row's slot in the batch; every dropped row lands in slot cap, cut off
    slot = torch.where(first, torch.cumsum(first, 0) - 1, cap)

    def place(src, fill):
        out = torch.full((cap + 1,) + src.shape[1:], fill, dtype=src.dtype,
                         device=device)
        return out.index_put_((slot,), src)[:cap]

    def zeros():
        return torch.zeros(cap, dtype=torch.int32, device=device)

    return PointBatch(
        xyz=place(xyz, 0.0), motor=place(motor_t, 0.0),
        rng=place(rng_t, 0.0), label=zeros(), mult=place(mult, 1),
        valid=torch.arange(cap, device=device) < unique,
        path_id=zeros() if pid is None else place(pid, 0))


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
