"""Spatial block partitioning for block-parallel DBSCAN (port of
vtkcloudpoint_tpu.cluster.blocks).

- ``assign_blocks_reference``: the deterministic clean-grid version of the
  reference partitioner (FrmMain.cs:1214-1291; PARITY N1, N2, Q15).
- ``assign_blocks_balanced`` / ``partition_gather_sorted``: Morton-order
  equal-count blocks.

The Morton code is carried in int64 (torch's uint32 lacks shifts and sorts
on many ops); the invalid sentinel 0xFFFFFFFF still sorts after every valid
code. JAX's two-key (code, index) sort is a stable sort on the code.
"""
from __future__ import annotations

import torch

BIG = 1e30
SENTINEL = 0xFFFFFFFF


def _extents(motor, valid):
    x = motor[:, 0]
    y = motor[:, 1]
    big = torch.full_like(x, BIG)
    xmin = torch.where(valid, x, big).min()
    ymin = torch.where(valid, y, big).min()
    xmax = torch.where(valid, x, -big).max()
    ymax = torch.where(valid, y, -big).max()
    return xmin, ymin, xmax, ymax


def _morton_key(qx, qy):
    """Interleave two 16-bit ints into a 32-bit Morton code (int64)."""

    def spread(v):
        v = v.to(torch.int64)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    return spread(qx) | (spread(qy) << 1)


def _morton_codes(motor, valid):
    x = motor[:, 0]
    y = motor[:, 1]
    xmin, ymin, xmax, ymax = _extents(motor, valid)
    sx = torch.clamp((x - xmin) / torch.clamp_min(xmax - xmin, 1e-30),
                     0.0, 1.0)
    sy = torch.clamp((y - ymin) / torch.clamp_min(ymax - ymin, 1e-30),
                     0.0, 1.0)
    # clamp to 65534 so no valid code collides with the invalid sentinel
    qx = torch.clamp_max((sx * 65535.0).to(torch.int32), 65534)
    qy = torch.clamp_max((sy * 65535.0).to(torch.int32), 65534)
    code = _morton_key(qx, qy)
    return torch.where(valid, code, torch.full_like(code, SENTINEL))


def _fit(a, total: int, fill):
    n = a.shape[0]
    if n >= total:
        return a[:total]
    pad = torch.full((total - n,) + a.shape[1:], fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad])


def partition_gather_sorted(motor, valid, capacity: int, max_blocks: int,
                            coords=None):
    """assign_blocks_balanced + gather_blocks_ordered in one stable sort.

    ``coords`` (default: motor) is the [N, D] payload to block. Returns
    (block_coords [B, cap, D], block_valid [B, cap], point_index [B, cap]
    i32 with -1 padding, overflow i32[1]).
    """
    if coords is None:
        coords = motor
    d = coords.shape[1]
    _, order = torch.sort(_morton_codes(motor, valid), stable=True)
    total = max_blocks * capacity
    n_valid = valid.sum(dtype=torch.int32)
    slot_valid = (torch.arange(total, device=motor.device)
                  < torch.clamp_max(n_valid, total))
    pidx = torch.where(slot_valid, _fit(order.to(torch.int32), total, 0),
                       -1).reshape(max_blocks, capacity)
    block_coords = torch.where(slot_valid[:, None],
                               _fit(coords[order], total, 0.0),
                               0.0).reshape(max_blocks, capacity, d)
    overflow = torch.clamp_min(n_valid - total, 0).reshape(1)
    return block_coords, pidx >= 0, pidx, overflow


