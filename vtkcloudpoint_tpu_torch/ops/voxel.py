"""Voxel-grid downsampling, fixed capacity and masked (port of
vtkcloudpoint_tpu.ops.voxel).

Map maintenance for scan-to-map ICP (slam/scan2map.py): points collapse to
per-voxel means in a fixed-size hash table; colliding voxels merge, as in
the JAX package. Arithmetic follows its compiled program:

- the division by the static voxel size is a multiplication by its
  reciprocal in the points' precision (``cluster.grid.reciprocal``);
- the voxel hash wraps in int32: torch computes it in int64 and wraps each
  product (``grid.wrap32``); ``abs`` is taken on the wrapped int32 value,
  so abs(INT32_MIN) stays negative before the floor-mod, as in jnp;
- the per-voxel sums are exact and round once (``ops.segment.segment_sum``,
  int64 fixed point), so a run on the card repeats bit for bit.
"""
from __future__ import annotations

import torch

from ..cluster.grid import reciprocal, wrap32
from .segment import segment_sum

_HASH = (73856093, 19349663, 83492791)


def voxel_slots(xyz, valid, voxel_size: float, table_size: int):
    """Hash-table slot of each point's voxel, i64[N]; invalid points get
    ``table_size`` (dropped)."""
    q = torch.floor(xyz * reciprocal(voxel_size, xyz.dtype)).to(
        torch.int32).long()
    h = wrap32(q[:, 0] * _HASH[0])
    for k in (1, 2):
        h = h ^ wrap32(q[:, k] * _HASH[k])
    slot = wrap32(h.abs()) % table_size
    return torch.where(valid, slot, table_size)


def voxel_downsample(xyz, valid, voxel_size: float, table_size: int = 16384):
    """Collapse points to per-voxel centroids.

    Returns (points f[table_size, 3], mask bool[table_size], n_voxels i32).
    Output slot order is hash order (deterministic for fixed inputs).
    """
    v = valid.to(xyz.dtype)
    slot = voxel_slots(xyz, valid, voxel_size, table_size)
    sums = segment_sum(torch.cat([xyz * v[:, None], v[:, None]], dim=1),
                       slot, table_size)
    cnt = sums[:, 3]
    mask = cnt > 0
    pts = sums[:, :3] / torch.clamp_min(cnt, 1.0)[:, None]
    return (torch.where(mask[:, None], pts, 0.0), mask,
            mask.sum(dtype=torch.int32))
