"""Scan-to-map ICP: register each scan against the accumulated world map
(port of vtkcloudpoint_tpu.slam.scan2map).

Instead of chaining scan-to-scan transforms (whose error compounds), each
new scan registers against a bounded voxel map of everything seen so far,
kept in a fixed-capacity hash table (ops/voxel.py). The JAX ``lax.scan``
over scans is a Python loop; the map stays on the scans' device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import ICPConfig
from ..ops import se3
from ..ops.voxel import voxel_downsample
from ..register.icp import icp
from ..register.nn_grid import icp_grid
from .trajectory import Trajectory

# above this many map slots nn="auto" takes the grid locator: the JAX
# package's rule off a TPU (scan2map.py:54-61), on every device here
GRID_ABOVE = 8192


class MapState(NamedTuple):
    points: torch.Tensor   # [M, 3] voxel map in world frame
    mask: torch.Tensor     # [M]


def scan_to_map(scans, scan_valid, cfg: ICPConfig = ICPConfig(),
                voxel_size: float = 0.2, map_capacity: int = 16384,
                nn: str = "auto", grid_cell_size: float = None,
                grid_cell_cap: int = 32, grid_fallback_cap: int = 2048,
                backend: str = "auto"):
    """Sequentially register scans against the accumulated voxel map.

    scans: [S, N, 3] in their own frames. Returns (Trajectory, final
    MapState, per-scan errors [S-1]). Pose of scan 0 is identity; its
    points seed the map.

    nn="grid" (taken by "auto" above GRID_ABOVE map slots) swaps the
    brute-force correspondence for the grid-hash locator
    (register.nn_grid.icp_grid): the map grid rebuilds each step, every
    query resolves exactly or falls back to brute force (K3 on the card) up
    to grid_fallback_cap. Default cell size: 4 * voxel_size.
    """
    s = scans.shape[0]
    dtype, dev = scans.dtype, scans.device
    if nn == "auto":
        nn = "grid" if map_capacity > GRID_ABOVE else "brute"
    if nn not in ("grid", "brute"):
        raise ValueError(f"nn must be 'auto', 'grid' or 'brute', got {nn!r}")
    cell = float(grid_cell_size if grid_cell_size is not None
                 else 4.0 * voxel_size)

    map_pts, map_mask, _ = voxel_downsample(scans[0], scan_valid[0],
                                            voxel_size, map_capacity)
    r_prev = torch.eye(3, dtype=dtype, device=dev)
    t_prev = torch.zeros(3, dtype=dtype, device=dev)
    rs, ts, errs = [r_prev], [t_prev], []
    for k in range(1, s):
        scan, sv = scans[k], scan_valid[k]
        # init from the previous pose (smooth trajectories)
        if nn == "grid":
            res, _ = icp_grid(scan, sv, map_pts, map_mask, cfg,
                              cell_size=cell, cell_cap=grid_cell_cap,
                              fallback_cap=grid_fallback_cap, r0=r_prev,
                              t0=t_prev, backend=backend)
        else:
            res = icp(scan, sv, map_pts, map_mask, cfg, r0=r_prev, t0=t_prev,
                      backend=backend)
        world = se3.apply_rigid(res.r, res.t, scan)
        # merge into the map: re-voxelise map + new points together
        map_pts, map_mask, _ = voxel_downsample(
            torch.cat([map_pts, world]), torch.cat([map_mask, sv]),
            voxel_size, map_capacity)
        r_prev, t_prev = res.r, res.t
        rs.append(res.r)
        ts.append(res.t)
        errs.append(res.error)
    err = torch.stack(errs) if errs else scans.new_zeros((0,))
    return (Trajectory(torch.stack(rs), torch.stack(ts)),
            MapState(map_pts, map_mask), err)
