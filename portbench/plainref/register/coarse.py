"""Coarse alignment: extent auto-rescale (port of
vtkcloudpoint_tpu.register.coarse).

- auto_rescale_centers: per-axis scale = truth extent / centroid extent,
  tmp = coord * scale, no offset (FrmMain.cs:3040-3056).
"""
from __future__ import annotations

import torch

BIG = 1e30


def _extent(x, valid):
    lo = torch.where(valid, x, BIG).min()
    hi = torch.where(valid, x, -BIG).max()
    return lo, hi


def auto_rescale_centers(centers_xy, centers_valid, truth_xy, truth_valid):
    """Scale centroids so their X/Y extents match the truth extents.
    Returns (tmp_xy [N, 2], scale [2], true_bounds [4] = (xmin, xmax, ymin,
    ymax))."""
    cx0, cx1 = _extent(centers_xy[:, 0], centers_valid)
    cy0, cy1 = _extent(centers_xy[:, 1], centers_valid)
    tx0, tx1 = _extent(truth_xy[:, 0], truth_valid)
    ty0, ty1 = _extent(truth_xy[:, 1], truth_valid)
    sx = (tx1 - tx0) / (cx1 - cx0)
    sy = (ty1 - ty0) / (cy1 - cy0)
    tmp = torch.stack([centers_xy[:, 0] * sx, centers_xy[:, 1] * sy], dim=-1)
    return tmp, torch.stack([sx, sy]), torch.stack([tx0, tx1, ty0, ty1])


