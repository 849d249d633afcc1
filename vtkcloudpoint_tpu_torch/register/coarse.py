"""Coarse alignment: extent auto-rescale and the region-box workflow (port
of vtkcloudpoint_tpu.register.coarse).

- auto_rescale_centers: per-axis scale = truth extent / centroid extent,
  tmp = coord * scale, no offset (FrmMain.cs:3040-3056);
- rescale_region_truth: the in-region truth subset stretched onto the full
  truth extent (SureRegionBtn_Click, FrmMain.cs:3496-3516);
- points_in_box: (min, max] on both axes (getListByScale, Tools.cs:507-509).
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils import profiling as prof

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


def rescale_region_truth(truth_xy, region_mask, true_bounds):
    """Stretch the selected truth subset onto the full truth extent
    ``true_bounds`` (xmin, xmax, ymin, ymax). Returns tmp coords [N, 2],
    meaningful where region_mask."""
    x0, x1 = _extent(truth_xy[:, 0], region_mask)
    y0, y1 = _extent(truth_xy[:, 1], region_mask)
    sx = (true_bounds[1] - true_bounds[0]) / (x1 - x0)
    sy = (true_bounds[3] - true_bounds[2]) / (y1 - y0)
    tmp_x = true_bounds[0] + (truth_xy[:, 0] - x0) * sx
    tmp_y = true_bounds[2] + (truth_xy[:, 1] - y0) * sy
    return torch.stack([tmp_x, tmp_y], dim=-1)


@dataclasses.dataclass
class RegionBox:
    """Movable, zoomable selection box (the arrow-key region of
    ProcessCmdKey, FrmMain.cs:3194-3396, as a value type)."""

    min_x: float
    min_y: float
    max_x: float
    max_y: float

    def translate(self, dx: float, dy: float) -> "RegionBox":
        return RegionBox(self.min_x + dx, self.min_y + dy,
                         self.max_x + dx, self.max_y + dy)

    def zoom(self, factor: float) -> "RegionBox":
        cx = (self.min_x + self.max_x) / 2
        cy = (self.min_y + self.max_y) / 2
        hx = (self.max_x - self.min_x) / 2 * factor
        hy = (self.max_y - self.min_y) / 2 * factor
        return RegionBox(cx - hx, cy - hy, cx + hx, cy + hy)


def points_in_box(xy, box: RegionBox):
    """Selection mask, (min, max] on both axes."""
    return ((xy[:, 0] > box.min_x) & (xy[:, 1] > box.min_y)
            & (xy[:, 0] <= box.max_x) & (xy[:, 1] <= box.max_y))


def translate_points(xy, dx: float, dy: float):
    """Keyboard point-set move (ProcessCmdKey translate branch)."""
    return xy + prof.sync(torch.tensor, [dx, dy], dtype=xy.dtype,
                          device=xy.device)


def zoom_points(xy, factor: float):
    """Keyboard point-set zoom about the origin (+/- keys)."""
    return xy * factor
