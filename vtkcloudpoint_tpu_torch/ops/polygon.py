"""Polygon utilities: centroid, area, point-in-polygon, convexity,
triangulation (port of vtkcloudpoint_tpu.ops.polygon; Polygon.cs:24-357,
SURVEY.md C16).

Vertices are [V, 2] with a valid mask (vertices 0..m-1 in order);
vectorised formulas replace the reference's sequential loops. The
ear-clipping triangulation stays host NumPy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def _ring_next(valid):
    """Index of the cyclic next valid vertex (hull-style contiguous mask)."""
    v = valid.shape[0]
    ar = torch.arange(v, device=valid.device)
    last = torch.clamp_min(valid.sum(dtype=torch.int64) - 1, 0)
    return torch.where(ar == last, 0,
                       torch.minimum(torch.arange(1, v + 1,
                                                  device=valid.device), last))


def _cross(verts, nxt):
    x, y = verts[:, 0], verts[:, 1]
    return x, y, x * y[nxt] - x[nxt] * y


def polygon_area(verts, valid):
    """Signed shoelace area (positive CCW). Polygon.cs:113-151 returns the
    magnitude; callers take the absolute value as needed."""
    _, _, cross = _cross(verts, _ring_next(valid))
    return 0.5 * torch.where(valid, cross, 0.0).sum()


def polygon_centroid(verts, valid):
    """Area centroid (Polygon.cs:24-59). Degenerates to the vertex mean for
    near-zero area."""
    nxt = _ring_next(valid)
    x, y, cross = _cross(verts, nxt)
    a = 0.5 * torch.where(valid, cross, 0.0).sum()
    cx = torch.where(valid, (x + x[nxt]) * cross, 0.0).sum() / (6.0 * a)
    cy = torch.where(valid, (y + y[nxt]) * cross, 0.0).sum() / (6.0 * a)
    m = torch.clamp_min(valid.to(x.dtype).sum(), 1.0)
    mean = torch.stack([torch.where(valid, x, 0.0).sum(),
                        torch.where(valid, y, 0.0).sum()]) / m
    return torch.where(a.abs() > 1e-30, torch.stack([cx, cy]), mean)


def point_in_polygon(pts, verts, valid):
    """Ray-cast containment test for [N, 2] points (Polygon.cs:62-86
    crossing-number semantics). Boundary points are implementation-defined,
    like the reference."""
    nxt = _ring_next(valid)
    x1, y1 = verts[:, 0], verts[:, 1]
    x2, y2 = verts[nxt, 0], verts[nxt, 1]
    px = pts[:, 0][:, None]
    py = pts[:, 1][:, None]
    cond = ((y1[None, :] > py) != (y2[None, :] > py)) & valid[None, :]
    dy = (y2 - y1)[None, :]
    xint = x1[None, :] + (py - y1[None, :]) * (x2 - x1)[None, :] / torch.where(
        dy == 0, torch.ones_like(dy), dy)
    crossings = (cond & (px < xint)).sum(dim=1, dtype=torch.int32)
    return (crossings % 2) == 1


def is_convex(verts, valid):
    """All consecutive cross products share a sign (Polygon.cs:155-190)."""
    nxt = _ring_next(valid)
    nxt2 = nxt[nxt]
    e1 = verts[nxt] - verts
    e2 = verts[nxt2] - verts[nxt]
    cross = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    masked = torch.where(valid, cross, 0.0)
    return ~((masked > 1e-30).any() & (masked < -1e-30).any())


def triangulate_earclip(verts: np.ndarray) -> np.ndarray:
    """Ear-clipping triangulation of a simple polygon (host-side NumPy;
    Polygon.cs:246-357). verts: [V,2] in order; returns [V-2, 3] vertex-index
    triangles. Inherently sequential -- run at ingest, not on the card."""
    v = len(verts)
    if v < 3:
        return np.zeros((0, 3), np.int32)
    # ensure CCW
    x, y = verts[:, 0], verts[:, 1]
    area2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
    idx = list(range(v)) if area2 > 0 else list(range(v))[::-1]
    tris = []

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def in_tri(p, a, b, c):
        d1 = cross(a, b, p)
        d2 = cross(b, c, p)
        d3 = cross(c, a, p)
        return (d1 >= 0) and (d2 >= 0) and (d3 >= 0)

    guard = 0
    while len(idx) > 3 and guard < 4 * v:
        guard += 1
        m = len(idx)
        clipped = False
        for k in range(m):
            i0, i1, i2 = idx[(k - 1) % m], idx[k], idx[(k + 1) % m]
            a, b, c = verts[i0], verts[i1], verts[i2]
            if cross(a, b, c) <= 0:
                continue  # reflex
            if any(
                in_tri(verts[j], a, b, c)
                for j in idx
                if j not in (i0, i1, i2)
            ):
                continue
            tris.append((i0, i1, i2))
            idx.pop(k)
            clipped = True
            break
        if not clipped:
            break  # degenerate; emit fan for the rest
    if len(idx) == 3:
        tris.append(tuple(idx))
    elif len(idx) > 3:
        for k in range(1, len(idx) - 1):
            tris.append((idx[0], idx[k], idx[k + 1]))
    return np.array(tris, np.int32)
