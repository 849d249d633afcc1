"""Cluster shape analytics: convex hull, minimal enclosing circle (MEC),
min-area rectangle (port of vtkcloudpoint_tpu.ops.geometry).

Every function here is batched over a leading cluster axis: points
[K, cap, 2] + valid [K, cap]. Arithmetic follows the JAX reference term by
term (pseudo-angle, circumcircle, projections), written as separate
elementwise products and sums so no fused multiply-add changes a decision;
argmins take the first index on ties.

- hull: gift wrap in the reference's pseudo-angle order (Geometry.cs:122-246)
- MEC: brute force over hull pairs, then the C(h, 3) triples in
  ``_triple_table`` order, with containment that skips each candidate's own
  defining points (Q8); a triple wins only on a strictly smaller radius
- rect: per-hull-edge projection sweep (Polygon.cs:360-702)

``cluster_shapes`` sends CUDA tensors to the hand-written kernel
(kernels/shapes.py) and CPU tensors to the plain batched version here.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..device import resolve_backend

BIG = 1e30


def pseudo_angle(x1, y1, x2, y2):
    """Reference AngleValue (Geometry.cs:210-246): monotone angle surrogate
    t*90 in [0, 360); identical points map to 3600 (t = 360/9)."""
    dx = x2 - x1
    dy = y2 - y1
    denom = dx.abs() + dy.abs()
    zero = denom == 0
    t = torch.where(zero, 360.0 / 9.0,
                    dy / torch.where(zero, torch.ones_like(denom), denom))
    t = torch.where(zero, t, torch.where(dx < 0, 2.0 - t,
                                         torch.where(dy < 0, 4.0 + t, t)))
    return t * 90.0


def _take(x, idx):
    """x[k, idx[k, ...]] along the last axis."""
    return torch.gather(x, -1, idx.long())


def convex_hull(pts, valid, max_hull: int = 64):
    """Gift-wrapping hull of padded 2D point blocks [K, cap, 2].

    Returns (hull_pts [K, max_hull, 2], hull_valid [K, max_hull]). Vertex 0
    is the lowest-y (then lowest-x) point; later vertices follow the
    min-pseudo-angle sweep, first index on ties. Truncated at max_hull.
    """
    K, cap, _ = pts.shape
    dev = pts.device
    x = pts[..., 0]
    y = pts[..., 1]
    big = torch.full_like(x, BIG)
    ymin = torch.where(valid, y, big).amin(dim=1, keepdim=True)
    cand = valid & (y == ymin)
    start = torch.argmin(torch.where(cand, x, big), dim=1, keepdim=True)
    xs, ys = _take(x, start), _take(y, start)

    picked = torch.zeros((K, cap), dtype=torch.bool, device=dev)
    picked.scatter_(1, start, True)
    cur = start
    sweep = torch.zeros((K, 1), dtype=pts.dtype, device=dev)
    done = ~valid.any(dim=1, keepdim=True)
    out = torch.full((K, max_hull), -1, dtype=torch.int64, device=dev)
    out[:, :1] = start
    for i in range(max_hull - 1):
        if bool(done.all()):
            break
        cx, cy = _take(x, cur), _take(y, cur)
        ang = pseudo_angle(cx, cy, x, y)
        ok = valid & ~picked & (ang >= sweep)
        best_key = torch.where(ok, ang, big)
        best = torch.argmin(best_key, dim=1, keepdim=True)
        best_angle = _take(best_key, best)
        first_angle = pseudo_angle(cx, cy, xs, ys)
        finish = ((first_angle >= sweep) & (best_angle >= first_angle)) | (
            best_angle >= BIG)
        done = done | finish
        emit = ~done
        cur = torch.where(emit, best, cur)
        sweep = torch.where(emit, best_angle, sweep)
        picked.scatter_(1, best, _take(picked, best) | emit)
        out[:, i + 1:i + 2] = torch.where(emit, best, -1)
    hull_valid = out >= 0
    hull_valid[:, 0] = valid.any(dim=1)
    safe = out.clamp(0, cap - 1)
    hull_pts = torch.stack([_take(x, safe), _take(y, safe)], dim=-1)
    return hull_pts, hull_valid


def _circumcircle(a, b, c):
    """Circumcenter via perpendicular-bisector intersection (Geometry.cs:
    340-432); a degenerate triple gives an inf/nan radius2."""
    x1 = (b[..., 0] + a[..., 0]) / 2
    y1 = (b[..., 1] + a[..., 1]) / 2
    dy1 = b[..., 0] - a[..., 0]
    dx1 = -(b[..., 1] - a[..., 1])
    x2 = (c[..., 0] + b[..., 0]) / 2
    y2 = (c[..., 1] + b[..., 1]) / 2
    dy2 = c[..., 0] - b[..., 0]
    dx2 = -(c[..., 1] - b[..., 1])
    denom = dy1 * dx2 - dx1 * dy2
    t1 = ((x1 - x2) * dy2 + (y2 - y1) * dx2) / denom
    cx = x1 + dx1 * t1
    cy = y1 + dy1 * t1
    ex = cx - a[..., 0]
    ey = cy - a[..., 1]
    return cx, cy, ex * ex + ey * ey


def _triple_table(h: int):
    """All (a, b, c) with a < b < c < h in lexicographic order, int32
    [T, 3] (copied from the JAX package's numpy-only helper). h < 3 gives
    one degenerate self-triple."""
    ib, ic = _np.triu_indices(h, k=1)
    reps = ib.astype(_np.int64)
    total = int(reps.sum())
    if total == 0:
        return _np.zeros((1, 3), _np.int32)
    pair_of = _np.repeat(_np.arange(len(ib)), reps)
    starts = _np.cumsum(reps) - reps
    a = (_np.arange(total) - starts[pair_of]).astype(_np.int64)
    key = (a * h + ib[pair_of]) * h + ic[pair_of]
    order = _np.argsort(key, kind="stable")
    return _np.stack(
        [a[order], ib[pair_of][order], ic[pair_of][order]], axis=-1
    ).astype(_np.int32)


def _encloses(cx, cy, r2, px, py, hull_valid, skip):
    """All valid, non-defining hull points inside the candidate circles.
    cx, cy, r2 [K, C]; px, py, hull_valid [K, h]; skip [C, h] or [K, C, h]."""
    ex = cx[..., None] - px[:, None, :]
    ey = cy[..., None] - py[:, None, :]
    d2 = ex * ex + ey * ey
    inside = (d2 <= r2[..., None]) | ~hull_valid[:, None, :] | skip
    return inside.all(dim=-1)


def min_enclosing_circle(hull_pts, hull_valid, tri_chunk: int = 512):
    """MEC from hull points [K, h, 2]: (cx, cy, radius), each [K]; radius 0
    when no candidate encloses (fewer than 2 valid hull points)."""
    K, h, _ = hull_pts.shape
    dev = hull_pts.device
    big = torch.tensor(BIG, dtype=hull_pts.dtype, device=dev)
    px = torch.where(hull_valid, hull_pts[..., 0], big)
    py = torch.where(hull_valid, hull_pts[..., 1], big)
    ar = torch.arange(h, device=dev)

    # pairs i < j in row-major order
    cx2 = (px[:, :, None] + px[:, None, :]) / 2
    cy2 = (py[:, :, None] + py[:, None, :]) / 2
    ex = cx2 - px[:, :, None]
    ey = cy2 - py[:, :, None]
    r2_2 = (ex * ex + ey * ey).reshape(K, h * h)
    pair_ok = (hull_valid[:, :, None] & hull_valid[:, None, :]
               & (ar[:, None] < ar[None, :])).reshape(K, h * h)
    pair_skip = ((ar[None, None, :] == ar[:, None, None])
                 | (ar[None, None, :] == ar[None, :, None])).reshape(h * h, h)
    cx2 = cx2.reshape(K, h * h)
    cy2 = cy2.reshape(K, h * h)
    pair_enc = _encloses(cx2, cy2, r2_2, px, py, hull_valid, pair_skip)
    pair_r2 = torch.where(pair_enc & pair_ok, r2_2, big)
    i2 = torch.argmin(pair_r2, dim=1, keepdim=True)
    best_pair = _take(pair_r2, i2)

    # triples in lexicographic chunks; a later chunk wins only on strict <
    tri = torch.as_tensor(_triple_table(h), dtype=torch.long, device=dev)
    best_trip = big.expand(K, 1).clone()
    tcx = px[:, :1].clone()
    tcy = py[:, :1].clone()
    for s in range(0, tri.shape[0], max(tri_chunk, 1)):
        t = tri[s:s + tri_chunk]
        ia, ib, ic = t[:, 0], t[:, 1], t[:, 2]
        pts = torch.stack([px, py], dim=-1)
        cx3, cy3, r2_3 = _circumcircle(pts[:, ia], pts[:, ib], pts[:, ic])
        r2_3 = torch.where(torch.isfinite(r2_3), r2_3, big)
        ok = hull_valid[:, ia] & hull_valid[:, ib] & hull_valid[:, ic]
        skip = ((ar[None, :] == ia[:, None]) | (ar[None, :] == ib[:, None])
                | (ar[None, :] == ic[:, None]))
        enc = _encloses(cx3, cy3, r2_3, px, py, hull_valid, skip)
        r2m = torch.where(enc & ok, r2_3, big)
        b = torch.argmin(r2m, dim=1, keepdim=True)
        rb = _take(r2m, b)
        better = rb < best_trip
        best_trip = torch.where(better, rb, best_trip)
        tcx = torch.where(better, _take(cx3, b), tcx)
        tcy = torch.where(better, _take(cy3, b), tcy)

    use_trip = best_trip < best_pair
    best_r2 = torch.where(use_trip, best_trip, best_pair)
    bcx = torch.where(use_trip, tcx, _take(cx2, i2))
    bcy = torch.where(use_trip, tcy, _take(cy2, i2))
    none_found = best_r2 >= BIG
    radius = torch.where(none_found, 0.0,
                         torch.sqrt(torch.clamp_min(best_r2, 0.0)))
    bcx = torch.where(none_found, hull_pts[:, :1, 0], bcx)
    bcy = torch.where(none_found, hull_pts[:, :1, 1], bcy)
    return bcx[:, 0], bcy[:, 0], radius[:, 0]


def min_area_rect(hull_pts, hull_valid):
    """Smallest enclosing rectangle from hull points [K, h, 2]: (long side,
    short side, area), each [K]; zeros when no hull edge has length."""
    K, h, _ = hull_pts.shape
    dev = hull_pts.device
    ar = torch.arange(h, device=dev)[None, :]
    last = torch.clamp_min(hull_valid.sum(dim=1, keepdim=True) - 1, 0)
    nxt = torch.where(ar == last, 0, torch.minimum(ar + 1, last))
    hx = hull_pts[..., 0]
    hy = hull_pts[..., 1]
    ex = _take(hx, nxt) - hx
    ey = _take(hy, nxt) - hy
    elen = torch.sqrt(ex * ex + ey * ey)
    edge_ok = hull_valid & (elen > 0)
    ux = ex / torch.clamp_min(elen, 1e-30)
    uy = ey / torch.clamp_min(elen, 1e-30)
    # pu[k, m, e] = hull point m projected on edge e's direction / normal
    pu = hx[:, :, None] * ux[:, None, :] + hy[:, :, None] * uy[:, None, :]
    pv = hx[:, :, None] * (-uy)[:, None, :] + hy[:, :, None] * ux[:, None, :]
    mask = hull_valid[:, :, None]
    big = torch.full_like(pu, BIG)
    ext_u = (torch.where(mask, pu, -big).amax(dim=1)
             - torch.where(mask, pu, big).amin(dim=1))
    ext_v = (torch.where(mask, pv, -big).amax(dim=1)
             - torch.where(mask, pv, big).amin(dim=1))
    area = torch.where(edge_ok, ext_u * ext_v, BIG)
    best = torch.argmin(area, dim=1, keepdim=True)
    l0 = _take(ext_u, best)[:, 0]
    l1 = _take(ext_v, best)[:, 0]
    a = _take(area, best)[:, 0]
    ok = a < BIG
    return (torch.where(ok, torch.maximum(l0, l1), 0.0),
            torch.where(ok, torch.minimum(l0, l1), 0.0),
            torch.where(ok, a, 0.0))


def shapes_plain(points, valid, max_hull: int = 64, chunk_k: int = 256,
                 tri_chunk: int = 512):
    """Hull + MEC + rect per cluster, ``chunk_k`` clusters at a time:
    (center_x, center_y, radius, len_long, len_short, area), each f32[K],
    before the small-cluster zeroing of ``cluster_shapes``."""
    outs = []
    for s in range(0, points.shape[0], max(chunk_k, 1)):
        hp, hv = convex_hull(points[s:s + chunk_k], valid[s:s + chunk_k],
                             max_hull)
        cx, cy, r = min_enclosing_circle(hp, hv, tri_chunk)
        outs.append((cx, cy, r) + min_area_rect(hp, hv))
    return tuple(torch.cat(col) for col in zip(*outs))


def cluster_shapes(points, valid, counts, max_hull: int = 64,
                   min_points: int = 4, chunk_k: int = 256,
                   hull: str = "wrap", tri_chunk: int = 512,
                   mec: str = "scan", prune_cap: int = 0,
                   backend: str = "auto"):
    """Hull + MEC + min-rect for a batch of padded clusters.

    points [K, cap, 2]; valid [K, cap]; counts [K] true point counts.
    Clusters with count < min_points get zeros (Q9). Only the default
    hull="wrap", mec="scan", prune_cap=0 is ported; the other variants
    raise. Returns dict of [K] f32: center_x, center_y, radius, rect_len0,
    rect_len1, rect_area, aspect (and prune_overflow 0).
    """
    if hull != "wrap" or mec != "scan" or prune_cap:
        raise NotImplementedError(
            "cluster_shapes: only hull='wrap', mec='scan', prune_cap=0 are "
            "ported (ROADMAP queue 1, item 11)")
    if resolve_backend(backend, points.device) == "cuda":
        from ..kernels.shapes import shapes_cuda

        cx, cy, r, l0, l1, area = shapes_cuda(points, valid, max_hull)
    else:
        cx, cy, r, l0, l1, area = shapes_plain(points, valid, max_hull,
                                               chunk_k, tri_chunk)
    skip = counts < min_points
    zero = torch.zeros_like(r)
    return {
        "prune_overflow": torch.zeros((), dtype=torch.int32,
                                      device=points.device),
        "center_x": cx,
        "center_y": cy,
        "radius": torch.where(skip, zero, r),
        "rect_len0": torch.where(skip, zero, l0),
        "rect_len1": torch.where(skip, zero, l1),
        "rect_area": torch.where(skip, zero, area),
        "aspect": torch.where(skip | (l1 <= 0), zero,
                              l0 / torch.clamp_min(l1, 1e-30)),
    }
