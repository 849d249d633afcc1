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

Variants of ``cluster_shapes``, plain PyTorch on every device as in the
JAX package: ``hull="quick"`` (batched quickhull, ``convex_hull_quick``),
``mec="eh"`` (Elzinga-Hearn support iteration, ``min_enclosing_circle_eh``:
f32-fragile on near-cocircular hulls) and ``prune_cap`` (exact
Akl-Toussaint candidate pruning, ``hull_prune_pack``). A batch of clusters
runs these loops together; a cluster that has finished keeps its state, as
under JAX's vmap of a while_loop.

``cluster_shapes`` sends CUDA tensors to the hand-written kernel
(kernels/shapes.py) for the default hull="wrap", mec="scan", prune_cap=0,
and everything else to the plain batched versions here.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..device import resolve_backend
from ..utils import profiling as prof

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
        if prof.sync(bool, done.all()):
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


def convex_hull_quick(pts, valid, max_hull: int = 64):
    """Hull vertices of [K, cap, 2] blocks by batched quickhull: each round
    orders the current vertices counter-clockwise (pseudo-angle about
    their centroid) and adds, for every directed edge, the point farthest
    outside it. Same contract as convex_hull, vertex set equal to the true
    hull's (collinear boundary points may be left out); truncated at
    max_hull."""
    K, cap, _ = pts.shape
    h = max_hull
    dev = pts.device
    x, y = pts[..., 0], pts[..., 1]
    any_valid = valid.any(dim=1)
    ar = torch.arange(h, device=dev)

    # two extreme seeds: min-(x, y) and max-(x, y), lexicographic
    xmin = torch.where(valid, x, BIG).amin(dim=1, keepdim=True)
    i_min = torch.argmin(torch.where(valid & (x == xmin), y, BIG), dim=1)
    xmax = torch.where(valid, x, -BIG).amax(dim=1, keepdim=True)
    i_max = torch.argmax(torch.where(valid & (x == xmax), y, -BIG), dim=1)
    idx = torch.full((K, h), -1, dtype=torch.int64, device=dev)
    idx[:, 0] = i_min
    idx[:, 1] = torch.where(i_max != i_min, i_max, -1)

    def order_ccw(idx):
        ok = idx >= 0
        safe = idx.clamp(0, cap - 1)
        vx, vy = _take(x, safe), _take(y, safe)
        nv = ok.sum(dim=1, keepdim=True).clamp_min(1)
        cx = torch.where(ok, vx, 0.0).sum(dim=1, keepdim=True) / nv
        cy = torch.where(ok, vy, 0.0).sum(dim=1, keepdim=True) / nv
        key = torch.where(ok, pseudo_angle(cx, cy, vx, vy), BIG)
        o = torch.sort(key, dim=1, stable=True)[1]
        return torch.where(_take(ok, o), _take(idx, o), -1)

    def round_step(idx):
        idx = order_ccw(idx)
        ok = idx >= 0
        nv = ok.sum(dim=1, keepdim=True)
        safe = idx.clamp(0, cap - 1)
        vx, vy = _take(x, safe), _take(y, safe)
        nxt = torch.where(ar + 1 >= nv, 0, ar + 1)
        ex = _take(vx, nxt) - vx
        ey = _take(vy, nxt) - vy
        # outward distance of every point from every directed edge: a
        # counter-clockwise polygon has the outside at cross < 0
        crossd = (ex[..., None] * (y[:, None, :] - vy[..., None])
                  - ey[..., None] * (x[:, None, :] - vx[..., None]))
        edge_ok = ok & (ar < nv)
        outside = (crossd < 0) & valid[:, None, :] & edge_ok[..., None]
        pick = torch.argmax(torch.where(outside, -crossd, -BIG), dim=2)
        has = outside.any(dim=2)
        pick = torch.where(has, pick, -1)
        # dedupe this round's picks, append them after the current vertices
        ps = torch.sort(torch.where(pick >= 0, pick, cap), dim=1)[0]
        first = torch.cat([ps[:, :1] < cap,
                           (ps[:, 1:] != ps[:, :-1]) & (ps[:, 1:] < cap)], 1)
        new = torch.where(first, ps, -1)
        n_new = first.sum(dim=1, keepdim=True)
        napp = torch.sort(torch.where(new >= 0, ar, h), dim=1,
                          stable=True)[1]
        new_c = torch.where(ar < n_new, _take(new, napp), -1)
        take = torch.minimum(n_new, h - nv)
        ext = torch.cat([idx, idx.new_full((K, 1), -1)], dim=1)
        ext.scatter_(1, torch.where(ar < take, nv + ar, h), new_c)
        return ext[:, :h], ~has.any(dim=1) | (take[:, 0] == 0)

    idx, done = round_step(idx)
    it = 1
    while it < h and not prof.sync(bool, done.all()):
        new_idx, new_done = round_step(idx)
        idx = torch.where(done[:, None], idx, new_idx)
        done = done | new_done
        it += 1
    idx = order_ccw(idx)
    hull_valid = (idx >= 0) & any_valid[:, None]
    safe = idx.clamp(0, cap - 1)
    return torch.stack([_take(x, safe), _take(y, safe)], dim=-1), hull_valid


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


def hull_prune_pack(pts, valid, cap_out: int, m: int = 16):
    """Exact hull-candidate reduction (Akl-Toussaint) of [K, cap, 2]
    blocks: the extreme points in ``m`` fixed directions form a convex
    polygon, and a point strictly inside it is never a hull vertex. The
    survivors pack, in slot order, into [K, cap_out, 2] by an index
    gather. Returns (packed_pts, packed_valid [K, cap_out], overflow
    i32[K]: survivors beyond cap_out, which may lose a hull vertex)."""
    K, cap, _ = pts.shape
    dev = pts.device
    th = _np.linspace(0, 2 * _np.pi, m, endpoint=False)
    cs = torch.tensor(_np.cos(th), dtype=pts.dtype, device=dev)
    sn = torch.tensor(_np.sin(th), dtype=pts.dtype, device=dev)
    px, py = pts[..., 0], pts[..., 1]
    proj = torch.where(valid[..., None], px[..., None] * cs
                       + py[..., None] * sn, -BIG)            # [K, cap, m]
    ext = torch.argmax(proj, dim=1)                           # [K, m]
    gx, gy = _take(px, ext), _take(py, ext)
    nxt = (torch.arange(m, device=dev) + 1) % m
    ex = gx[:, nxt] - gx
    ey = gy[:, nxt] - gy
    edge_ok = (ex * ex + ey * ey) > 0
    # extremes ordered by direction angle are in counter-clockwise convex
    # position: strictly inside <=> cross > 0 for every nonzero edge
    cross = (ex[:, None, :] * (py[..., None] - gy[:, None, :])
             - ey[:, None, :] * (px[..., None] - gx[:, None, :]))
    inside = ((cross > 0) | ~edge_ok[:, None, :]).all(dim=2) \
        & edge_ok.any(dim=1, keepdim=True)
    keep = valid & ~inside
    total = keep.sum(dim=1, dtype=torch.int32)
    order = torch.sort(torch.where(keep, torch.arange(cap, device=dev), cap),
                       dim=1, stable=True)[1][:, :cap_out]
    if cap_out > cap:
        order = torch.cat([order, order.new_zeros((K, cap_out - cap))], 1)
    sel = torch.arange(cap_out, device=dev)[None, :] < total[:, None]
    packed = torch.gather(pts, 1, order[..., None].expand(-1, -1, 2))
    packed = torch.where(sel[..., None], packed, BIG)
    return packed, sel, torch.clamp_min(total - cap_out, 0)


_PAIRS4 = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
_TRIPS4 = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))


def _mec_of_4(sx, sy, sv):
    """Exact MEC of <= 4 masked points per row of [K, 4]: the 6 pairs and 4
    triples with containment over the valid four, a pair winning exact
    ties. Returns (cx, cy, r2, on bool[K, 4] -- the winner's defining
    slots)."""
    dev = sx.device
    pairs = torch.tensor(_PAIRS4, device=dev)
    trips = torch.tensor(_TRIPS4, device=dev)
    ar4 = torch.arange(4, device=dev)
    pi, pj = pairs[:, 0], pairs[:, 1]

    def encl(cx, cy, r2, skip):
        ex = cx[..., None] - sx[:, None, :]
        ey = cy[..., None] - sy[:, None, :]
        d2 = ex * ex + ey * ey
        return ((d2 <= r2[..., None]) | ~sv[:, None, :] | skip).all(dim=-1)

    cx2 = (sx[:, pi] + sx[:, pj]) / 2
    cy2 = (sy[:, pi] + sy[:, pj]) / 2
    ex = cx2 - sx[:, pi]
    ey = cy2 - sy[:, pi]
    r2_2 = ex * ex + ey * ey
    pskip = (ar4[None, :] == pi[:, None]) | (ar4[None, :] == pj[:, None])
    p_ok = sv[:, pi] & sv[:, pj] & encl(cx2, cy2, r2_2, pskip)
    pr2 = torch.where(p_ok, r2_2, BIG)
    bp = torch.argmin(pr2, dim=1, keepdim=True)

    ta, tb, tc = trips[:, 0], trips[:, 1], trips[:, 2]
    pts4 = torch.stack([sx, sy], dim=-1)
    cx3, cy3, r2_3 = _circumcircle(pts4[:, ta], pts4[:, tb], pts4[:, tc])
    r2_3 = torch.where(torch.isfinite(r2_3), r2_3, BIG)
    tskip = ((ar4[None, :] == ta[:, None]) | (ar4[None, :] == tb[:, None])
             | (ar4[None, :] == tc[:, None]))
    t_ok = sv[:, ta] & sv[:, tb] & sv[:, tc] & encl(cx3, cy3, r2_3, tskip)
    tr2 = torch.where(t_ok, r2_3, BIG)
    bt = torch.argmin(tr2, dim=1, keepdim=True)

    best_pair, best_trip = _take(pr2, bp), _take(tr2, bt)
    use_t = best_trip < best_pair
    cx = torch.where(use_t, _take(cx3, bt), _take(cx2, bp))[:, 0]
    cy = torch.where(use_t, _take(cy3, bt), _take(cy2, bp))[:, 0]
    r2 = torch.where(use_t, best_trip, best_pair)[:, 0]
    on = torch.where(use_t, tskip[bt[:, 0]], pskip[bp[:, 0]]) & sv
    return cx, cy, r2, on


def min_enclosing_circle_eh(hull_pts, hull_valid, max_rounds: int = None):
    """MEC of hull points [K, h, 2] by Elzinga-Hearn support iteration:
    keep a support set of <= 4 points, solve its MEC in closed form, prune
    it to the defining points and add the farthest point outside; stop
    when none is outside (or after ``max_rounds``, default h). Exact in
    float64; in float32 near-cocircular hulls can cycle below an ulp and
    end unconverged (the JAX package's own finding). Returns (cx, cy,
    radius), radius 0 with fewer than 2 valid points."""
    K, h, _ = hull_pts.shape
    if max_rounds is None:
        max_rounds = h
    dev = hull_pts.device
    px = torch.where(hull_valid, hull_pts[..., 0], BIG)
    py = torch.where(hull_valid, hull_pts[..., 1], BIG)
    ar = torch.arange(h, device=dev)

    # initial support: the first valid point and the farthest from it
    i0 = torch.argmax(hull_valid.to(torch.int32), dim=1, keepdim=True)
    ex, ey = px - _take(px, i0), py - _take(py, i0)
    i1 = torch.argmax(torch.where(hull_valid, ex * ex + ey * ey, -1.0),
                      dim=1, keepdim=True)
    s_idx = torch.cat([i0, i1, i0, i0], dim=1)
    s_val = torch.tensor([True, True, False, False],
                         device=dev).expand(K, 4).clone()

    def body(s_idx, s_val):
        cx, cy, r2, on = _mec_of_4(_take(px, s_idx), _take(py, s_idx), s_val)
        s_val = s_val & on
        is_sup = ((ar[None, :, None] == s_idx[:, None, :])
                  & s_val[:, None, :]).any(dim=2)
        ex, ey = cx[:, None] - px, cy[:, None] - py
        d2 = torch.where(hull_valid & ~is_sup, ex * ex + ey * ey, -1.0)
        f = torch.argmax(d2, dim=1, keepdim=True)
        outside = _take(d2, f)[:, 0] > r2
        free = torch.argmin(s_val.to(torch.int32), dim=1, keepdim=True)
        s_idx = s_idx.scatter(1, free, torch.where(outside[:, None], f,
                                                   _take(s_idx, free)))
        s_val = s_val.scatter(1, free, _take(s_val, free) | outside[:, None])
        return s_idx, s_val, cx, cy, r2, ~outside

    s_idx, s_val, cx, cy, r2, done = body(s_idx, s_val)
    it = 1
    while it < max_rounds and not prof.sync(bool, done.all()):
        new = body(s_idx, s_val)
        keep = done
        s_idx = torch.where(keep[:, None], s_idx, new[0])
        s_val = torch.where(keep[:, None], s_val, new[1])
        cx, cy, r2 = (torch.where(keep, a, b)
                      for a, b in zip((cx, cy, r2), new[2:5]))
        done = done | new[5]
        it += 1

    none = hull_valid.sum(dim=1) < 2
    radius = torch.where(none, 0.0, torch.sqrt(torch.clamp_min(r2, 0.0)))
    return (torch.where(none, hull_pts[:, 0, 0], cx),
            torch.where(none, hull_pts[:, 0, 1], cy), radius)


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


def _shapes_batched(points, valid, max_hull: int, chunk_k: int,
                    tri_chunk: int, hull: str, mec: str, prune_cap: int):
    """Plain hull + MEC + rect, ``chunk_k`` clusters at a time: (center_x,
    center_y, radius, len_long, len_short, area, prune_overflow), each
    [K]."""
    if hull not in ("wrap", "quick"):
        raise ValueError(f"unknown hull {hull!r}")
    hull_fn = convex_hull if hull == "wrap" else convex_hull_quick
    outs = []
    for s in range(0, points.shape[0], max(chunk_k, 1)):
        p, v = points[s:s + chunk_k], valid[s:s + chunk_k]
        if prune_cap:
            p, v, povf = hull_prune_pack(p, v, prune_cap)
        else:
            povf = torch.zeros(p.shape[0], dtype=torch.int32,
                               device=p.device)
        hp, hv = hull_fn(p, v, max_hull)
        if mec == "eh":
            circle = min_enclosing_circle_eh(hp, hv)
        else:
            circle = min_enclosing_circle(hp, hv, tri_chunk)
        outs.append(circle + min_area_rect(hp, hv) + (povf,))
    return tuple(torch.cat(col) for col in zip(*outs))


def shapes_plain(points, valid, max_hull: int = 64, chunk_k: int = 256,
                 tri_chunk: int = 512):
    """K2's plain version -- gift wrap, pair/triple MEC, rect -- ``chunk_k``
    clusters at a time: (center_x, center_y, radius, len_long, len_short,
    area), each f32[K], before the small-cluster zeroing of
    ``cluster_shapes``."""
    return _shapes_batched(points, valid, max_hull, chunk_k, tri_chunk,
                           "wrap", "scan", 0)[:6]


def cluster_shapes(points, valid, counts, max_hull: int = 64,
                   min_points: int = 4, chunk_k: int = 256,
                   hull: str = "wrap", tri_chunk: int = 512,
                   mec: str = "scan", prune_cap: int = 0,
                   backend: str = "auto"):
    """Hull + MEC + min-rect for a batch of padded clusters.

    points [K, cap, 2]; valid [K, cap]; counts [K] true point counts.
    Clusters with count < min_points get zeros (Q9). ``hull``: "wrap"
    (reference order) or "quick"; ``mec``: "scan" or "eh"; ``prune_cap``:
    pack the survivors of exact candidate pruning into that many slots
    first (0: off). K2 serves only wrap, scan, no pruning, as the Pallas
    kernel does; every other combination runs the plain version, on the
    card too. Returns dict of [K] f32: center_x, center_y, radius,
    rect_len0, rect_len1, rect_area, aspect, and prune_overflow i32[].
    """
    kernel = resolve_backend(backend, points.device) == "cuda"
    if kernel and hull == "wrap" and mec == "scan" and not prune_cap:
        from ..kernels.shapes import shapes_cuda

        cx, cy, r, l0, l1, area = shapes_cuda(points, valid, max_hull)
        povf = torch.zeros(1, dtype=torch.int32, device=points.device)
    else:
        cx, cy, r, l0, l1, area, povf = _shapes_batched(
            points, valid, max_hull, chunk_k, tri_chunk, hull, mec,
            prune_cap)
    skip = counts < min_points
    zero = torch.zeros_like(r)
    return {
        "prune_overflow": povf.sum(dtype=torch.int32),
        "center_x": cx,
        "center_y": cy,
        "radius": torch.where(skip, zero, r),
        "rect_len0": torch.where(skip, zero, l0),
        "rect_len1": torch.where(skip, zero, l1),
        "rect_area": torch.where(skip, zero, area),
        "aspect": torch.where(skip | (l1 <= 0), zero,
                              l0 / torch.clamp_min(l1, 1e-30)),
    }
