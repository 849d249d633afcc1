"""PyTorch port vs the JAX package: hull, minimal enclosing circle and
min-area rectangle (plain path on the CPU).

Tolerances: rtol 2e-5, atol 1e-6 on radius, area and centre, as
tests/test_pallas_shapes.py holds the Pallas kernel; the long/short split of
an exact-tie rectangle may flip (the reference's own caveat).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.ops import geometry as jg
from vtkcloudpoint_tpu.ops.pallas.shapes_kernel import cluster_shapes_pallas
from vtkcloudpoint_tpu_torch.ops import geometry as tg

KEYS = ("radius", "rect_area", "center_x", "center_y")


def _clusters(seed, K=12, cap=128):
    """Random blobs, collinear runs, two-point and empty clusters."""
    rng = np.random.default_rng(seed)
    points = np.zeros((K, cap, 2), np.float32)
    valid = np.zeros((K, cap), bool)
    counts = np.zeros(K, np.int32)
    for k in range(K):
        n = int(rng.integers(2, cap))
        if k % 6 == 1:
            points[k, :n, 0] = np.linspace(0, 1, n)
            points[k, :n, 1] = 0.5
        elif k % 6 == 2:
            n = 2
            points[k, :n] = [[0.1, 0.2], [0.7, 0.9]]
        elif k % 6 == 3:
            n = 0
        else:
            points[k, :n] = (rng.uniform(0.1, 0.9, 2)
                             + 0.05 * rng.standard_normal((n, 2)))
        # scatter the valid slots so padding sits between points
        slots = np.sort(rng.choice(cap, n, replace=False))
        points[k, slots] = points[k, :n].copy()
        valid[k, slots] = True
        counts[k] = n
    return points, valid, counts


def _close(ref, out, l0_flips=0.8):
    for key in KEYS:
        np.testing.assert_allclose(np.asarray(out[key], np.float64),
                                   np.asarray(ref[key], np.float64),
                                   rtol=2e-5, atol=1e-6, err_msg=key)
    l0 = np.asarray(out["rect_len0"], np.float64)
    l1 = np.asarray(out["rect_len1"], np.float64)
    area = np.asarray(out["rect_area"], np.float64)
    assert (l0 >= l1).all() and (l1 >= 0).all()
    np.testing.assert_allclose(l0 * l1, area, rtol=1e-5, atol=1e-9)
    matches = np.isclose(l0, np.asarray(ref["rect_len0"], np.float64),
                         rtol=2e-5, atol=1e-6)
    assert matches.mean() >= l0_flips, f"too many l0 flips: {matches}"


def _torch(points, valid, counts):
    return (torch.from_numpy(points), torch.from_numpy(valid),
            torch.from_numpy(counts))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_hull", [8, 32])
def test_cluster_shapes_matches_jax(seed, max_hull):
    points, valid, counts = _clusters(seed)
    ref = jg.cluster_shapes(jnp.asarray(points), jnp.asarray(valid),
                            jnp.asarray(counts), max_hull=max_hull,
                            chunk_k=12, backend="jnp")
    out = tg.cluster_shapes(*_torch(points, valid, counts),
                            max_hull=max_hull, chunk_k=5, tri_chunk=100)
    _close(ref, out)
    np.testing.assert_allclose(out["aspect"].numpy()[counts < 4], 0.0)


def test_cluster_shapes_matches_pallas_kernel():
    points, valid, counts = _clusters(7, K=8)
    ref = cluster_shapes_pallas(jnp.asarray(points), jnp.asarray(valid),
                                jnp.asarray(counts), max_hull=16)
    out = tg.cluster_shapes(*_torch(points, valid, counts), max_hull=16)
    _close(ref, out)


def test_empty_and_tiny_clusters():
    """Q9: clusters under min_points get zeros; an empty one too."""
    points = np.zeros((3, 64, 2), np.float32)
    valid = np.zeros((3, 64), bool)
    counts = np.zeros(3, np.int32)
    points[1, 0] = [0.5, 0.5]
    valid[1, 0] = True
    counts[1] = 1
    points[2, :6] = 0.3 + 0.01 * np.random.default_rng(0).standard_normal(
        (6, 2))
    valid[2, :6] = True
    counts[2] = 6
    ref = jg.cluster_shapes(jnp.asarray(points), jnp.asarray(valid),
                            jnp.asarray(counts), max_hull=16, backend="jnp")
    out = tg.cluster_shapes(*_torch(points, valid, counts), max_hull=16)
    _close(ref, out, l0_flips=1.0)
    r = out["radius"].numpy()
    assert r[0] == 0.0 and r[1] == 0.0 and r[2] > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_hull_mec_rect_pieces(seed):
    points, valid, _ = _clusters(seed, K=6)
    tp, tv = torch.from_numpy(points), torch.from_numpy(valid)
    hp, hv = tg.convex_hull(tp, tv, 16)
    for k in range(points.shape[0]):
        jp, jv = jg.convex_hull(jnp.asarray(points[k]), jnp.asarray(valid[k]),
                                16)
        np.testing.assert_array_equal(np.asarray(jv), hv[k].numpy())
        np.testing.assert_array_equal(np.asarray(jp), hp[k].numpy())
        jc = jg.min_enclosing_circle(jp, jv)
        jr = jg.min_area_rect(jp, jv)
        tc = tg.min_enclosing_circle(hp[k:k + 1], hv[k:k + 1])
        tr = tg.min_area_rect(hp[k:k + 1], hv[k:k + 1])
        for a, b in zip(jc + jr[2:], tc + tr[2:]):
            np.testing.assert_allclose(b.numpy()[0], float(a), rtol=2e-5,
                                       atol=1e-6)


def test_pseudo_angle_and_triple_table():
    rng = np.random.default_rng(3)
    x1, y1, x2, y2 = rng.uniform(-1, 1, (4, 200)).astype(np.float32)
    x2[:10], y2[:10] = x1[:10], y1[:10]          # identical points
    x2[10:20] = x1[10:20]                        # vertical
    a = jg.pseudo_angle(*map(jnp.asarray, (x1, y1, x2, y2)))
    b = tg.pseudo_angle(*map(torch.from_numpy, (x1, y1, x2, y2)))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for h in (2, 3, 7, 32):
        np.testing.assert_array_equal(jg._triple_table(h),
                                      tg._triple_table(h))


F32 = np.float32


def _advance_pair(a, b, step, nh):
    """csrc/shapes.cu: advance_pair, the pair `step` places later in
    row-major order over a < b < nh (a >= nh - 1 past the end)."""
    b += step
    while a < nh - 1 and b >= nh:
        b -= nh - a - 2
        a += 1
    return a, b


def _advance_triple(a, b, c, step, nh):
    """csrc/shapes.cu: advance_triple, the triple `step` places later in
    lexicographic order over a < b < c < nh (a >= nh - 2 past the end)."""
    c += step
    while a < nh - 2 and c >= nh:
        r = c - nh
        b += 1
        if b >= nh - 1:
            a += 1
            b = a + 1
        c = b + 1 + r
    return a, b, c


def _lane_candidates(lane, nh, threads=32):
    """The pairs and the triples thread ``lane`` of K2's MEC walks, in its
    order, in a group of ``threads`` (32: a warp; 128: a block's four
    warps): every ``threads``-th pair from pair ``lane`` (row-major), every
    ``threads``-th triple from triple ``lane`` (lexicographic)."""
    pairs, triples = [], []
    a, b = _advance_pair(0, 1, lane, nh)
    while a < nh - 1:
        pairs.append((a, b))
        a, b = _advance_pair(a, b, threads, nh)
    a, b, c = _advance_triple(0, 1, 2, lane, nh)
    while a < nh - 2:
        triples.append((a, b, c))
        a, b, c = _advance_triple(a, b, c, threads, nh)
    return pairs, triples


@pytest.mark.parametrize("threads", [32, 128])
@pytest.mark.parametrize("h", [2, 3, 7, 32, 64])
def test_k2_enumeration_is_the_tables_below_nh(h, threads):
    """Over a warp's 32 threads, or a block's 128, K2 enumerates each pair
    and triple of the hull's own size nh once: the rows of the plain
    version's tables (np.triu row-major pairs, _triple_table) whose indices
    are below nh, and each thread walks its share in increasing table
    order. For h < 3 the triple table is one degenerate self-triple that
    never wins; the kernel enumerates none."""
    table = [tuple(t) for t in tg._triple_table(h).tolist()]
    for nh in sorted({0, 1, 2, 3, h // 2, h - 1, h}):
        if nh > h:
            continue
        all_p, all_t = [], []
        for lane in range(threads):
            p, t = _lane_candidates(lane, nh, threads)
            assert p == sorted(p) and t == sorted(t)
            all_p += p
            all_t += t
        want_p = [(a, b) for a, b in zip(*np.triu_indices(h, k=1))
                  if b < nh]
        want_t = [t for t in table if t[2] < nh and t[0] < t[1] < t[2]]
        assert sorted(all_p) == want_p
        assert sorted(all_t) == want_t
    if h < 3:
        assert table == [(0, 0, 0)]


def _k2_mec_mirror(hx, hy, threads=32):
    """CPU mirror of K2's MEC (csrc/shapes.cu) over the nh hull points
    hx, hy (float32), lane by lane: a candidate's containment is tested
    only when its r2 is below the lane's best (and, for a triple, below the
    best pair); each lane keeps its least (r2, key), the warp the least
    over the lanes. Returns (cx, cy, radius) as the kernel writes them."""
    nh = len(hx)
    big = F32(1e30)
    two = F32(2.0)

    def pair(a, b):
        cx = (hx[a] + hx[b]) / two
        cy = (hy[a] + hy[b]) / two
        ex, ey = cx - hx[a], cy - hy[a]
        return cx, cy, ex * ex + ey * ey

    def circum(a, b, c):
        x1, y1 = (hx[b] + hx[a]) / two, (hy[b] + hy[a]) / two
        dy1, dx1 = hx[b] - hx[a], -(hy[b] - hy[a])
        x2, y2 = (hx[c] + hx[b]) / two, (hy[c] + hy[b]) / two
        dy2, dx2 = hx[c] - hx[b], -(hy[c] - hy[b])
        denom = dy1 * dx2 - dx1 * dy2
        t1 = ((x1 - x2) * dy2 + (y2 - y1) * dx2) / denom
        cx, cy = x1 + dx1 * t1, y1 + dy1 * t1
        ex, ey = cx - hx[a], cy - hy[a]
        return cx, cy, ex * ex + ey * ey

    def encloses(cx, cy, r2, skip):
        for m in range(nh):
            if m in skip:
                continue
            ex, ey = cx - hx[m], cy - hy[m]
            if not ex * ex + ey * ey <= r2:
                return False
        return True

    lanes = [_lane_candidates(lane, nh, threads) for lane in range(threads)]
    best_p = []
    for pairs, _ in lanes:
        v, key = big, None
        for a, b in pairs:
            r2 = pair(a, b)[2]
            if r2 < v and encloses(*pair(a, b), (a, b)):
                v, key = r2, (a, b)
        best_p.append((v, key or (1 << 30,)))
    best_pair, pkey = min(best_p)
    best_t = []
    for _, triples in lanes:
        v, key = big, None
        for a, b, c in triples:
            r2 = circum(a, b, c)[2]
            if r2 < v and r2 < best_pair and encloses(*circum(a, b, c),
                                                      (a, b, c)):
                v, key = r2, (a, b, c)
        best_t.append((v, key or (1 << 30,)))
    best_trip, tkey = min(best_t)
    if min(best_pair, best_trip) >= big:
        return hx[0], hy[0], F32(0.0)
    use_t = best_trip < best_pair
    cx, cy, _ = circum(*tkey) if use_t else pair(*pkey)
    return cx, cy, np.sqrt(max(best_trip if use_t else best_pair, F32(0)))


def _mec_hulls():
    """Hull point sets (not necessarily convex, as min_enclosing_circle
    takes any): cocircular (exact ties of r2 between triples), collinear,
    with duplicates, random, and of 1-3 points."""
    rng = np.random.default_rng(21)
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    circle = np.stack([np.cos(ang), np.sin(ang)], -1)
    square = np.float32([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]])
    hulls = [circle, circle[::-1].copy(), 0.5 + 0.25 * circle[[0, 3, 6, 9]],
             np.stack([np.linspace(0, 1, 9), np.linspace(0, 0.5, 9)], -1),
             np.repeat(rng.uniform(0, 1, (5, 2)), 2, axis=0), square,
             np.concatenate([square, square]), rng.uniform(0, 1, (1, 2)),
             rng.uniform(0, 1, (2, 2)), rng.uniform(0, 1, (3, 2))]
    hulls += [rng.uniform(0, 1, (n, 2)) for n in (6, 11, 17, 20)]
    hulls += [np.round(rng.uniform(0, 1, (14, 2)) * 3) / 3]
    return [h.astype(np.float32) for h in hulls]


@pytest.mark.parametrize("threads", [32, 128])
def test_k2_mec_mirror_equals_port_and_jax(threads):
    """K2's MEC schedule with its pruning, mirrored in float32 on the CPU
    for a warp and for a block's four warps, equals the port's
    min_enclosing_circle bit for bit and JAX's to rtol 2e-5, on
    cocircular, collinear, duplicate and random hulls."""
    jax_mec = jax.jit(jg.min_enclosing_circle)   # one compile, [20, 2]
    with np.errstate(all="ignore"):
        for pts in _mec_hulls():
            nh = len(pts)
            hp = torch.zeros(1, 20, 2)
            hp[0, :nh] = torch.from_numpy(pts)
            hv = torch.zeros(1, 20, dtype=torch.bool)
            hv[0, :nh] = True
            port = [float(t[0]) for t in tg.min_enclosing_circle(hp, hv)]
            jax_out = [float(t) for t in jax_mec(
                jnp.asarray(hp[0].numpy()), jnp.asarray(hv[0].numpy()))]
            mine = [float(t) for t in _k2_mec_mirror(pts[:, 0], pts[:, 1],
                                                     threads)]
            assert mine == port, (nh, mine, port)
            np.testing.assert_allclose(mine, jax_out, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{"hull": "quick"}, {"mec": "eh"},
                                {"prune_cap": 64}])
def test_unported_variants_raise(kw):
    """Each shape variant equals the JAX package's plain path
    (tests/test_torch_shapes_variants.py holds them in depth). (The name
    dates from when the port refused these variants; it is kept so the
    test's record stays one.)"""
    points, valid, counts = _clusters(0, K=2)
    ref = jg.cluster_shapes(jnp.asarray(points), jnp.asarray(valid),
                            jnp.asarray(counts), max_hull=16, backend="jnp",
                            **kw)
    out = tg.cluster_shapes(*_torch(points, valid, counts), max_hull=16,
                            **kw)
    _close(ref, out, l0_flips=0.5)
    assert int(out["prune_overflow"]) == int(ref["prune_overflow"])
