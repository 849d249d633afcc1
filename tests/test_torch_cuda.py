"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and skips without one.

This file imports neither JAX nor tests/conftest.py, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from vtkcloudpoint_tpu_torch.cluster.dbscan import dbscan_blocks
from vtkcloudpoint_tpu_torch.cluster.grid import dbscan_grid
from vtkcloudpoint_tpu_torch.cluster.halo_fusion import grid_union_ids
from vtkcloudpoint_tpu_torch.cluster.pipeline import cluster_scan
from vtkcloudpoint_tpu_torch.config import (ClusterConfig, EngineConfig,
                                            ICPConfig)
from vtkcloudpoint_tpu_torch.engine import Engine
from vtkcloudpoint_tpu_torch.kernels import build
from vtkcloudpoint_tpu_torch.kernels import dbscan as k_dbscan
from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn
from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes
from vtkcloudpoint_tpu_torch.register.icp import icp
from vtkcloudpoint_tpu_torch.register.nn_grid import (build_nn_grid,
                                                      icp_grid, nn_grid)

pytestmark = pytest.mark.cuda


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _blobs(rng, n_clusters, pts_per, noise, spread, dims):
    centers = rng.uniform(0.1, 0.9, (n_clusters, dims))
    pts = [c + spread * rng.standard_normal((pts_per, dims))
           for c in centers]
    pts.append(rng.uniform(0, 1, (noise, dims)))
    out = np.concatenate(pts)
    return out[rng.permutation(len(out))]


def _blocks(seed, B, cap, dims, fill=0.8):
    rng = np.random.default_rng(seed)
    coords = np.zeros((B, cap, dims), np.float32)
    valid = np.zeros((B, cap), bool)
    for b in range(B):
        n = int(cap * fill)
        pts = _blobs(rng, 4, (n - 20) // 4, n - 4 * ((n - 20) // 4), 0.02,
                     dims)
        slots = np.sort(rng.choice(cap, len(pts), replace=False))
        coords[b, slots] = pts
        valid[b, slots] = True
    return coords, valid


@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy", "l2_xyz"])
@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("cap", [128, 1000, 1024])
def test_dbscan_kernel_matches_plain(gpu, metric, dims, cap):
    coords, valid = _blocks(cap + dims, 6, cap, dims)
    c = torch.from_numpy(coords).to(gpu)
    v = torch.from_numpy(valid).to(gpu)
    eps = 0.03 if metric != "signed_sum_xy" else 0.01
    k = k_dbscan.dbscan_blocks_cuda(c, v, eps, 6, metric)
    p = dbscan_blocks(c, v, eps, 6, metric)
    for key in ("label", "n_clusters", "core"):
        assert torch.equal(k[key], p[key]), key
    assert int(k["n_clusters"].sum()) > 0


def test_dbscan_kernel_long_chain(gpu):
    """One chain of 1024 points whose least index sits at the far end:
    the fixpoint has to carry a label across the whole block."""
    cap = 1024
    x = np.linspace(0, 1, cap, dtype=np.float32)[::-1].copy()
    coords = np.stack([x, np.zeros(cap, np.float32)], -1)[None]
    c = torch.from_numpy(coords).to(gpu)
    v = torch.ones(1, cap, dtype=torch.bool, device=gpu)
    k = k_dbscan.dbscan_blocks_cuda(c, v, 1.5 / cap, 2)
    p = dbscan_blocks(c, v, 1.5 / cap, 2)
    for key in ("label", "n_clusters", "core"):
        assert torch.equal(k[key], p[key]), key
    assert int(k["n_clusters"][0]) == 1


def test_dbscan_kernel_repeats_bit_for_bit(gpu):
    """Two launches on the same blocks give the same labels, core flags and
    counts: the union-find's atomics may run in any order, its roots (the
    least index of each component) do not depend on it."""
    coords, valid = _blocks(7, 64, 1024, 2, fill=0.95)
    c = torch.from_numpy(coords).to(gpu)
    v = torch.from_numpy(valid).to(gpu)
    a = k_dbscan.dbscan_blocks_cuda(c, v, 0.03, 6)
    b = k_dbscan.dbscan_blocks_cuda(c, v, 0.03, 6)
    p = dbscan_blocks(c, v, 0.03, 6)
    for key in ("label", "n_clusters", "core"):
        assert torch.equal(a[key], b[key]), key
        assert torch.equal(a[key], p[key]), key


@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy", "l2_xyz"])
def test_dbscan_kernel_all_core_block(gpu, metric):
    """Every slot valid and within eps of every other: one cluster, all
    core, in full blocks and in a block of 1000 slots (not a multiple of
    32)."""
    rng = np.random.default_rng(12)
    for cap in (1024, 1000):
        coords = rng.uniform(0, 0.01, (3, cap, 2)).astype(np.float32)
        c = torch.from_numpy(coords).to(gpu)
        v = torch.ones(3, cap, dtype=torch.bool, device=gpu)
        eps = 0.05 if metric != "signed_sum_xy" else 0.03
        k = k_dbscan.dbscan_blocks_cuda(c, v, eps, 8, metric)
        p = dbscan_blocks(c, v, eps, 8, metric)
        for key in ("label", "n_clusters", "core"):
            assert torch.equal(k[key], p[key]), key
        assert k["n_clusters"].tolist() == [1, 1, 1]
        assert bool(k["core"].all())


@pytest.mark.parametrize("metric,dims", [("l1_motor", 2), ("l2_xyz", 3)])
def test_dbscan_kernel_shuffled_chain(gpu, metric, dims):
    """A chain of 1000 points along x in slots of a random order, with
    border points at both ends: the root is the least slot index anywhere
    on the chain. The min-label sweeps need more than the plain version's
    default 64 here; K1 runs to the fixpoint, as the Pallas kernel does
    (up to cap sweeps), so the plain version gets max_iters=cap."""
    cap = 1000
    rng = np.random.default_rng(dims)
    coords = np.zeros((2, cap, dims), np.float32)
    coords[:, :, 0] = np.linspace(0, 1, cap, dtype=np.float32)[
        rng.permutation(cap)]
    c = torch.from_numpy(coords).to(gpu)
    v = torch.ones(2, cap, dtype=torch.bool, device=gpu)
    v[1, ::7] = False
    k = k_dbscan.dbscan_blocks_cuda(c, v, 1.5 / cap, 3, metric)
    p = dbscan_blocks(c, v, 1.5 / cap, 3, metric, max_iters=cap)
    for key in ("label", "n_clusters", "core"):
        assert torch.equal(k[key], p[key]), key
    assert int(k["n_clusters"][0]) == 1


def test_dbscan_kernel_refuses_bad_input(gpu):
    c = torch.zeros(2, 64, 2, device=gpu)
    v = torch.ones(2, 64, dtype=torch.bool, device=gpu)
    with pytest.raises(ValueError):
        k_dbscan.dbscan_blocks_cuda(c.double(), v, 0.1, 3)
    with pytest.raises(ValueError):
        k_dbscan.dbscan_blocks_cuda(c.transpose(0, 1), v.t(), 0.1, 3)
    with pytest.raises(ValueError):
        k_dbscan.dbscan_blocks_cuda(torch.zeros(1, 4096, 2, device=gpu),
                                    torch.ones(1, 4096, dtype=torch.bool,
                                               device=gpu), 0.1, 3)
    with pytest.raises(ValueError):
        k_dbscan.dbscan_blocks_cuda(c, v, 0.1, 3, metric="cosine")


def _clusters(seed, K, cap):
    rng = np.random.default_rng(seed)
    points = np.zeros((K, cap, 2), np.float32)
    valid = np.zeros((K, cap), bool)
    for k in range(K):
        n = int(rng.integers(2, cap))
        if k % 6 == 1:
            pts = np.stack([np.linspace(0, 1, n), np.full(n, 0.5)], -1)
        elif k % 6 == 2:
            pts = np.array([[0.1, 0.2], [0.7, 0.9]])
        elif k % 6 == 3:
            pts = np.zeros((0, 2))
        elif k % 6 == 4:        # duplicates on a tiny grid
            pts = np.round(rng.uniform(0, 1, (n, 2)) * 4) / 4
        else:
            pts = rng.uniform(0.1, 0.9, 2) + 0.05 * rng.standard_normal(
                (n, 2))
        slots = np.sort(rng.choice(cap, len(pts), replace=False))
        points[k, slots] = pts
        valid[k, slots] = True
    return points, valid


@pytest.mark.parametrize("max_hull", [3, 8, 32, 64])
@pytest.mark.parametrize("cap", [64, 1024])
def test_shapes_kernel_matches_plain(gpu, max_hull, cap):
    points, valid = _clusters(max_hull + cap, 36, cap)
    p = torch.from_numpy(points).to(gpu)
    v = torch.from_numpy(valid).to(gpu)
    kout = k_shapes.shapes_cuda(p, v, max_hull)
    pout = k_shapes.shapes_plain(p, v, max_hull, chunk_k=16, tri_chunk=97)
    for a, b in zip(kout, pout):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)


def _hard_clusters(seed, K, cap):
    """Clusters of exactly 0, 1, 2 and 3 valid points, cocircular points
    (every triple of a ring has the same circumcircle), duplicates, and
    rings of 70-200 points whose hull reaches max_hull 64, with interior
    points; slots scattered over cap."""
    rng = np.random.default_rng(seed)
    points = np.zeros((K, cap, 2), np.float32)
    valid = np.zeros((K, cap), bool)
    for k in range(K):
        kind = k % 8
        if kind < 4:                                  # 0, 1, 2, 3 points
            pts = rng.uniform(0, 1, (kind, 2))
        elif kind == 4:                               # cocircular
            a = np.linspace(0, 2 * np.pi, 16, endpoint=False)
            pts = 0.5 + 0.3 * np.stack([np.cos(a), np.sin(a)], -1)
        elif kind == 5:                               # duplicates
            pts = np.repeat(rng.uniform(0, 1, (7, 2)), 3, axis=0)
        else:                                         # full hull
            m = min(cap - 10, int(rng.integers(70, 200)))
            a = rng.permutation(np.linspace(0, 2 * np.pi, m,
                                            endpoint=False))
            ring = 0.5 + 0.4 * np.stack([np.cos(a), np.sin(a)], -1)
            pts = np.concatenate([ring, 0.5 + 0.05 * rng.standard_normal(
                (min(10, cap - m), 2))])
        pts = pts[:cap]
        slots = np.sort(rng.choice(cap, len(pts), replace=False))
        points[k, slots] = pts
        valid[k, slots] = True
        points[k, ~valid[k]] = rng.uniform(-5, 5, ((~valid[k]).sum(), 2))
    return points, valid


@pytest.mark.parametrize("K", [1, 5, 37])
@pytest.mark.parametrize("cap", [33, 250, 999])
@pytest.mark.parametrize("max_hull", [32, 64])
def test_shapes_kernel_hard_clusters(gpu, K, cap, max_hull):
    """0-3 valid points, cocircular and duplicate points, hulls that reach
    max_hull; cap not a multiple of 32 (odd caps take the scalar loads),
    and K not a multiple of the clusters a block holds."""
    points, valid = _hard_clusters(K * 1000 + cap, K, cap)
    p = torch.from_numpy(points).to(gpu)
    v = torch.from_numpy(valid).to(gpu)
    kout = k_shapes.shapes_cuda(p, v, max_hull)
    pout = k_shapes.shapes_plain(p, v, max_hull, chunk_k=8)
    for a, b in zip(kout, pout):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("per_sm,extra,group", [(8, 0, 4), (8, 1, 2),
                                                (32, 0, 2), (32, 1, 1)])
def test_shapes_kernel_every_group(gpu, per_sm, extra, group):
    """K on either side of 8 and 32 clusters an SM, where the kernel goes
    from four to two and from two to one warps a cluster: each gives the
    plain version's answer (the enumeration, the pruning and the argmins
    hold for any number of threads a cluster)."""
    K = per_sm * k_nn.sm_count(gpu.index) + extra
    cap = 250
    assert build.load().vtkcp_shapes_group(K, cap, 64) == group
    points, valid = _hard_clusters(K, K, cap)
    p = torch.from_numpy(points).to(gpu)
    v = torch.from_numpy(valid).to(gpu)
    kout = k_shapes.shapes_cuda(p, v, 64)
    pout = k_shapes.shapes_plain(p, v, 64, chunk_k=512)
    for a, b in zip(kout, pout):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)


def test_shapes_kernel_misaligned_rows(gpu):
    """Rows that start off a 16-byte boundary (a contiguous view at an odd
    float offset) take the scalar loads and give the same answer."""
    points, valid = _hard_clusters(3, 16, 128)
    flat = torch.zeros(points.size + 1, device=gpu)
    flat[1:] = torch.from_numpy(points.reshape(-1)).to(gpu)
    p = flat[1:].view(16, 128, 2)
    vbig = torch.zeros(16 * 128 + 1, dtype=torch.bool, device=gpu)
    vbig[1:] = torch.from_numpy(valid.reshape(-1)).to(gpu)
    v = vbig[1:].view(16, 128)
    kout = k_shapes.shapes_cuda(p, v, 64)
    pout = k_shapes.shapes_plain(p.clone(), v.clone(), 64)
    for a, b in zip(kout, pout):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n,m", [(1, 1), (300, 257), (1024, 450),
                                 (2000, 4097)])
def test_nn_kernel_matches_plain(gpu, n, m):
    rng = np.random.default_rng(n + m)
    q = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(gpu)
    r = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(gpu)
    r[m // 2:m // 2 + 3] = r[m // 3]              # exact ties
    rv = torch.from_numpy(rng.random(m) < 0.85).to(gpu)
    rv[m // 3] = True
    for ref_valid in (rv, torch.zeros_like(rv)):
        ki, kd = k_nn.nn_cuda(q, r, ref_valid)
        pi, pd = k_nn.nn_plain(q, r, ref_valid, chunk=512)
        assert torch.equal(ki, pi)
        assert torch.equal(kd, pd)


@pytest.mark.parametrize("n,m", [(1, 5000), (4096, 1), (3, 1)])
def test_nn_kernel_one_query_or_reference(gpu, n, m):
    rng = np.random.default_rng(n * 7 + m)
    q = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(gpu)
    r = torch.from_numpy(rng.uniform(0, 1, (m, 3)).astype(np.float32)).to(gpu)
    rv = torch.ones(m, dtype=torch.bool, device=gpu)
    ki, kd = k_nn.nn_cuda(q, r, rv)
    pi, pd = k_nn.nn_plain(q, r, rv)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


def test_nn_kernel_ties_across_splits(gpu):
    """References repeated at both ends of the array, so equal distances
    fall in different reference splits: the least index wins, as in the
    plain version; all references invalid gives (0, BIG)."""
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    ref = np.concatenate([base, rng.uniform(0, 1, (4000, 3)), base,
                          base]).astype(np.float32)
    q = torch.from_numpy(base[rng.integers(0, 500, 2000)]
                         + np.float32(0.25)).to(gpu)
    r = torch.from_numpy(ref).to(gpu)
    rv = torch.ones(len(ref), dtype=torch.bool, device=gpu)
    rv[:100] = False
    n, m = q.shape[0], r.shape[0]
    splits, _ = k_nn.nn_splits(n, m, 256, k_nn.NN_BLOCKS_PER_SM
                               * k_nn.sm_count(q.device.index))
    assert splits > 1
    for valid in (rv, torch.zeros_like(rv)):
        ki, kd = k_nn.nn_cuda(q, r, valid)
        pi, pd = k_nn.nn_plain(q, r, valid)
        assert torch.equal(ki, pi) and torch.equal(kd, pd)
    ki, kd = k_nn.nn_cuda(q, r, torch.zeros_like(rv))
    assert bool((ki == 0).all()) and bool((kd == k_nn.BIG).all())


def test_nn_kernel_grid_icp_fallback_shape(gpu):
    """N = 4,096 queries against M = 100,000 references (the grid-ICP
    fallback's shape), 10% of them invalid."""
    rng = np.random.default_rng(9)
    ref = (rng.uniform(0, 50, (100_000, 3)) * [1, 1, 0.1]).astype(np.float32)
    q = ref[rng.integers(0, 100_000, 4096)] + 0.02 * rng.standard_normal(
        (4096, 3)).astype(np.float32)
    r = torch.from_numpy(ref).to(gpu)
    rv = torch.from_numpy(rng.random(100_000) < 0.9).to(gpu)
    qt = torch.from_numpy(q.astype(np.float32)).to(gpu)
    ki, kd = k_nn.nn_cuda(qt, r, rv)
    pi, pd = k_nn.nn_plain(qt, r, rv, chunk=512)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


def test_pipeline_on_card_equals_cpu(gpu):
    rng = np.random.default_rng(3)
    motor = _blobs(rng, 12, 150, 200, 0.01, 2).astype(np.float32)
    n = len(motor)
    xyz = np.concatenate([motor, np.ones((n, 1), np.float32)], 1)
    truth = np.concatenate([rng.uniform(0, 1, (40, 2)), np.ones((40, 1))],
                           1).astype(np.float32)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.02, min_pts=6,
                                             block_capacity=256))
    kw = dict(mode="balanced", max_blocks=(n + 255) // 256, quirks=False,
              noise_capacity=1024, max_clusters=128, cluster_capacity=512,
              max_hull=32)
    runs = {}
    for dev in ("cpu", gpu):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        res = cluster_scan(t(xyz), t(motor), valid, cfg, **kw)
        reg = icp(res.center3d, res.count > 0, t(truth),
                  torch.ones(40, dtype=torch.bool, device=dev),
                  ICPConfig(max_iterations=30))
        runs[str(dev)] = (res, reg)
    (a, ra), (b, rb) = runs["cpu"], runs[str(gpu)]
    assert torch.equal(a.label, b.label.cpu())
    assert int(a.n_clusters) == int(b.n_clusters) > 0
    assert torch.equal(a.count, b.count.cpu())
    for f in ("center3d", "radius3d", "radius2d"):
        torch.testing.assert_close(getattr(b, f).cpu(), getattr(a, f),
                                   rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(rb.r.cpu(), ra.r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rb.t.cpu(), ra.t, rtol=0, atol=1e-5)


@pytest.mark.parametrize("metric,dims,eps", [
    ("l1_motor", 2, 0.03), ("l2_xyz", 3, 0.05), ("l2_xy", 2, 0.04),
    ("signed_sum_xy", 2, -0.3), ("l1_motor", 1, 0.002)])
@pytest.mark.parametrize("n", [1, 1023, 5000])
def test_radius_kernel_matches_plain(gpu, metric, dims, eps, n):
    rng = np.random.default_rng(n + dims)
    pts = _blobs(rng, 8, n // 10, n - 8 * (n // 10), 0.02, dims)
    c = torch.from_numpy(pts.astype(np.float32)).to(gpu)
    v = torch.from_numpy(rng.random(n) < 0.85).to(gpu)
    k = k_nn.radius_count_cuda(c, v, eps, metric)
    p = k_nn.radius_count_plain(c, v, eps, metric, chunk=512)
    assert torch.equal(k, p)
    assert bool((k[~v] == 0).all())


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("metric,eps", [("l1_motor", 0.05), ("l2_xyz", 0.05),
                                        ("signed_sum_xy", -0.2)])
def test_radius_kernel_super_tile_edges(gpu, metric, eps, dims):
    """N = 1, 31, 33, and N below, at and above one and two super-tiles of
    2,048 points, every metric at D = 1, 2, 3: bit-equal to the plain
    version; two launches equal (the atomics run in any order)."""
    for n in (1, 31, 33, 2047, 2048, 2049, 4096, 4129):
        rng = np.random.default_rng(n * 10 + dims)
        pts = _blobs(rng, 4, n // 8, n - 4 * (n // 8), 0.02, dims)
        c = torch.from_numpy(pts.astype(np.float32)).to(gpu)
        v = torch.from_numpy(rng.random(n) < 0.85).to(gpu)
        v[0] = True
        k = k_nn.radius_count_cuda(c, v, eps, metric)
        again = k_nn.radius_count_cuda(c, v, eps, metric)
        p = k_nn.radius_count_plain(c, v, eps, metric, chunk=512)
        assert torch.equal(k, p) and torch.equal(k, again)


@pytest.mark.parametrize("metric", ["l1_motor", "l2_xy", "signed_sum_xy"])
def test_radius_kernel_non_finite_and_extreme(gpu, metric):
    """Valid rows with a NaN or an infinite coordinate (a NaN distance is
    never within, as in the plain version; inf - inf is NaN), valid points
    at +-1e30 and +-3e38 (whose signed sums overflow to inf + -inf) and at
    +-8e37 (large, but their differences stay finite), invalid rows holding
    NaN, +-1e30 or inf, and eps up to inf: bit-equal to the plain version.
    NaN and inf points sit in super-tile 0, the huge ones in 2, the large
    ones in 1 and 3, so blocks (1, 1), (1, 3) and (3, 3) take the sign bits
    with 8e37 points and the others compare."""
    rng = np.random.default_rng(12)
    n = 3 * 2048 + 100
    pts = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    kinds = [
        np.float32([[np.nan, 0.5], [0.5, np.nan], [np.nan, np.nan]]),
        np.float32([[np.inf, 0.5], [np.inf, 0.5], [-np.inf, 0.2],
                    [np.inf, -np.inf], [0.3, -np.inf]]),
        np.float32([[1e30, 1e30], [-1e30, -1e30], [1e30, -1e30],
                    [3e38, 3e38], [3e38, -3e38], [-3e38, 3e38]]),
        np.float32([[8e37, -8e37], [-8e37, 8e37]])]
    valid = rng.random(n) < 0.85
    for start, kind in zip((5, 300, 4100, 2100, 6200), kinds + kinds[3:]):
        pts[start:start + len(kind)] = kind
        valid[start:start + len(kind)] = True
    bad = np.flatnonzero(~valid)
    pts[bad] = np.float32([[np.nan, np.nan], [1e30, 1e30], [-1e30, -1e30],
                           [np.inf, np.inf]])[np.arange(len(bad)) % 4]
    c = torch.from_numpy(pts).to(gpu)
    v = torch.from_numpy(valid).to(gpu)
    for eps in (0.1, -0.1, 1e15, np.inf):
        k = k_nn.radius_count_cuda(c, v, eps, metric)
        p = k_nn.radius_count_plain(c, v, eps, metric, chunk=512)
        assert torch.equal(k, p), eps
        assert bool((k[~v] == 0).all())


@pytest.mark.parametrize("metric", ["l1_motor", "l2_xy", "signed_sum_xy"])
def test_radius_kernel_at_eps_and_all_invalid(gpu, metric):
    """Coordinates on an f32 grid of eps, so many pairs lie exactly at eps
    (and at -eps for the signed sum): the kernel's d <= thr and the
    mirrored -d <= thr equal the plain version's; all rows invalid gives
    zeros."""
    eps = 0.125
    rng = np.random.default_rng(4)
    pts = (rng.integers(0, 12, (3000, 2)) * np.float32(eps))
    c = torch.from_numpy(pts.astype(np.float32)).to(gpu)
    v = torch.from_numpy(rng.random(3000) < 0.9).to(gpu)
    for e in (eps, -eps, 0.0, -0.0):
        k = k_nn.radius_count_cuda(c, v, e, metric)
        assert torch.equal(k, k_nn.radius_count_plain(c, v, e, metric))
    none = torch.zeros_like(v)
    assert not bool(k_nn.radius_count_cuda(c, none, eps, metric).any())


def test_radius_kernel_refuses_bad_input(gpu):
    c = torch.zeros(64, 2, device=gpu)
    v = torch.ones(64, dtype=torch.bool, device=gpu)
    with pytest.raises(ValueError):
        k_nn.radius_count_cuda(c.double(), v, 0.1)
    with pytest.raises(ValueError):
        k_nn.radius_count_cuda(torch.zeros(64, 4, device=gpu), v, 0.1)
    with pytest.raises(ValueError):
        k_nn.radius_count_cuda(torch.zeros(2, 64, device=gpu).t(), v, 0.1)
    with pytest.raises(ValueError):
        k_nn.radius_count_cuda(c, v.float(), 0.1)
    with pytest.raises(ValueError, match="unknown metric"):
        k_nn.radius_count_cuda(c, v, 0.1, "cosine")
    p = torch.zeros(2, 64, 2, device=gpu)
    with pytest.raises(ValueError, match="max_hull"):
        k_shapes.shapes_cuda(p, v.view(2, 32).repeat(1, 2), 1025)


def test_engine_on_card_equals_plain(gpu):
    """The Engine workflow with the kernels and with the plain versions on
    the card: labels, rejection, matches and every registration agree, and
    K1-K3 launched."""
    rng = np.random.default_rng(11)
    centers = rng.uniform(5, 25, (30, 2))
    motor = np.concatenate([c + 0.02 * rng.standard_normal((120, 2))
                            for c in centers]
                           + [rng.uniform(5, 25, (300, 2))])
    dist = np.concatenate([np.repeat(rng.uniform(40, 45, 30), 120),
                           rng.uniform(5, 120, 300)])
    runs = {}
    for backend in ("torch", "auto"):
        for m in (k_dbscan, k_shapes, k_nn):
            m.launches = 0
        out = []
        for icp_cfg in (ICPConfig(max_iterations=40),
                        ICPConfig(max_iterations=40, num_starts=4),
                        ICPConfig(max_iterations=40, ransac_iters=32)):
            eng = Engine(EngineConfig(
                cluster=ClusterConfig(eps=0.08, min_pts=8, pts_in_cell=128,
                                      block_capacity=256),
                icp=icp_cfg, backend=backend), device=gpu)
            batch = eng.filter_by_distance(
                eng.import_arrays(motor.astype(np.float32),
                                  dist.astype(np.float32)), 10.0, 100.0)
            res = eng.cluster(batch, mode="balanced", max_clusters=128,
                              cluster_capacity=256)
            batch, rejected = eng.reject_by_radius(batch, res, radius=0.02)
            truth = res.center3d[res.count > 0][1:].cpu().numpy()
            reg = eng.register_to_truth(
                res, truth, generator=torch.Generator().manual_seed(0))
            m = eng.match(res, truth, reg)
            out.append((res, rejected, reg, m))
        counts = [k_dbscan.launches, k_shapes.launches, k_nn.launches]
        runs[backend] = (out, counts)
    (plain, pc), (kern, kc) = runs["torch"], runs["auto"]
    assert pc == [0, 0, 0] and all(c > 0 for c in kc)
    for (ra, ja, ga, ma), (rb, jb, gb, mb) in zip(plain, kern):
        assert torch.equal(ra.label, rb.label)
        assert int(rb.n_clusters) > 20
        assert torch.equal(ja, jb)
        torch.testing.assert_close(gb.r, ga.r, rtol=0, atol=1e-5)
        torch.testing.assert_close(gb.t, ga.t, rtol=0, atol=1e-5)
        assert torch.equal(ma["match_idx"], mb["match_idx"])
        assert int(ma["n_matched"]) == int(mb["n_matched"])


@pytest.mark.parametrize("metric,dims,cell_cap", [
    ("l1_motor", 2, 128), ("l1_motor", 2, 4), ("l2_xyz", 3, 128),
    ("l2_xy", 2, 128)])
def test_grid_engine_on_card_equals_cpu(gpu, metric, dims, cell_cap):
    """Grid-hash DBSCAN on a CUDA tensor and on the CPU: labels, core
    flags, n_clusters and the cell overflow bit-equal (cell_cap 4
    overflows)."""
    rng = np.random.default_rng(dims * 100 + cell_cap)
    pts = _blobs(rng, 10, 80, 300, 0.008, dims).astype(np.float32)
    valid = rng.random(len(pts)) < 0.95
    outs = [dbscan_grid(torch.from_numpy(pts).to(dev),
                        torch.from_numpy(valid).to(dev), 0.02, 6, metric,
                        cf=3, cell_cap=cell_cap) for dev in ("cpu", gpu)]
    for key in ("label", "n_clusters", "core", "overflow"):
        assert torch.equal(outs[0][key], outs[1][key].cpu()), key
    assert int(outs[0]["n_clusters"]) > 0
    assert (cell_cap == 4) == (int(outs[0]["overflow"]) > 0)


@pytest.mark.parametrize("fallback_cap", [0, 64, 4096])
def test_nn_grid_on_card_equals_cpu(gpu, fallback_cap):
    """Grid NN on a CUDA tensor (the fallback through K3) and on the CPU
    (the fallback through its plain version): idx, resolved and the
    overflow bit-equal, d2 rtol 1e-6."""
    rng = np.random.default_rng(fallback_cap)
    ref = rng.uniform(0, 10, (5000, 3)).astype(np.float32)
    rv = rng.random(5000) < 0.9
    query = np.concatenate([
        ref[rng.integers(0, 5000, 1500)]
        + 0.05 * rng.standard_normal((1500, 3)),
        rng.uniform(12, 14, (100, 3))]).astype(np.float32)
    outs = []
    for dev in ("cpu", gpu):
        r, v = torch.from_numpy(ref).to(dev), torch.from_numpy(rv).to(dev)
        grid = build_nn_grid(r, v, 0.5)
        outs.append(nn_grid(grid, torch.from_numpy(query).to(dev), r, v, 0.5,
                            cell_cap=16, fallback_cap=fallback_cap))
    (ai, ad, ar, ao), (bi, bd, br, bo) = outs
    assert torch.equal(ai, bi.cpu()) and torch.equal(ar, br.cpu())
    assert int(ao) == int(bo) >= max(0, 100 - fallback_cap)
    torch.testing.assert_close(bd.cpu(), ad, rtol=1e-6, atol=0)


def test_icp_grid_on_card_equals_cpu(gpu):
    rng = np.random.default_rng(4)
    tgt = (rng.uniform(0, 20, (20000, 3)) * [1, 1, 0.1]).astype(np.float32)
    c, s = np.cos(0.05), np.sin(0.05)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    src = ((tgt[rng.integers(0, 20000, 4000)] - [0.2, -0.1, 0.05]) @ rot
           ).astype(np.float32)
    out = []
    for dev in ("cpu", gpu):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        res, ovf = icp_grid(t(src), torch.ones(4000, dtype=torch.bool,
                                               device=dev),
                            t(tgt), torch.ones(20000, dtype=torch.bool,
                                               device=dev),
                            ICPConfig(max_iterations=20), cell_size=0.8,
                            cell_cap=64, fallback_cap=1024)
        out.append((res, int(ovf)))
    (ra, oa), (rb, ob) = out
    assert oa == ob
    assert int(ra.iterations) == int(rb.iterations)
    torch.testing.assert_close(rb.r.cpu(), ra.r, rtol=0, atol=1e-5)
    torch.testing.assert_close(rb.t.cpu(), ra.t, rtol=0, atol=1e-5)


def _stripe_scan(seed):
    """A long stripe that Morton blocks cut into pieces, and blobs."""
    rng = np.random.default_rng(seed)
    stripe = np.stack([np.linspace(0.05, 0.95, 900),
                       0.5 + 0.004 * rng.standard_normal(900)], -1)
    motor = np.concatenate([stripe, _blobs(rng, 8, 60, 100, 0.01, 2)])
    return motor.astype(np.float32)


def test_halo_union_on_card_equals_cpu(gpu):
    """cluster_scan(halo_merge=True) and grid_union_ids on a CUDA tensor
    and on the CPU: labels, n_clusters and the id remap bit-equal."""
    motor = _stripe_scan(5)
    n = len(motor)
    xyz = np.concatenate([motor, np.ones((n, 1), np.float32)], 1)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.01, min_pts=4,
                                             block_capacity=128))
    kw = dict(mode="balanced", max_blocks=(n + 127) // 128, quirks=False,
              noise_capacity=1024, max_clusters=256, cluster_capacity=1024,
              max_hull=16, halo_merge=True, halo_cap=64)
    runs = {}
    for dev in ("cpu", gpu):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        res = cluster_scan(t(xyz), t(motor),
                           torch.ones(n, dtype=torch.bool, device=dev), cfg,
                           **kw)
        hx = t(motor[::3].copy())
        hlab = t((np.arange(len(hx)) % 40 + 1).astype(np.int32))
        uni = grid_union_ids(hx, hlab, torch.ones(len(hx), dtype=torch.bool,
                                                  device=dev),
                             40, 0.01, "l1_motor", 64, cell_cap=64)
        runs[str(dev)] = (res, uni)
    (a, ua), (b, ub) = runs["cpu"], runs[str(gpu)]
    assert torch.equal(a.label, b.label.cpu())
    assert int(a.n_clusters) == int(b.n_clusters) > 0
    for key in ("remap", "n_after", "idmap", "overflow"):
        assert torch.equal(ua[key], ub[key].cpu()), key


def _slam_scans(seed=0, s=16, n=512, n_marks=8):
    """A landmark world (blobs and background) seen from s poses along a
    loop, float32 scans with 2 mm of noise."""
    rng = np.random.default_rng(seed)
    marks = rng.uniform(-8, 8, (n_marks, 3)) * [1, 1, 0.2]
    per = (2 * n // 3) // n_marks
    blob = (marks[:, None] + 0.06 * rng.standard_normal((n_marks, per, 3))
            ).reshape(-1, 3)
    world = np.concatenate([blob, rng.uniform(-8, 8, (n - len(blob), 3))
                            * [1, 1, 0.2]])
    th = 2 * np.pi * np.arange(s) / s
    scans = []
    for a in th:
        r = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                      [0, 0, 1]])
        t = 2.0 * np.array([np.cos(a), np.sin(a), 0.0])
        scans.append((world - t) @ r + 0.002 * rng.standard_normal((n, 3)))
    return np.stack(scans).astype(np.float32)


def test_nn_kernel_tier4_shape(gpu):
    """N = M = 2,048, the shape of every odometry and closure ICP of the
    tier-4 job: scan k + 1 against scan k of a landmark world."""
    scans = torch.from_numpy(_slam_scans(1, s=2, n=2048)).to(gpu)
    rv = torch.ones(2048, dtype=torch.bool, device=gpu)
    ki, kd = k_nn.nn_cuda(scans[1], scans[0], rv)
    pi, pd = k_nn.nn_plain(scans[1], scans[0], rv)
    assert torch.equal(ki, pi) and torch.equal(kd, pd)


def test_slam_pipeline_ba_on_card_equals_plain(gpu):
    """slam_pipeline_ba through K3 and with the plain versions on the card:
    every pose, cost and n_landmarks bit-equal (K3 equals nn_plain bit for
    bit; every segment sum is deterministic); K3 launched."""
    from vtkcloudpoint_tpu_torch.slam.trajectory import slam_pipeline_ba

    scans = torch.from_numpy(_slam_scans()).to(gpu)
    valid = torch.ones(scans.shape[:2], dtype=torch.bool, device=gpu)
    runs = {}
    for backend in ("torch", "auto"):
        k_nn.launches = 0
        out = slam_pipeline_ba(scans, valid, ICPConfig(max_iterations=20,
                                                       tol=1e-10),
                               loop_radius=2.5, gn_iterations=4,
                               landmark_eps=0.4, landmark_min_pts=6,
                               max_clusters_per_scan=16, ba_iterations=4,
                               backend=backend)
        runs[backend] = (out, k_nn.launches)
    (a, la), (b, lb) = runs["torch"], runs["auto"]
    assert la == 0 and lb > 0
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x.r, y.r) and torch.equal(x.t, y.t)
    for key in ("graph_cost", "ba_cost", "n_landmarks"):
        assert torch.equal(a[3][key], b[3][key]), key
    assert int(b[3]["n_landmarks"]) >= 4


def test_slam_checkpoint_kill_resume_on_card(gpu, tmp_path):
    """Killed after one chunk and resumed: bit-equal to the uninterrupted
    run on the card."""
    from vtkcloudpoint_tpu_torch.slam.trajectory import \
        slam_pipeline_checkpointed

    scans = torch.from_numpy(_slam_scans(2, s=10, n=256)).to(gpu)
    valid = torch.ones(scans.shape[:2], dtype=torch.bool, device=gpu)
    kw = dict(icp_cfg=ICPConfig(max_iterations=20, tol=1e-10), every=3,
              loop_radius=2.5, gn_iterations=4)
    full = slam_pipeline_checkpointed(scans, valid, str(tmp_path / "a"),
                                      **kw)
    assert slam_pipeline_checkpointed(scans, valid, str(tmp_path / "b"),
                                      max_chunks=1, **kw) is None
    resumed = slam_pipeline_checkpointed(scans, valid, str(tmp_path / "b"),
                                         **kw)
    for x, y in zip(full[:2], resumed[:2]):
        assert torch.equal(x.r, y.r) and torch.equal(x.t, y.t)
        assert x.r.is_cuda
    assert torch.equal(full[2], resumed[2])


def test_voxel_downsample_on_card_repeats(gpu):
    """Two runs on the card give the same bits (the float64 per-voxel sums
    are sorted by slot, not left to the order of atomics), and equal the
    CPU's occupancy; centroids rtol 1e-6."""
    from vtkcloudpoint_tpu_torch.ops.voxel import voxel_downsample

    rng = np.random.default_rng(6)
    pts = (rng.uniform(-30, 30, (200_000, 3)) * [1, 1, 0.2]).astype(
        np.float32)
    valid = rng.random(200_000) < 0.95
    p, v = torch.from_numpy(pts).to(gpu), torch.from_numpy(valid).to(gpu)
    a = voxel_downsample(p, v, 0.2, 16384)
    b = voxel_downsample(p, v, 0.2, 16384)
    c = voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid), 0.2,
                         16384)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a[1].cpu(), c[1]) and int(a[2]) == int(c[2])
    torch.testing.assert_close(a[0].cpu(), c[0], rtol=1e-6, atol=1e-6)


# ---- the multi-device paths on a one-rank NCCL mesh ----

def test_sharded_dbscan_world1_nccl_equals_single_device(gpu):
    """sharded_blocked_dbscan on a one-rank NCCL mesh (collectives on the
    card) gives the single-device fusion's labels, with the ring, hier and
    distributed-noise modes equal to the gathered halo union."""
    from vtkcloudpoint_tpu_torch.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu_torch.parallel.distributed import one_rank_group
    from vtkcloudpoint_tpu_torch.parallel.sharded import \
        sharded_blocked_dbscan

    coords, valid = _blocks(11, 8, 256, 2)
    bc = torch.from_numpy(coords).to(gpu)
    bv = torch.from_numpy(valid).to(gpu)
    pidx = torch.arange(bc.shape[0] * bc.shape[1], dtype=torch.int32,
                        device=gpu).reshape(bv.shape)
    pidx = torch.where(bv, pidx, -1)
    kw = dict(quirks=False, noise_capacity_per_device=1024)
    db = k_dbscan.dbscan_blocks_cuda(bc, bv, 0.03, 6)
    fused = merge_blocks(db["label"], bv, bc, pidx, bv.numel(), 0.03, 6,
                         quirks=False, noise_capacity=1024)
    k_dbscan.launches = 0
    with one_rank_group(gpu) as mesh:
        assert mesh.device == gpu
        out = sharded_blocked_dbscan(mesh, bc, bv, 0.03, 6, **kw)
        hkw = dict(halo_merge=True, halo_cap=256, halo_cell_cap=256,
                   max_ids=1024, cell_table_bits=16, **kw)
        halo = {mode: sharded_blocked_dbscan(mesh, bc, bv, 0.03, 6,
                                             halo_mode=mode, **hkw)
                for mode in ("gather", "ring", "hier")}
        dist = sharded_blocked_dbscan(
            mesh, bc, bv, 0.03, 6, halo_mode="hier",
            noise_recluster="distributed", noise_cell_cap=64, **hkw)
    assert k_dbscan.launches > 0
    flat = torch.where(bv, fused["label"][pidx.clamp(0).long()], 0)
    assert torch.equal(out["label"], flat)
    assert int(out["n_total"]) == int(fused["n_total"])
    for o in list(halo.values()) + [dist]:
        assert torch.equal(o["label"], halo["gather"]["label"])
        assert int(o["halo_overflow"]) == int(o["noise_overflow"]) == 0


def test_sharded_icp_launches_k3(gpu):
    from vtkcloudpoint_tpu_torch.parallel.distributed import one_rank_group
    from vtkcloudpoint_tpu_torch.parallel.sharded import sharded_icp

    rng = np.random.default_rng(1)
    pts = (rng.uniform(-1, 1, (512, 3)) * [5, 5, 1]).astype(np.float32)
    c, s = np.cos(0.12), np.sin(0.12)
    r_true = np.float32([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    src = torch.from_numpy(pts).to(gpu)
    tgt = torch.from_numpy(pts @ r_true.T + np.float32([0.4, -0.1, 0.2])
                           ).to(gpu)
    ones = torch.ones(512, dtype=torch.bool, device=gpu)
    cfg = ICPConfig(tol=1e-9)
    k_nn.launches = 0
    with one_rank_group(gpu) as mesh:
        r, t, _, it = sharded_icp(mesh, src, ones, tgt, ones, cfg)
    assert k_nn.launches == int(it) > 0
    single = icp(src, ones, tgt, ones, cfg)
    assert int(single.iterations) == int(it)
    assert float((r - single.r).abs().max()) <= 1e-5
    assert float((t - single.t).abs().max()) <= 1e-5


def test_make_mesh_refuses_a_size_the_world_lacks(gpu):
    """make_mesh(2) on a one-rank group raises (never a 1-rank "2-device"
    run), and a CUDA mesh refuses a gloo group (no host staging)."""
    import torch.distributed as tdist

    from vtkcloudpoint_tpu_torch.parallel.distributed import (free_port,
                                                              one_rank_group)
    from vtkcloudpoint_tpu_torch.parallel.mesh import make_mesh

    with one_rank_group(gpu):
        with pytest.raises(RuntimeError, match="rank"):
            make_mesh(2, device=gpu)
        assert make_mesh(1, device=gpu).size == 1
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                             f"{free_port()}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="NCCL"):
            make_mesh(1, device=gpu)
    finally:
        tdist.destroy_process_group()
