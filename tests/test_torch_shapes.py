"""PyTorch port vs the JAX package: hull, minimal enclosing circle and
min-area rectangle (plain path on the CPU).

Tolerances: rtol 2e-5, atol 1e-6 on radius, area and centre, as
tests/test_pallas_shapes.py holds the Pallas kernel; the long/short split of
an exact-tie rectangle may flip (the reference's own caveat).
"""
import numpy as np
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
