"""PyTorch port vs the JAX package: the radius neighbour count (K4's plain
version) on the CPU.

- l1_motor (D = 2) and l2_xyz (D = 3): radius_count_plain bit-equal to
  radius_count_pallas (interpret mode, tiles 128, as
  tests/test_pallas_neighbor.py runs it) and to radius_count_jnp on every
  row. radius_count_jnp decides L2 by sqrt(|a|^2 - 2ab + |b|^2), whose
  rounding moves a distance by ~4e-5 of eps here, so the fixtures keep
  every pair at least 1e-4 (relative) away from eps.
- signed_sum_xy: the port equals radius_count_jnp; the Pallas kernel counts
  by squared L2 for every metric but l1_motor (neighbor.py:68-76), so it
  differs on the same fixture.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.ops.pallas.neighbor import (radius_count_jnp,
                                                   radius_count_pallas)
from vtkcloudpoint_tpu_torch.cluster.dbscan import dbscan_blocks
from vtkcloudpoint_tpu_torch.kernels import neighbor as kn

EPS = 0.1


def _fixture(seed, n, d, valid_frac=0.9):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, d)).astype(np.float32)
    valid = rng.random(n) < valid_frac
    return pts, valid


def _min_gap(pts, metric, eps):
    """Least |dist - eps| / eps over all pairs, in float64."""
    diff = pts[:, None, :].astype(np.float64) - pts[None, :, :]
    if metric == "l1_motor":
        dist = np.abs(diff).sum(-1)
    elif metric == "signed_sum_xy":
        dist = diff.sum(-1)
    else:
        dist = np.sqrt((diff ** 2).sum(-1))
    return float(np.abs(dist / eps - 1.0).min())


def _port(pts, valid, eps, metric, chunk=2048):
    return kn.radius_count_plain(torch.from_numpy(pts),
                                 torch.from_numpy(valid), eps, metric,
                                 chunk).numpy()


@pytest.mark.parametrize("metric,d,seed", [("l1_motor", 2, 0),
                                           ("l2_xyz", 3, 3)])
def test_plain_equals_pallas_and_jnp(metric, d, seed):
    pts, valid = _fixture(seed, 300, d)
    assert _min_gap(pts, metric, EPS) > 1e-4
    got = _port(pts, valid, EPS, metric, chunk=128)
    pallas = np.asarray(radius_count_pallas(
        jnp.asarray(pts), jnp.asarray(valid), EPS, metric, tile_q=128,
        tile_r=128))
    ref = np.asarray(radius_count_jnp(jnp.asarray(pts), jnp.asarray(valid),
                                      EPS, metric))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)
    assert (got[~valid] == 0).all() and (got[valid] >= 1).all()


def test_signed_sum_equals_jnp_not_pallas():
    pts, valid = _fixture(4, 300, 2)
    eps = 0.01
    assert _min_gap(pts, "signed_sum_xy", eps) > 1e-4
    got = _port(pts, valid, eps, "signed_sum_xy", chunk=100)
    ref = np.asarray(radius_count_jnp(jnp.asarray(pts), jnp.asarray(valid),
                                      eps, "signed_sum_xy"))
    np.testing.assert_array_equal(got, ref)
    # the Pallas kernel's fall-through counts the same pairs by squared L2
    pallas = np.asarray(radius_count_pallas(
        jnp.asarray(pts), jnp.asarray(valid), eps, "signed_sum_xy",
        tile_q=128, tile_r=128))
    assert not np.array_equal(got, pallas)
    np.testing.assert_array_equal(pallas, _port(pts, valid, eps, "l2_xyz"))


@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy", "l2_xy"])
@pytest.mark.parametrize("chunk", [1, 7, 64, 4096])
def test_chunking_and_dispatch(metric, chunk):
    pts, valid = _fixture(3, 97, 2)
    full = _port(pts, valid, 0.15, metric)
    np.testing.assert_array_equal(_port(pts, valid, 0.15, metric, chunk),
                                  full)
    got = kn.radius_count(torch.from_numpy(pts), torch.from_numpy(valid),
                          0.15, metric, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), full)


def test_plain_rows_subset():
    pts, valid = _fixture(6, 120, 3)
    t, v = torch.from_numpy(pts), torch.from_numpy(valid)
    rows = torch.tensor([5, 0, 119, 5, 64])
    full = kn.radius_count_plain(t, v, 0.2, "l2_xyz")
    got = kn.radius_count_plain(t, v, 0.2, "l2_xyz", chunk=2, rows=rows)
    assert torch.equal(got, full[rows])


def test_l2_threshold_is_eps_squared_in_double():
    """Two points f32(eps) apart: their f32 squared distance lies above
    f32(eps * eps) but equals f32(f32(eps)^2). The port compares with
    eps * eps squared in double and rounded once, as the Pallas kernel does,
    so they are not neighbours."""
    eps = 0.1
    thr = float(np.float32(eps * eps))
    d2 = float(np.float32(np.float32(eps) * np.float32(eps)))
    assert d2 > thr
    assert kn._radius_threshold(eps, "l2_xyz") == thr
    assert kn._radius_threshold(eps, "l1_motor") == float(np.float32(eps))
    pts = np.float32([[0.0, 0.0], [eps, 0.0], [0.0, 0.0]])
    valid = np.array([True, True, False])
    got = _port(pts, valid, eps, "l2_xy")
    want = np.asarray(radius_count_pallas(
        jnp.asarray(pts), jnp.asarray(valid), eps, "l2_xyz", tile_q=128,
        tile_r=128))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1, 1, 0]


def test_unknown_metric_raises():
    pts, valid = _fixture(4, 10, 2)
    t, v = torch.from_numpy(pts), torch.from_numpy(valid)
    for fn in (kn.radius_count_plain, kn.radius_count):
        with pytest.raises(ValueError, match="unknown metric"):
            fn(t, v, 0.1, "cosine")
    with pytest.raises(ValueError, match="CUDA"):
        kn.radius_count(t, v, 0.1, "l1_motor", backend="cuda")


def test_empty_input():
    out = kn.radius_count_plain(torch.zeros(0, 2),
                                torch.zeros(0, dtype=torch.bool), 0.1)
    assert out.shape == (0,) and out.dtype == torch.int32


@pytest.mark.parametrize("metric,eps", [("l1_motor", 0.05),
                                        ("signed_sum_xy", 0.02)])
def test_count_is_dbscan_core_test(metric, eps):
    """On one [cap = 128, 2] block, count >= min_pts is the port's DBSCAN
    core flag."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(0.2, 0.8, (4, 2))
    pts = np.concatenate([c + 0.02 * rng.standard_normal((25, 2))
                          for c in centers]
                         + [rng.uniform(0, 1, (28, 2))]).astype(np.float32)
    valid = np.ones(128, bool)
    valid[rng.choice(128, 12, replace=False)] = False
    counts = _port(pts, valid, eps, metric)
    db = dbscan_blocks(torch.from_numpy(pts)[None],
                       torch.from_numpy(valid)[None], eps, 6, metric)
    core = db["core"][0].numpy()
    np.testing.assert_array_equal(counts >= 6, core)
    assert 0 < core.sum() < valid.sum()
