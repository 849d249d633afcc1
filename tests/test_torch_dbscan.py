"""PyTorch port vs the JAX package: DBSCAN (plain path on the CPU).

Labels, core flags and cluster counts must be bit-equal. L2 fixtures keep
every pair away from the eps boundary: the reference's dense path decides
sqrt(expansion) <= eps while its Pallas kernel decides sum(diff^2) <= eps^2.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.cluster import dbscan as jd
from vtkcloudpoint_tpu.ops.pallas.dbscan_kernel import dbscan_blocks_pallas
from vtkcloudpoint_tpu_torch.cluster import dbscan as td

from tests.conftest import make_blobs

KEYS = ("label", "n_clusters", "core")


def _blocks(seed, B=4, cap=128, dims=2, n_clusters=3, pts_per=25, noise=15,
            spread=0.012):
    rng = np.random.default_rng(seed)
    coords = np.zeros((B, cap, dims), np.float32)
    valid = np.zeros((B, cap), bool)
    for b in range(B):
        pts = make_blobs(rng, n_clusters=n_clusters, pts_per=pts_per,
                         noise=noise, spread=spread)
        if dims == 3:
            pts = np.concatenate([pts, spread * rng.standard_normal(
                (len(pts), 1))], axis=1)
        coords[b, :len(pts)] = pts
        valid[b, :len(pts)] = True
    return coords, valid


def _margin(coords, valid, eps):
    """Least |d - eps| over valid pairs, d the exact Euclidean distance."""
    worst = np.inf
    for c, v in zip(coords.astype(np.float64), valid):
        p = c[v]
        d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1))
        worst = min(worst, np.abs(d - eps).min())
    return worst


def _eq(a, b):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy"])
def test_dbscan_blocks_matches_jax(seed, metric):
    coords, valid = _blocks(seed)
    a = jd.dbscan_blocks(jnp.asarray(coords), jnp.asarray(valid), 0.06, 9,
                         metric)
    b = td.dbscan_blocks(torch.from_numpy(coords), torch.from_numpy(valid),
                         0.06, 9, metric, chunk=3)
    _eq(a, b)


@pytest.mark.parametrize("dims", [2, 3])
def test_dbscan_blocks_l2_matches_jax(dims):
    coords, valid = _blocks(10 + dims, B=2, dims=dims, n_clusters=2,
                            pts_per=30, noise=10, spread=0.01)
    eps = 0.05
    assert _margin(coords, valid, eps) > 1e-5
    a = jd.dbscan_blocks(jnp.asarray(coords), jnp.asarray(valid), eps, 6,
                         "l2_xyz")
    b = td.dbscan_blocks(torch.from_numpy(coords), torch.from_numpy(valid),
                         eps, 6, "l2_xyz")
    _eq(a, b)


def test_dbscan_blocks_matches_pallas_kernel():
    coords, valid = _blocks(21)
    a = dbscan_blocks_pallas(jnp.asarray(coords), jnp.asarray(valid), 0.06,
                             9)
    b = td.dbscan_blocks(torch.from_numpy(coords), torch.from_numpy(valid),
                         0.06, 9)
    _eq(a, b)


def test_dispatch_on_cpu_is_plain():
    coords, valid = _blocks(5, B=3)
    c, v = torch.from_numpy(coords), torch.from_numpy(valid)
    a = td.dbscan_blocks(c, v, 0.06, 9)
    for backend in ("auto", "torch"):
        b = td.dbscan_blocks_dispatch(c, v, 0.06, 9, backend=backend)
        for key in KEYS:
            assert torch.equal(a[key], b[key])


@pytest.mark.parametrize("cf", [0, 7])
@pytest.mark.parametrize("max_iters", [1, 64])
def test_dbscan_padded_cf_and_max_iters(cf, max_iters):
    rng = np.random.default_rng(30)
    pts = make_blobs(rng, n_clusters=5, pts_per=30, noise=40,
                     spread=0.015).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[::13] = False
    a = jd.dbscan_padded(jnp.asarray(pts), jnp.asarray(valid), 0.05, 5,
                         cf=cf, max_iters=max_iters)
    b = td.dbscan_padded(torch.from_numpy(pts), torch.from_numpy(valid),
                         0.05, 5, cf=torch.tensor(cf, dtype=torch.int32),
                         max_iters=max_iters)
    _eq(a, b)


@pytest.mark.parametrize("chunk", [32, 2048])
@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy"])
def test_dbscan_dense_chunked(chunk, metric):
    rng = np.random.default_rng(31)
    pts = make_blobs(rng, n_clusters=4, pts_per=30, noise=50,
                     spread=0.015).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[5::17] = False
    a = jd.dbscan_dense_chunked(jnp.asarray(pts), jnp.asarray(valid), 0.05,
                                5, metric, cf=3, chunk=chunk)
    b = td.dbscan_dense_chunked(torch.from_numpy(pts),
                                torch.from_numpy(valid), 0.05, 5, metric,
                                cf=3, chunk=chunk)
    c = td.dbscan_padded(torch.from_numpy(pts), torch.from_numpy(valid),
                         0.05, 5, metric, cf=3)
    _eq(a, b)
    for key in KEYS:
        assert torch.equal(b[key], c[key])


def test_dbscan_matlab_convention():
    rng = np.random.default_rng(32)
    pts = make_blobs(rng, n_clusters=3, pts_per=20, noise=20,
                     spread=0.01).astype(np.float32)
    assert _margin(pts[None], np.ones((1, len(pts)), bool), 0.04) > 1e-5
    la, na = jd.dbscan_matlab_convention(pts, 5, 0.04)
    lb, nb = td.dbscan_matlab_convention(torch.from_numpy(pts), 5, 0.04)
    np.testing.assert_array_equal(np.asarray(la), lb.numpy())
    assert int(na) == int(nb)
    assert (lb.numpy() == -1).any() and (lb.numpy() > 0).any()
