"""PyTorch port vs the JAX package: grid-hash DBSCAN (cluster/grid.py) on
the fixtures of tests/test_grid.py, plus an overflowing cell, a run cut at
max_iters = 1 and cell coordinates whose products with the hash primes
overflow int32. Labels, core flags, n_clusters and overflow bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.conftest import make_blobs
from vtkcloudpoint_tpu.cluster import grid as jg
from vtkcloudpoint_tpu_torch.cluster import grid as tg

KEYS = ("label", "n_clusters", "core", "overflow")


def _both(pts, valid, eps, min_pts, **kw):
    pts = np.asarray(pts, np.float32)
    valid = np.asarray(valid, bool)
    a = jg.dbscan_grid(jnp.asarray(pts), jnp.asarray(valid), eps, min_pts,
                       **kw)
    b = tg.dbscan_grid(torch.from_numpy(pts), torch.from_numpy(valid), eps,
                       min_pts, **kw)
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)
    return b


@pytest.mark.parametrize("seed", range(5))
def test_blobs_l1(seed):
    rng = np.random.default_rng(seed)
    pts = make_blobs(rng, n_clusters=5, pts_per=35, noise=40, spread=0.012)
    out = _both(pts, np.ones(len(pts), bool), 0.06, 9, cell_cap=64)
    assert int(out["overflow"]) == 0 and int(out["n_clusters"]) > 0


def test_large_blobs(rng):
    pts = make_blobs(rng, n_clusters=12, pts_per=80, noise=200, spread=0.01)
    out = _both(pts, np.ones(len(pts), bool), 0.04, 6, cell_cap=96)
    assert int(out["overflow"]) == 0


def test_cf_and_padding(rng):
    pts = make_blobs(rng, n_clusters=3, pts_per=30, noise=20, spread=0.01)
    n = len(pts)
    coords = np.zeros((n + 37, 2))
    coords[:n] = pts
    valid = np.zeros(n + 37, bool)
    valid[:n] = True
    out = _both(coords, valid, 0.06, 9, cf=5, cell_cap=64)
    assert (out["label"].numpy()[n:] == 0).all()
    assert int(out["label"].max()) == 5 + int(out["n_clusters"])


def test_overflowing_cell_still_equals_jax():
    """100 coincident points, cell_cap 8: 92 points overflow; the truncated
    result is still JAX's."""
    out = _both(np.zeros((100, 2)), np.ones(100, bool), 0.1, 5, cell_cap=8)
    assert int(out["overflow"]) == 92


def test_overflow_with_blobs(rng):
    pts = make_blobs(rng, n_clusters=4, pts_per=60, noise=30, spread=0.004)
    out = _both(pts, np.ones(len(pts), bool), 0.05, 12, cell_cap=16)
    assert int(out["overflow"]) > 0


@pytest.mark.parametrize("seed", range(3))
def test_3d_l2(seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 1, size=(6, 3))
    pts = np.concatenate([c + 0.01 * rng.standard_normal((40, 3))
                          for c in centers]
                         + [rng.uniform(0, 1, size=(60, 3))])
    out = _both(pts, np.ones(len(pts), bool), 0.05, 6, metric="l2_xyz",
                cell_cap=96)
    assert int(out["overflow"]) == 0


def test_3d_negative_coords(rng):
    pts = rng.uniform(-3, -1, size=(150, 3))
    pts[:60] = pts[0] + 0.004 * rng.standard_normal((60, 3))
    _both(pts, np.ones(150, bool), 0.03, 5, metric="l2_xyz", cell_cap=96)


def test_2d_l2_xy(rng):
    pts = make_blobs(rng, n_clusters=5, pts_per=40, noise=30, spread=0.01)
    _both(pts, rng.random(len(pts)) < 0.9, 0.04, 5, metric="l2_xy",
          cell_cap=48)


@pytest.mark.parametrize("max_iters", [1, 2])
def test_truncated_propagation(max_iters):
    """A chain whose least index (0) sits at its far end needs many sweeps,
    and a blob holds index 1. Cut at max_iters, the chain's far points
    still carry labels above 1, which renumber to the blob's id: the
    labels are JAX's truncated ones, not the fixpoint's."""
    chain = np.stack([np.linspace(0, 1, 200)[::-1], np.zeros(200)], -1)
    blob = np.array([0.5, 5.0]) + 0.001 * np.random.default_rng(0) \
        .standard_normal((20, 2))
    pts = np.concatenate([chain[:1], blob, chain[1:]])
    full = _both(pts, np.ones(220, bool), 0.008, 2, cell_cap=8)
    cut = _both(pts, np.ones(220, bool), 0.008, 2, cell_cap=8,
                max_iters=max_iters)
    assert int(full["n_clusters"]) == int(cut["n_clusters"]) == 2
    assert not torch.equal(full["label"], cut["label"])


def test_hash_products_overflow_int32(rng):
    """Cell indices up to ~4000 (a 200-wide box at eps 0.05): every
    index times a hash prime wraps int32, and 3D sums wrap again."""
    pts = rng.uniform(0, 200, (400, 3))
    pts[:100] = pts[0] + 0.01 * rng.standard_normal((100, 3))
    pts[100:160] = pts[100] + 0.01 * rng.standard_normal((60, 3))
    cidx = np.floor((pts - pts.min(0)) / 0.05).astype(np.int64)
    assert (np.abs(cidx * np.abs(tg._PRIMES[0])) >= 2**31).any()
    out = _both(pts, np.ones(400, bool), 0.05, 5, metric="l2_xyz",
                cell_cap=64)
    assert int(out["n_clusters"]) >= 2
    _both(pts[:, :2], np.ones(400, bool), 0.05, 5, cell_cap=64)


def test_hash_helpers():
    rng = np.random.default_rng(3)
    c = rng.integers(-5000, 5000, (64, 3))
    for primes in (tg._PRIMES, tg._PRIMES2):
        got = tg.cell_hash(torch.from_numpy(c), primes).numpy()
        want = (c.astype(np.int32) * np.int32(primes)).astype(np.int32)
        with np.errstate(over="ignore"):
            want = (want[:, 0] + want[:, 1] + want[:, 2]).astype(np.int32)
        np.testing.assert_array_equal(got, want)
    assert tg.wrap32(2**31) == -2**31 and tg.wrap32(-2**31 - 1) == 2**31 - 1
    for ndim in (2, 3):
        for metric in ("l1_motor", "l2_xyz", "l2_xy", "signed_sum_xy"):
            assert tg.grid_metric(metric, ndim) == jg.grid_metric(metric,
                                                                  ndim)


def test_unknown_metric_and_dims_raise():
    with pytest.raises(ValueError, match="metric"):
        tg.dbscan_grid(torch.zeros(8, 2), torch.ones(8, dtype=torch.bool),
                       0.1, 2, metric="signed_sum_xy")
    with pytest.raises(ValueError, match="D in"):
        tg.dbscan_grid(torch.zeros(8, 4), torch.ones(8, dtype=torch.bool),
                       0.1, 2)
