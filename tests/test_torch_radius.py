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


def _k4_schedule(pts, valid, eps, metric, tiles=2):
    """CPU mirror of K4's schedule (csrc/radius.cu) at a super-tile of S =
    32 ``tiles`` points (the kernel's S is 2,048; a small S gives several
    super-tiles at a small N): super-tiles (I, J >= I), 32 x 32 tiles
    inside, row tile R against column tiles C >= R in a diagonal
    super-tile; padding past N at 0. Each unordered pair's distance d is
    computed once, from the row point, and decides the row and, off the
    diagonal tiles, the column (the signed sum's column sees -d), each
    masked by the row's and the column's validity. A super-tile takes the
    sign of thr - d (thr + d mirrored), unless thr is not finite or a
    valid point of its rows or columns is wild (a coordinate NaN, infinite
    or >= 2^126): then d <= thr (-thr <= d mirrored). The mirror asserts
    that no signed decision meets a NaN distance. The diagonal tiles test
    every point against itself."""
    code = kn.RADIUS_METRICS[metric]
    thr = torch.tensor(kn._radius_threshold(eps, metric),
                       dtype=torch.float32) + 0.0
    n, dims = pts.shape
    S = 32 * tiles
    n_s = -(-n // S)
    padded = torch.zeros((n_s * S, dims))
    padded[:n] = torch.from_numpy(pts)
    ok = torch.zeros(n_s * S, dtype=torch.bool)
    ok[:n] = torch.from_numpy(valid)
    wild = ok & ~(padded.abs() < 2.0 ** 126).all(dim=1)
    exact_thr = not bool(thr.abs() < float("inf"))
    count = torch.zeros(n_s * S, dtype=torch.int32)
    for I in range(n_s):
        for J in range(I, n_s):
            exact = exact_thr or bool(wild[I * S:I * S + S].any()
                                      or wild[J * S:J * S + S].any())
            for R in range(tiles):
                r0 = I * S + 32 * R
                q = padded[r0:r0 + 32]
                for C in range(R if I == J else 0, tiles):
                    c0 = J * S + 32 * C
                    d = None
                    for k in range(dims):
                        e = q[:, None, k] - padded[None, c0:c0 + 32, k]
                        term = (e.abs() if code == 0
                                else (e if code == 1 else e * e))
                        d = term if d is None else d + term
                    mask = ok[r0:r0 + 32, None] & ok[None, c0:c0 + 32]
                    if exact:
                        row, col = d <= thr, -thr <= d
                    else:
                        assert not bool(d[mask].isnan().any())
                        row = ~torch.signbit(thr - d)
                        col = ~torch.signbit(thr + d)
                    row = row & mask
                    count[r0:r0 + 32] += row.sum(1, dtype=torch.int32)
                    if I == J and C == R:
                        continue
                    col = (col & mask) if code == 1 else row
                    count[c0:c0 + 32] += col.sum(0, dtype=torch.int32)
    return count[:n].numpy()


# eps per metric: l1 and l2 0.1, the signed sum negative (a half-plane)
SCHEDULE_EPS = {"l1_motor": 0.1, "signed_sum_xy": -0.05, "l2_xyz": 0.1}


@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy", "l2_xyz"])
def test_k4_schedule_equals_plain_and_jnp(metric, dims):
    """K4's unordered-pair schedule gives radius_count_plain bit for bit at
    N = 1, 31, 33 and N not a multiple of the super-tile, and
    radius_count_jnp where no pair lies within 1e-4 (relative) of eps; with
    a negative eps a point does not count itself."""
    eps = SCHEDULE_EPS[metric]
    for n in (1, 31, 33, 150):
        # the first seed whose pairs all keep 1e-4 away from eps
        pts, valid = next(f for f in (_fixture(s * 100 + n + dims, n, dims,
                                               0.8) for s in range(50))
                          if _min_gap(f[0], metric, eps) > 1e-4)
        if n == 1:
            valid[:] = True
        got = _k4_schedule(pts, valid, eps, metric)
        np.testing.assert_array_equal(got, _port(pts, valid, eps, metric))
        ref = np.asarray(radius_count_jnp(jnp.asarray(pts),
                                          jnp.asarray(valid), eps, metric))
        np.testing.assert_array_equal(got, ref)
        assert (got[~valid] == 0).all()
        if eps > 0:
            assert (got[valid] >= 1).all()


@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy", "l2_xyz"])
def test_k4_schedule_at_eps_and_all_invalid(metric):
    """Points on an f32 grid of eps (pairs exactly at eps, and exactly at
    -eps for the signed sum), and every row invalid."""
    eps = 0.125
    rng = np.random.default_rng(9)
    pts = (rng.integers(0, 6, (70, 2)) * np.float32(eps)).astype(np.float32)
    valid = rng.random(70) < 0.9
    # eps 0 and -0: an exact-zero difference is +0, so both keep d <= 0
    for e in (eps, -eps, 0.0, -0.0):
        got = _k4_schedule(pts, valid, e, metric)
        np.testing.assert_array_equal(got, _port(pts, valid, e, metric))
    none = np.zeros(70, bool)
    assert (_k4_schedule(pts, none, eps, metric) == 0).all()
    np.testing.assert_array_equal(_port(pts, none, eps, metric),
                                  np.zeros(70, np.int32))


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy", "l2_xyz"])
def test_k4_schedule_non_finite(metric, tiles):
    """Valid rows with NaN or infinite coordinates (a NaN distance is never
    within; inf - inf is NaN), valid points at +-1e30, +-8e37 and +-3e38,
    invalid rows holding NaN, 1e30 or inf, and eps up to inf: the
    schedule's masked decisions, signed where no NaN can arise, give
    radius_count_plain."""
    rng = np.random.default_rng(10)
    pts = rng.uniform(0, 1, (100, 2)).astype(np.float32)
    # NaN, infinite, huge and large-but-tame points in different
    # super-tiles, so each kind decides its own tiles' path
    nan_rows, inf_rows = np.arange(3, 6), np.arange(70, 75)
    huge_rows, tame_rows = np.arange(96, 100), np.arange(40, 42)
    pts[nan_rows] = np.float32([[np.nan, 0.5], [0.5, np.nan],
                                [np.nan, np.nan]])
    pts[inf_rows] = np.float32([[np.inf, 0.5], [np.inf, 0.5],
                                [-np.inf, 0.2], [np.inf, -np.inf],
                                [0.3, -np.inf]])
    # 3e38 - (-3e38) overflows: the signed sum of (3e38, -3e38) and
    # (-3e38, 3e38) is inf + -inf, NaN
    pts[huge_rows] = np.float32([[1e30, -1e30], [3e38, 3e38],
                                 [3e38, -3e38], [-3e38, 3e38]])
    # differences stay finite: these take the sign path
    pts[tame_rows] = np.float32([[8e37, -8e37], [-8e37, 8e37]])
    valid = rng.random(100) < 0.8
    for rows in (nan_rows, inf_rows, huge_rows, tame_rows):
        valid[rows] = True
    bad = np.flatnonzero(~valid)
    pts[bad] = np.float32([[np.nan, np.nan], [1e30, 1e30],
                           [np.inf, np.inf]])[np.arange(len(bad)) % 3]
    for eps in (0.1, -0.1, 1e15, np.inf):
        got = _k4_schedule(pts, valid, eps, metric, tiles)
        np.testing.assert_array_equal(got, _port(pts, valid, eps, metric))
        assert (got[~valid] == 0).all()


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
