"""PyTorch port vs the JAX package: SE(3) solves, nearest-neighbour
correspondence and ICP (plain path on the CPU).

- se3: atol 1e-6 (float32 3x3/4x4 algebra in two libraries);
- NN vs nn_pallas (direct differences, like the port): idx bit-equal,
  d2 rtol 1e-6;
- NN vs the jnp path (|a|^2 - 2ab + |b|^2 expansion): idx equal, d2
  rtol 1e-4 and atol 1e-6 (tests/test_pallas_neighbor.py:35), on fixtures
  whose best and second-best distances differ clearly;
- ICP: R and t atol 1e-5 (tests/test_pallas_dbscan.py:128), iterations
  equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.config import ICPConfig
from vtkcloudpoint_tpu.ops import se3 as js
from vtkcloudpoint_tpu.ops.pallas.neighbor import nn_pallas
from vtkcloudpoint_tpu.register import icp as ji
from vtkcloudpoint_tpu_torch.convert import from_numpy, to_numpy
from vtkcloudpoint_tpu_torch.kernels.neighbor import nn_plain
from vtkcloudpoint_tpu_torch.ops import se3 as ts
from vtkcloudpoint_tpu_torch.register import icp as ti

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rot(ang, axis=(0.3, -0.2, 0.93)):
    a = np.asarray(axis, np.float64)
    a /= np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return (np.eye(3) + np.sin(ang) * k
            + (1 - np.cos(ang)) * k @ k).astype(np.float32)


def _pairs(seed, n=80, ang=0.3):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    y = (p @ _rot(ang).T + np.float32([0.2, -0.1, 0.05])
         + 0.001 * rng.standard_normal((n, 3))).astype(np.float32)
    w = (rng.random(n) < 0.8).astype(np.float32)
    return p, y, w


def test_quat_to_rot_and_rotz():
    q = np.float32([0.9, 0.1, -0.3, 0.2])
    q /= np.linalg.norm(q)
    np.testing.assert_allclose(ts.quat_to_rot(_t(q)).numpy(),
                               np.asarray(js.quat_to_rot(jnp.asarray(q))),
                               atol=ATOL)
    np.testing.assert_allclose(
        ts.rotz(torch.tensor(0.7, dtype=torch.float32)).numpy(),
        np.asarray(js.rotz(jnp.float32(0.7))), atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("solver", ["horn", "kabsch"])
@pytest.mark.parametrize("weighted", [False, True])
def test_rigid_solves(seed, solver, weighted):
    p, y, w = _pairs(seed)
    jf = js.horn_solve if solver == "horn" else js.kabsch_solve
    tf = ts.horn_solve if solver == "horn" else ts.kabsch_solve
    ra, ta = jf(jnp.asarray(p), jnp.asarray(y),
                jnp.asarray(w) if weighted else None)
    rb, tb = tf(_t(p), _t(y), _t(w) if weighted else None)
    np.testing.assert_allclose(rb.numpy(), np.asarray(ra), atol=ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(ta), atol=ATOL)


def test_horn_from_moments_apply_compose():
    p, y, w = _pairs(2)
    sw = w.sum()
    sp = (p * w[:, None]).sum(0)
    sy = (y * w[:, None]).sum(0)
    spy = ((p * w[:, None]).T @ y).astype(np.float32)
    ra, ta = js.horn_from_moments(jnp.float32(sw), jnp.asarray(sp),
                                  jnp.asarray(sy), jnp.asarray(spy))
    rb, tb = ts.horn_from_moments(float(sw), _t(sp), _t(sy), _t(spy))
    np.testing.assert_allclose(rb.numpy(), np.asarray(ra), atol=ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(ta), atol=ATOL)
    r0, t0 = _rot(0.4), np.float32([0.1, 0.2, -0.3])
    np.testing.assert_allclose(
        ts.apply_rigid(_t(r0), _t(t0), _t(p)).numpy(),
        np.asarray(js.apply_rigid(jnp.asarray(r0), jnp.asarray(t0),
                                  jnp.asarray(p))), atol=ATOL)
    for a, b in zip(js.compose(ra, ta, jnp.asarray(r0), jnp.asarray(t0)),
                    ts.compose(rb, tb, _t(r0), _t(t0))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


def _nn_fixture(seed, n=200, m=350):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    r = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    rv = rng.random(m) < 0.9
    return q, r, rv


def _gap(q, r, rv):
    """Least relative gap between each query's best and second distance."""
    d = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    d[:, ~rv] = np.inf
    s = np.sort(d, axis=1)
    return ((s[:, 1] - s[:, 0]) / np.maximum(s[:, 1], 1e-12)).min()


def test_nn_plain_matches_pallas_kernel():
    q, r, rv = _nn_fixture(0)
    ia, da = nn_pallas(jnp.asarray(q), jnp.asarray(r), jnp.asarray(rv),
                       tile_q=128, tile_r=128)
    ib, db = nn_plain(_t(q), _t(r), _t(rv), chunk=64)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))
    np.testing.assert_allclose(db.numpy(), np.asarray(da), rtol=1e-6)


def test_nn_plain_ties_and_no_valid_reference():
    q = np.float32([[0, 0, 0], [5, 5, 5]])
    r = np.float32([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [9, 9, 9]])
    idx, d2 = nn_plain(_t(q), _t(r), _t(np.array([False, True, True, True])))
    assert idx.tolist() == [1, 3] and d2[0].item() == 1.0
    idx, d2 = nn_plain(_t(q), _t(r), _t(np.zeros(4, bool)))
    assert idx.tolist() == [0, 0] and (d2.numpy() == np.float32(1e30)).all()


@pytest.mark.parametrize("seed", [1, 2])
def test_nn_correspond_matches_jnp(seed):
    q, r, rv = _nn_fixture(seed)
    assert _gap(q, r, rv) > 1e-4
    ia, da = ji.nn_correspond(jnp.asarray(q), jnp.asarray(r),
                              jnp.asarray(rv), backend="jnp")
    ib, db = ti.nn_correspond(_t(q), _t(r), _t(rv), chunk=64)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))
    np.testing.assert_allclose(db.numpy(), np.asarray(da), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("cfg", [
    ICPConfig(max_iterations=30),
    ICPConfig(max_iterations=30, solver="kabsch"),
    ICPConfig(max_iterations=30, start_by_matching_centroids=False),
    ICPConfig(max_iterations=3),
])
def test_icp_matches_jax(cfg):
    rng = np.random.default_rng(5)
    src = rng.uniform(-1, 1, (96, 3)).astype(np.float32)
    tgt = (src @ _rot(0.2, (0, 0, 1)).T
           + np.float32([0.1, -0.05, 0.02])).astype(np.float32)
    sv = np.ones(96, bool)
    sv[::11] = False
    tv = np.ones(96, bool)
    a = ji.icp(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(tgt),
               jnp.asarray(tv), cfg, backend="jnp")
    b = to_numpy(ti.icp(*from_numpy((src, sv, tgt, tv), "cpu"), cfg))
    np.testing.assert_allclose(b.r, np.asarray(a.r), atol=1e-5)
    np.testing.assert_allclose(b.t, np.asarray(a.t), atol=1e-5)
    assert int(b.iterations) == int(a.iterations)
    assert bool(b.converged) == bool(a.converged)
    # the jnp path's expansion form leaves ~|p|^2 * 2^-24 of noise in each
    # squared distance; the port's direct differences do not
    np.testing.assert_allclose(float(b.error), float(a.error), atol=1e-5)
