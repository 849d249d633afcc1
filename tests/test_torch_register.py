"""PyTorch port vs the JAX package: matching, coarse alignment, seeded
labels, random rotations, multi-start and RANSAC ICP on the CPU.

- assign_matches, registration_rmse: idx and is_matched equal, distances
  rtol 1e-5 (JAX's CPU path takes the |a|^2 - 2ab + |b|^2 expansion, the
  port direct differences), on fixtures whose nearest and second-nearest
  truth points, and whose distances and the threshold, lie clearly apart;
- coarse functions rtol 1e-6; points_in_box bit-equal;
- seeded_labels bit-equal (both sides use the expansion) on a fixture
  without near-ties or near-radius distances;
- multi-start and RANSAC: jax.random and torch draw different numbers, so
  the port's deterministic steps take the JAX package's own samples, made
  here with the same split/choice calls; R and t atol 1e-5.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.cluster import seeded as jseed
from vtkcloudpoint_tpu.config import ICPConfig
from vtkcloudpoint_tpu.ops import se3 as jse3
from vtkcloudpoint_tpu.register import coarse as jco
from vtkcloudpoint_tpu.register import icp as jicp
from vtkcloudpoint_tpu.register import matching as jm
from vtkcloudpoint_tpu_torch.cluster import seeded as tseed
from vtkcloudpoint_tpu_torch.ops import se3 as tse3
from vtkcloudpoint_tpu_torch.register import coarse as tco
from vtkcloudpoint_tpu_torch.register import icp as ticp
from vtkcloudpoint_tpu_torch.register import matching as tm


@pytest.fixture(autouse=True)
def one_thread():
    """Run on one torch thread: under parallel test workers, torch's thread
    pool oversubscribes the cores and each of the workflow's many small ops
    waits on its barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rotz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _nn_gap(q, r):
    """Least relative gap between each query's best and second squared
    distance (float64)."""
    d = ((q[:, None].astype(np.float64) - r[None]) ** 2).sum(-1)
    s = np.sort(d, axis=1)
    return float(((s[:, 1] - s[:, 0]) / s[:, 1]).min())


def _scene(seed):
    """Truth markers on a 3 x 3 grid near the origin, two centres 0.12-0.16
    from each marker and six strays 0.3-0.4 above one, all moved by the
    inverse of (r, t): matched at a threshold of 0.25, strays not. Small
    coordinates and distances of 0.1 or more keep the expansion's rounding
    (~1e-7 in d^2) below 1e-5 of each distance."""
    rng = np.random.default_rng(seed)
    g = np.array([-0.5, 0.0, 0.5])
    truth = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)
    truth = np.concatenate([truth + 0.02 * rng.standard_normal((9, 2)),
                            np.zeros((9, 1))], 1).astype(np.float32)
    dirs = rng.standard_normal((18, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    near = (np.repeat(truth, 2, axis=0)
            + dirs * rng.uniform(0.12, 0.16, (18, 1)))
    far = truth[rng.choice(9, 6)] + np.outer(rng.uniform(0.3, 0.4, 6),
                                             [0, 0, 1])
    cen = np.concatenate([near, far])[rng.permutation(24)]
    r = _rotz(0.01)
    t = np.float32([0.02, -0.03, 0.0])
    cen = ((cen - t) @ r).astype(np.float32)        # R cen + t ~ truth
    valid = np.ones(24, bool)
    valid[::7] = False
    return cen, valid, truth, r, t


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_matches_and_rmse(seed):
    cen, valid, truth, r, t = _scene(seed)
    tv = np.ones(len(truth), bool)
    moved = cen @ r.T + t
    assert _nn_gap(moved, truth) > 1e-3
    a = jm.assign_matches(jnp.asarray(cen), jnp.asarray(valid),
                          jnp.asarray(truth), jnp.asarray(tv),
                          jnp.asarray(r), jnp.asarray(t), 0.25)
    b = tm.assign_matches(_t(cen), _t(valid), _t(truth), _t(tv), _t(r),
                          _t(t), 0.25)
    np.testing.assert_array_equal(b["match_idx"].numpy(),
                                  np.asarray(a["match_idx"]))
    np.testing.assert_array_equal(b["is_matched"].numpy(),
                                  np.asarray(a["is_matched"]))
    dist = b["match_dist"].numpy()
    assert np.abs(dist / 0.25 - 1).min() > 1e-3
    np.testing.assert_allclose(dist, np.asarray(a["match_dist"]), rtol=1e-5)
    np.testing.assert_allclose(b["matched_xyz"].numpy(),
                               np.asarray(a["matched_xyz"]), atol=1e-6)
    assert 0 < int(b["n_matched"]) == int(a["n_matched"]) < valid.sum()
    np.testing.assert_allclose(
        float(tm.registration_rmse(b, _t(truth))),
        float(jm.registration_rmse(a, jnp.asarray(truth))), rtol=1e-5)


def test_coarse_rescale_and_region():
    rng = np.random.default_rng(2)
    cen = rng.uniform(1, 3, (30, 2)).astype(np.float32)
    cv = rng.random(30) < 0.8
    truth = rng.uniform(-4, 4, (25, 2)).astype(np.float32)
    tv = np.ones(25, bool)
    tv[3] = False
    a = jco.auto_rescale_centers(jnp.asarray(cen), jnp.asarray(cv),
                                 jnp.asarray(truth), jnp.asarray(tv))
    b = tco.auto_rescale_centers(_t(cen), _t(cv), _t(truth), _t(tv))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-6)
    region = truth[:, 0] > 0
    ra = jco.rescale_region_truth(jnp.asarray(truth), jnp.asarray(region),
                                  a[2])
    rb = tco.rescale_region_truth(_t(truth), _t(region), b[2])
    np.testing.assert_allclose(rb.numpy(), np.asarray(ra), rtol=1e-6,
                               atol=1e-6)


def test_region_box_and_point_moves():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 1, (400, 2)).astype(np.float32)
    xy[:4] = [[0.25, 0.5], [0.75, 0.5], [0.5, 0.25], [0.5, 0.75]]
    ja = jco.RegionBox(0.25, 0.25, 0.75, 0.75)
    tb = tco.RegionBox(0.25, 0.25, 0.75, 0.75)
    for op in (lambda b: b, lambda b: b.translate(0.1, -0.05),
               lambda b: b.zoom(0.5), lambda b: b.zoom(1.5).translate(
                   -0.2, 0.1)):
        bj, bt = op(ja), op(tb)
        assert (bt.min_x, bt.min_y, bt.max_x, bt.max_y) == (
            bj.min_x, bj.min_y, bj.max_x, bj.max_y)
        np.testing.assert_array_equal(
            tco.points_in_box(_t(xy), bt).numpy(),
            np.asarray(jco.points_in_box(jnp.asarray(xy), bj)))
    # (min, max]: the min edges are out, the max edges in
    assert tco.points_in_box(_t(xy[:4]), tb).tolist() == [False, True,
                                                           False, True]
    np.testing.assert_allclose(
        tco.translate_points(_t(xy), 0.5, -1.0).numpy(),
        np.asarray(jco.translate_points(jnp.asarray(xy), 0.5, -1.0)),
        rtol=1e-6)
    np.testing.assert_allclose(
        tco.zoom_points(_t(xy), 1.7).numpy(),
        np.asarray(jco.zoom_points(jnp.asarray(xy), 1.7)), rtol=1e-6)


def test_seeded_labels():
    rng = np.random.default_rng(4)
    truth = rng.uniform(0, 10, (12, 2)).astype(np.float32)
    tv = np.ones(12, bool)
    tv[5] = False
    ids = np.arange(101, 113).astype(np.int32)
    pts = (truth[rng.integers(0, 12, 500)]
           + 0.4 * rng.standard_normal((500, 2))).astype(np.float32)
    valid = rng.random(500) < 0.9
    radius = 0.8
    live = truth[tv]
    d = np.sqrt(((pts[:, None].astype(np.float64) - live[None]) ** 2).sum(-1))
    assert np.abs(d.min(1) / radius - 1).min() > 1e-4
    assert _nn_gap(pts, live) > 1e-4
    a = jseed.seeded_labels(jnp.asarray(pts), jnp.asarray(valid),
                            jnp.asarray(truth), jnp.asarray(tv),
                            jnp.asarray(ids), radius, chunk=128)
    b = tseed.seeded_labels(_t(pts), _t(valid), _t(truth), _t(tv), _t(ids),
                            radius, chunk=128)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    assert int(b[1]) == int(a[1]) and int(b[2]) == int(a[2])
    assert 0 < int(b[1]) < valid.sum()
    assert 105 + 1 not in b[0].tolist()                 # invalid truth 5


def test_random_rotation():
    g = torch.Generator().manual_seed(7)
    rots = [tse3.random_rotation(g) for _ in range(20)]
    for r in rots:
        assert r.dtype == torch.float32
        torch.testing.assert_close(r.T @ r, torch.eye(3), atol=1e-6,
                                   rtol=0)
        assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-6
    again = tse3.random_rotation(torch.Generator().manual_seed(7))
    assert torch.equal(again, rots[0])
    assert not torch.equal(rots[0], rots[1])


def _icp_fixture(seed=5, n=80):
    rng = np.random.default_rng(seed)
    tgt = np.concatenate([rng.uniform(-2, 2, (n, 2)), np.zeros((n, 1))],
                         1).astype(np.float32)
    src = ((tgt - np.float32([0.1, -0.2, 0])) @ _rotz(0.15)).astype(
        np.float32)
    sv = np.ones(n, bool)
    sv[::9] = False
    return src, sv, tgt, np.ones(n, bool)


def _jax_multistart_r0s(k, key, dtype=jnp.float32):
    """icp_multistart's r0s (register/icp.py:232-238), made with its calls."""
    n_z = (k + 1) // 2
    thetas = jnp.arange(n_z, dtype=dtype) * (2.0 * jnp.pi / max(n_z, 1))
    rz = jax.vmap(jse3.rotz)(thetas).astype(dtype)
    rr = jax.vmap(jse3.random_rotation)(
        jax.random.split(key, k - n_z)).astype(dtype)
    return np.asarray(jnp.concatenate([rz, rr], axis=0))


@pytest.mark.parametrize("k", [2, 4, 5])
def test_multistart_fed_jax_rotations(k):
    src, sv, tgt, tv = _icp_fixture()
    cfg = ICPConfig(max_iterations=40, num_starts=k)
    a = jicp.icp_multistart(jnp.asarray(src), jnp.asarray(sv),
                            jnp.asarray(tgt), jnp.asarray(tv), cfg,
                            backend="jnp")
    r0s = _jax_multistart_r0s(k, jax.random.PRNGKey(0))
    b = ticp.icp_best_of(_t(src), _t(sv), _t(tgt), _t(tv), cfg, _t(r0s))
    np.testing.assert_allclose(b.r.numpy(), np.asarray(a.r), atol=1e-5)
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), atol=1e-5)
    # the port's own z-spins equal JAX's; the random ones are rotations
    mine = ticp.multistart_rotations(k, torch.Generator().manual_seed(1),
                                     device="cpu")
    n_z = (k + 1) // 2
    np.testing.assert_allclose(mine[:n_z].numpy(), r0s[:n_z], atol=1e-6)
    eye = torch.eye(3).expand(k, 3, 3)
    torch.testing.assert_close(mine.transpose(1, 2) @ mine, eye, atol=1e-6,
                               rtol=0)


def test_multistart_single_start_is_icp():
    src, sv, tgt, tv = _icp_fixture()
    cfg = ICPConfig(max_iterations=40)
    args = (_t(src), _t(sv), _t(tgt), _t(tv), cfg)
    a, b = ticp.icp_multistart(*args), ticp.icp(*args)
    assert torch.equal(a.r, b.r) and torch.equal(a.t, b.t)


def _jax_ransac_samples(key, iters, w_src, w_tgt):
    """ransac_init's index pairs (register/icp.py:161-167), with its calls."""
    si, tj = [], []
    for k in jax.random.split(key, iters):
        ks, kt = jax.random.split(k)
        si.append(jax.random.choice(ks, len(w_src), (2,),
                                    p=w_src / jnp.sum(w_src)))
        tj.append(jax.random.choice(kt, len(w_tgt), (2,),
                                    p=w_tgt / jnp.sum(w_tgt)))
    return np.asarray(jnp.stack(si)), np.asarray(jnp.stack(tj))


def test_ransac_fed_jax_samples():
    src, sv, tgt, tv = _icp_fixture(seed=6, n=48)
    tv[::7] = False
    iters, thr = 24, 0.1
    args = (jnp.asarray(src), jnp.asarray(sv), jnp.asarray(tgt),
            jnp.asarray(tv))
    r0, t0, best = jicp.ransac_init(*args, thr, iters, backend="jnp")
    si, tj = _jax_ransac_samples(
        jax.random.PRNGKey(0), iters, jnp.asarray(sv, jnp.float32),
        jnp.asarray(tv, jnp.float32))
    assert sv[si].all() and tv[tj].all()
    rs, ts, scores = ticp.ransac_score(_t(src), _t(sv), _t(tgt), _t(tv),
                                       thr, _t(si), _t(tj))
    h = int(torch.argmax(scores))
    np.testing.assert_allclose(rs[h].numpy(), np.asarray(r0), atol=1e-5)
    np.testing.assert_allclose(ts[h].numpy(), np.asarray(t0), atol=1e-5)
    assert float(scores[h]) == float(best) > 0
    # every hypothesis' moved sources keep their inlier decisions clear of
    # the threshold, so the scores do not hang on rounding
    moved = src[None] @ rs.numpy().transpose(0, 2, 1) + ts.numpy()[:, None]
    d = np.sqrt(((moved[:, :, None].astype(np.float64)
                  - tgt[tv][None, None]) ** 2).sum(-1).min(-1))
    assert np.abs(d / thr - 1).min() > 1e-4
    # ICP refined from that start equals JAX's icp_ransac
    cfg = ICPConfig(max_iterations=40, ransac_iters=iters,
                    ransac_inlier_threshold=thr)
    a = jicp.icp_ransac(*args, cfg, backend="jnp")
    b = ticp.icp(_t(src), _t(sv), _t(tgt), _t(tv), cfg, r0=rs[h], t0=ts[h])
    np.testing.assert_allclose(b.r.numpy(), np.asarray(a.r), atol=1e-5)
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), atol=1e-5)


def test_ransac_sampling_with_replacement():
    sv = torch.zeros(40, dtype=torch.bool)
    sv[[3, 17, 30]] = True
    tv = torch.ones(5, dtype=torch.bool)
    tv[0] = False
    si, tj = ticp.ransac_sample(sv, tv, 500, torch.Generator().manual_seed(0))
    assert si.shape == tj.shape == (500, 2)
    assert set(si.flatten().tolist()) == {3, 17, 30}
    assert set(tj.flatten().tolist()) == {1, 2, 3, 4}
    assert bool((si[:, 0] == si[:, 1]).any())          # with replacement
    again = ticp.ransac_sample(sv, tv, 500, torch.Generator().manual_seed(0))
    assert torch.equal(si, again[0]) and torch.equal(tj, again[1])


def test_icp_ransac_runs_from_its_own_samples():
    src, sv, tgt, tv = _icp_fixture(seed=8, n=40)
    cfg = ICPConfig(max_iterations=40, ransac_iters=32,
                    ransac_inlier_threshold=0.05)
    out = ticp.icp_ransac(_t(src), _t(sv), _t(tgt), _t(tv), cfg,
                          torch.Generator().manual_seed(3))
    r = out.r.numpy()
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-5)
    assert math.isfinite(float(out.error))
