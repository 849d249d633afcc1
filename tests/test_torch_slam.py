"""PyTorch port vs the JAX package: SLAM (slam/trajectory.py,
slam/scan2map.py) and the SO(3) maps it builds on, plus the tier-4 inputs
of tools/tier4_inputs.py.

The pipelines run in float64 on both sides, at the sizes of
tests/test_slam.py; each JAX answer is computed once per module. The JAX
ICP takes the jnp NN (the |a|^2 - 2ab + |b|^2 expansion) and the port
direct differences; in float64 both pick the same neighbours.

Tolerances:
- so3_exp / so3_log / so3_hat / to_matrix4 and their forward-mode
  Jacobians: atol 1e-12 in float64, 1e-6 in float32;
- loop_closure_mask: bit-equal, with a pair 1 ulp inside the radius;
- odometry, pose graph, BA and scan-to-map poses: atol 1e-9 (the grid-ICP
  precedent of chip_smoke.py), closure pairs, landmark counts and map masks
  equal;
- checkpointed kill/resume: bit-equal to the port's uninterrupted run, 1e-9
  to JAX's.
"""
import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.func import jacfwd

from tests.test_slam import make_loop_trajectory, make_scans
from vtkcloudpoint_tpu.config import ICPConfig as JICP
from vtkcloudpoint_tpu.ops import se3 as jse3
from vtkcloudpoint_tpu.slam import scan2map as js2m
from vtkcloudpoint_tpu.slam import trajectory as jtr
from vtkcloudpoint_tpu_torch.config import ICPConfig
from vtkcloudpoint_tpu_torch.ops import se3
from vtkcloudpoint_tpu_torch.slam import scan2map as ts2m
from vtkcloudpoint_tpu_torch.slam import trajectory as ttr

POSE_TOL = 1e-9


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close_traj(b, a, tol=POSE_TOL):
    np.testing.assert_allclose(b.r.numpy(), np.asarray(a.r), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(b.t.numpy(), np.asarray(a.t), rtol=0,
                               atol=tol)


# ---- SO(3) ----

def _rotvecs(dtype):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((6, 3))
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * rng.uniform(
        0.01, 3.0, (6, 1))
    small = np.array([[1e-9, -2e-9, 1e-9], [0.0, 0.0, 0.0],
                      [3e-7, 0.0, -1e-7]])
    return np.concatenate([w, small]).astype(dtype)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_so3_maps_match_jax(dtype, tol):
    for w in _rotvecs(dtype):
        ra = jse3.so3_exp(jnp.asarray(w))
        rb = se3.so3_exp(_t(w))
        np.testing.assert_allclose(rb.numpy(), np.asarray(ra), atol=tol)
        np.testing.assert_allclose(se3.so3_log(rb).numpy(),
                                   np.asarray(jse3.so3_log(ra)), atol=tol)
        np.testing.assert_allclose(se3.so3_hat(_t(w)).numpy(),
                                   np.asarray(jse3.so3_hat(jnp.asarray(w))),
                                   atol=0)
    r, t = np.asarray(jse3.so3_exp(jnp.asarray(_rotvecs(dtype)[0]))), \
        np.arange(3, dtype=dtype)
    np.testing.assert_array_equal(
        se3.to_matrix4(_t(r), _t(t)).numpy(),
        np.asarray(jse3.to_matrix4(jnp.asarray(r), jnp.asarray(t))))


@pytest.mark.parametrize("scale", [0.0, 1e-8, 1e-3, 0.7])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-6)])
def test_so3_jacobians_match_jax(scale, dtype, tol):
    """Forward-mode Jacobians at 0, inside the Taylor region, and outside
    it: finite, and equal to jax.jacfwd (the double-where guards)."""
    w = (scale * np.array([0.6, -0.3, 0.74])).astype(dtype)
    ja = np.asarray(jax.jacfwd(jse3.so3_exp)(jnp.asarray(w)))
    jb = jacfwd(se3.so3_exp)(_t(w)).numpy()
    assert np.isfinite(jb).all()
    np.testing.assert_allclose(jb, ja, atol=tol)
    r = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    la = np.asarray(jax.jacfwd(jse3.so3_log)(jnp.asarray(r)))
    lb = jacfwd(se3.so3_log)(_t(r)).numpy()
    assert np.isfinite(lb).all()
    np.testing.assert_allclose(lb, la, atol=tol)


# ---- loop-closure mask ----

def _one_ulp_inside(r, dtype):
    """(dx, dy, bound): a step whose squared length fl(fl(dx^2) + fl(dy^2))
    is one ulp under the radius test's bound fl(r * r) in ``dtype`` (r
    rounded to dtype first)."""
    rr = dtype(r) * dtype(r)
    target = np.nextafter(rr, dtype(0))
    dx = dtype(np.sqrt(np.float64(target)))
    while dtype(dx * dx) > target:
        dx = np.nextafter(dx, dtype(0))
    dy = dtype(np.sqrt(np.float64(target) - np.float64(dtype(dx * dx))))
    for _ in range(1000):
        d = dtype(dtype(dx * dx) + dtype(dy * dy))
        if d == target:
            return dx, dy, rr
        dy = np.nextafter(dy, dtype(np.inf) if d < target else dtype(0))
    raise AssertionError("no step one ulp inside")


@pytest.mark.parametrize("dtype,radius", [(np.float32, 3.0),
                                          (np.float32, 0.1),
                                          (np.float64, 0.3)])
def test_loop_closure_mask_one_ulp_inside(dtype, radius):
    """Poses 0 and 6 one ulp inside the radius, poses 1 and 7 exactly at it
    (not inside: the test is strict), 2 and 5 too close in sequence. At
    radius 0.1 the float32 product f32(r) * f32(r) is one ulp above the
    double square rounded to float32, and pair (0, 6) lies at the latter:
    the square must be taken on the device, in float32."""
    dx, dy, rr = _one_ulp_inside(radius, dtype)
    pos = np.zeros((8, 3), dtype)
    pos[:, 1] = 100.0 * np.arange(8)
    pos[6] = [dx, dy, 0]
    pos[7] = pos[1] + [dtype(radius), 0, 0]
    pos[5] = pos[2] + [dx / 2, 0, 0]
    if dtype == np.float32 and radius == 0.1:
        assert not np.nextafter(rr, dtype(0)) < np.float32(radius * radius)
    # JAX traces radius; a float32 scalar makes its square a float32 product
    # as with x64 off
    ja = jtr.loop_closure_mask(jnp.asarray(pos), dtype(radius))
    tb = ttr.loop_closure_mask(_t(pos), radius)
    for x, y in zip(ja, tb):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    li, lj = ttr.detect_loop_closures(ttr.Trajectory(None, _t(pos)), radius)
    assert list(zip(li.tolist(), lj.tolist())) == [(0, 6)]


# ---- pipelines (float64), JAX answers once per module ----

def _ba_scans(rng, s=24, n=600, n_marks=10):
    """tests/test_slam.py::test_slam_pipeline_ba_refines's scans."""
    r_true, t_true = make_loop_trajectory(s, rng, step=0.5)
    marks = rng.uniform(-6, 6, size=(n_marks, 3)) * np.array([1, 1, 0.2])
    per = (2 * n // 3) // n_marks
    blob = (marks[:, None, :]
            + 0.05 * rng.standard_normal((n_marks, per, 3))).reshape(-1, 3)
    bg = rng.uniform(-6, 6, size=(n - len(blob), 3)) * np.array([1, 1, 0.2])
    world = np.concatenate([blob, bg])
    scans = np.stack([(world - t_true[k]) @ r_true[k]
                      + 0.01 * rng.standard_normal((n, 3))
                      for k in range(s)])
    return scans, np.ones((s, n), bool)


BA_KW = dict(loop_radius=1e-3, gn_iterations=6, landmark_eps=0.3,
             landmark_min_pts=8, max_clusters_per_scan=24, ba_iterations=6)
S2M_KW = dict(voxel_size=0.05, map_capacity=4096)


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(0)
    out = {"odo": make_scans(6, 120, rng)[0],
           "slam": make_scans(8, 100, rng)[0],
           "s2m": make_scans(6, 150, rng)[0],
           "ba": _ba_scans(rng)[0]}
    return out


@pytest.fixture(scope="module")
def jax_answers(cases, tmp_path_factory):
    def jv(x):
        return jnp.asarray(x), jnp.ones(x.shape[:2], bool)

    cfg = JICP(tol=1e-14)
    res = {"odo": jtr.odometry_chain(*jv(cases["odo"]), cfg),
           "slam": jtr.slam_pipeline(*jv(cases["slam"]), cfg,
                                     loop_radius=10.0, gn_iterations=5),
           "ba": jtr.slam_pipeline_ba(*jv(cases["ba"]),
                                      JICP(max_iterations=25, tol=1e-10),
                                      **BA_KW)}
    for nn in ("brute", "grid"):
        res["s2m_" + nn] = js2m.scan_to_map(*jv(cases["s2m"]), cfg, nn=nn,
                                            grid_fallback_cap=150, **S2M_KW)
    d = tmp_path_factory.mktemp("jax_ckpt")
    res["ckpt_dir"] = str(d / "part")
    assert jtr.slam_pipeline_checkpointed(
        *jv(cases["slam"]), res["ckpt_dir"], icp_cfg=cfg, every=3,
        loop_radius=10.0, gn_iterations=5, max_chunks=1) is None
    return res


def _tv(x):
    return _t(x), torch.ones(x.shape[:2], dtype=torch.bool)


def test_odometry_chain_matches_jax(cases, jax_answers):
    (ra, ta), traj_a = jax_answers["odo"]
    (rb, tb), traj_b = ttr.odometry_chain(*_tv(cases["odo"]),
                                          ICPConfig(tol=1e-14))
    _close_traj(traj_b, traj_a)
    np.testing.assert_allclose(rb.numpy(), np.asarray(ra), atol=POSE_TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(ta), atol=POSE_TOL)


def test_slam_pipeline_matches_jax(cases, jax_answers):
    opt_a, odo_a, cost_a = jax_answers["slam"]
    opt_b, odo_b, cost_b = ttr.slam_pipeline(
        *_tv(cases["slam"]), ICPConfig(tol=1e-14), loop_radius=10.0,
        gn_iterations=5)
    _close_traj(odo_b, odo_a)
    _close_traj(opt_b, opt_a)
    assert float(cost_b) < 1e-18 and float(cost_a) < 1e-18


def test_slam_pipeline_ba_matches_jax(cases, jax_answers):
    ba_a, pg_a, odo_a, st_a = jax_answers["ba"]
    stages = []
    ba_b, pg_b, odo_b, st_b = ttr.slam_pipeline_ba(
        *_tv(cases["ba"]), ICPConfig(max_iterations=25, tol=1e-10),
        timer=lambda name: stages.append(name) or contextlib.nullcontext(),
        **BA_KW)
    assert stages == ["odometry", "closures", "posegraph", "observations",
                      "ba"]
    for b, a in ((odo_b, odo_a), (pg_b, pg_a), (ba_b, ba_a)):
        _close_traj(b, a)
    assert int(st_b["n_landmarks"]) == int(st_a["n_landmarks"]) >= 5
    np.testing.assert_allclose(float(st_b["ba_cost"]), float(st_a["ba_cost"]),
                               rtol=1e-9)
    np.testing.assert_allclose(float(st_b["graph_cost"]),
                               float(st_a["graph_cost"]), atol=1e-20)


@pytest.mark.parametrize("nn", ["brute", "grid"])
def test_scan_to_map_matches_jax(cases, jax_answers, nn):
    traj_a, map_a, err_a = jax_answers["s2m_" + nn]
    traj_b, map_b, err_b = ts2m.scan_to_map(
        *_tv(cases["s2m"]), ICPConfig(tol=1e-14), nn=nn,
        grid_fallback_cap=150, **S2M_KW)
    _close_traj(traj_b, traj_a)
    np.testing.assert_array_equal(map_b.mask.numpy(), np.asarray(map_a.mask))
    np.testing.assert_allclose(map_b.points.numpy(), np.asarray(map_a.points),
                               atol=POSE_TOL)
    np.testing.assert_allclose(err_b.numpy(), np.asarray(err_a), rtol=1e-6,
                               atol=1e-12)


def test_scan_to_map_auto_follows_jax_off_tpu():
    """nn="auto" takes the grid above 8,192 map slots on every device, the
    JAX package's rule off a TPU."""
    import inspect

    assert ts2m.GRID_ABOVE == 8192
    assert "262144 if on_tpu else 8192" in inspect.getsource(js2m.scan_to_map)
    with pytest.raises(ValueError, match="nn"):
        ts2m.scan_to_map(*_tv(np.zeros((2, 4, 3))), nn="kd")


def test_checkpoint_kill_resume(cases, jax_answers, tmp_path):
    """Killed after one chunk (3 of 7 pairs) and resumed: bit-equal to the
    port's uninterrupted run and 1e-9 from JAX's. A run resumed from the
    JAX package's checkpoint equals it too, and the JAX package restores
    the port's checkpoint."""
    from vtkcloudpoint_tpu.utils.checkpoint import CheckpointManager as JCM

    kw = dict(icp_cfg=ICPConfig(tol=1e-14), every=3, loop_radius=10.0,
              gn_iterations=5)
    scans, valid = _tv(cases["slam"])
    full = ttr.slam_pipeline_checkpointed(scans, valid, str(tmp_path / "a"),
                                          **kw)
    assert ttr.slam_pipeline_checkpointed(
        scans, valid, str(tmp_path / "b"), max_chunks=1, **kw) is None
    resumed = ttr.slam_pipeline_checkpointed(scans, valid,
                                             str(tmp_path / "b"), **kw)
    for x, y in zip(resumed[:2], full[:2]):
        assert torch.equal(x.r, y.r) and torch.equal(x.t, y.t)
    opt_a, odo_a, _ = jax_answers["slam"]
    _close_traj(full[0], opt_a)
    _close_traj(full[1], odo_a)

    from_jax = ttr.slam_pipeline_checkpointed(scans, valid,
                                              jax_answers["ckpt_dir"], **kw)
    _close_traj(from_jax[0], opt_a)
    tmpl = (np.zeros((7, 3, 3)), np.zeros((7, 3)), np.int32(0))
    (rr, tr_, done), step = JCM(str(tmp_path / "a")).restore_latest(tmpl)
    assert step == int(done) == 7
    (rb, tb), _ = ttr.odometry_chain(scans, valid, kw["icp_cfg"])
    np.testing.assert_array_equal(rr, rb.numpy())
    np.testing.assert_array_equal(tr_, tb.numpy())


def test_sharded_ba_raises_naming_item_7():
    with pytest.raises(NotImplementedError, match="item 7"):
        ttr.slam_pipeline_ba(*_tv(np.zeros((2, 4, 3))), mesh=object())


# ---- tier-4 inputs ----

def test_tier4_rotation_pinned_to_jax():
    """tools/tier4_inputs.py pins XLA's float32 cos and sin of
    f32(2 pi / 100) -- the benchmark's se3.rotz with x64 off -- and its
    scans equal the benchmark's bit for bit (built here with JAX's
    rotation)."""
    from tools.tier4_inputs import ROTZ_COS32, ROTZ_SIN32, rotz32, \
        tier4_scans

    rz = np.asarray(jse3.rotz(jnp.float32(2 * np.pi / 100)))
    assert rz.dtype == np.float32
    np.testing.assert_array_equal(rz.view(np.uint32),
                                  rotz32().view(np.uint32))
    assert rz[0, 0] == ROTZ_COS32 and rz[1, 0] == ROTZ_SIN32
    mine = tier4_scans()
    theirs = tier4_scans(rot=rz)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    assert mine[0].dtype == np.float32 and mine[0].shape == (100, 2048, 3)
