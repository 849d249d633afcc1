"""PyTorch port vs the JAX package: the remaining ops and utilities --
ops/voxel.py, ops/linalg.py, ops/polygon.py, utils/checkpoint.py,
utils/resilience.py -- the trace exporter of utils/profiling.py, and the
carry of JAX SLAM state into the port's NamedTuples (convert.from_numpy).

Tolerances:
- voxel_downsample: occupied slots and per-slot counts bit-equal; centroids
  rtol 1e-6 / atol 1e-6 in float32 (JAX sums in float32, the port in
  float64 and rounds once), 1e-12 in float64;
- jacobi_eigh: eigenvalues and eigenvectors atol 1e-12 (float64, the same
  rotation sequence);
- polygon area and centroid atol 1e-12 (float64), the boolean tests equal;
- checkpoints and the resilience copy: equal.
"""
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vtkcloudpoint_tpu.ops import linalg as jl
from vtkcloudpoint_tpu.ops import polygon as jpoly
from vtkcloudpoint_tpu.ops.voxel import voxel_downsample as j_voxel
from vtkcloudpoint_tpu.utils import checkpoint as jck
from vtkcloudpoint_tpu_torch import convert
from vtkcloudpoint_tpu_torch.ops import linalg as tl
from vtkcloudpoint_tpu_torch.ops import polygon as tpoly
from vtkcloudpoint_tpu_torch.ops.voxel import voxel_downsample, voxel_slots
from vtkcloudpoint_tpu_torch.utils import checkpoint as tck
from vtkcloudpoint_tpu_torch.utils import profiling as tprof

ROOT = Path(__file__).resolve().parents[1]


# ---- voxel_downsample ----

def _floor_differs(voxel_size, dtype, rng, n=64):
    """Coordinates next to multiples of the voxel size whose floor(x * r)
    with r the reciprocal in ``dtype`` (XLA's form of the division by a
    static size) differs from the other candidate forms: the division
    x / v in float32; the float32 reciprocal in float64."""
    v = dtype(voxel_size)
    if dtype == np.float32:
        inv = dtype(1.0) / v
        other = lambda x: np.floor(x / v)                      # noqa: E731
    else:
        inv = 1.0 / voxel_size
        inv32 = np.float64(np.float32(1.0) / np.float32(voxel_size))
        other = lambda x: np.floor(x * inv32)                  # noqa: E731
    out = []
    for k in rng.integers(-400, 400, 20000):
        x = dtype(k) * v
        for cand in (x, np.nextafter(x, dtype(-np.inf)),
                     np.nextafter(x, dtype(np.inf))):
            cand = dtype(cand)
            if np.floor(cand * inv) != other(cand):
                out.append(cand)
        if len(out) >= n:
            break
    assert out, "no coordinate tells the reciprocal from the other forms"
    return np.asarray(out, dtype)


def _voxel_case(dtype, voxel_size, table_size, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 5, (600, 3)).astype(dtype)
    tricky = _floor_differs(voxel_size, dtype, rng)
    pts[:len(tricky), 0] = tricky
    pts[len(tricky):2 * len(tricky), 2] = tricky
    valid = rng.random(600) < 0.9
    return pts, valid


def _hold_voxel(pts, valid, voxel_size, table_size, rtol, atol):
    a = j_voxel(jnp.asarray(pts), jnp.asarray(valid), voxel_size, table_size)
    b = voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid),
                         voxel_size, table_size)
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
    assert int(b[2]) == int(a[2])
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), rtol=rtol,
                               atol=atol)
    return b


@pytest.mark.parametrize("dtype,voxel_size,tol", [
    (np.float32, 0.3, 1e-6), (np.float32, 0.1, 1e-6),
    (np.float64, 0.3, 1e-12), (np.float64, 0.7, 1e-12)])
@pytest.mark.parametrize("table_size", [1000, 4096])
def test_voxel_downsample_matches_jax(dtype, voxel_size, tol, table_size):
    """Negative coordinates, a table that is not a power of two, and
    coordinates where the reciprocal multiply floors unlike the division
    (XLA's form of a division by the static voxel size)."""
    pts, valid = _voxel_case(dtype, voxel_size, table_size,
                             int(voxel_size * 10) + table_size)
    out = _hold_voxel(pts, valid, voxel_size, table_size, tol, tol)
    assert 0 < int(out[2]) < table_size


def test_voxel_hash_int32_min():
    """A voxel whose int32 hash is INT32_MIN: jnp.abs leaves it negative,
    and the floor-mod then gives -2^31 mod T (352 at T = 1000), not
    2^31 mod T (648)."""
    pts = np.float32([[-2147483648.0, 0.5, 0.5], [1.5, 2.5, -3.5],
                      [-2147483648.0, 0.25, 0.75]])
    valid = np.ones(3, bool)
    slots = voxel_slots(torch.from_numpy(pts), torch.from_numpy(valid), 1.0,
                        1000)
    assert slots.tolist()[0] == slots.tolist()[2] == (-2**31) % 1000 == 352
    out = _hold_voxel(pts, valid, 1.0, 1000, 1e-6, 1e-6)
    assert bool(out[1][352])


def test_voxel_downsample_invalid_and_empty():
    pts = np.float32([[0.1, 0.1, 0.1], [np.nan, 0.0, 0.0], [0.12, 0.1, 0.1]])
    valid = np.array([True, False, True])
    out = _hold_voxel(pts, valid, 0.5, 257, 1e-6, 1e-6)
    assert int(out[2]) == 1
    none = _hold_voxel(pts, np.zeros(3, bool), 0.5, 257, 0, 0)
    assert int(none[2]) == 0 and not bool(none[0].any())


# ---- linalg ----

@pytest.mark.parametrize("n", [3, 4, 6])
def test_jacobi_eigh_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((n, n))
    a = (a + a.T) / 2
    wa, va = jl.jacobi_eigh(jnp.asarray(a))
    wb, vb = tl.jacobi_eigh(torch.from_numpy(a))
    np.testing.assert_allclose(wb.numpy(), np.asarray(wa), atol=1e-12)
    np.testing.assert_allclose(vb.numpy(), np.asarray(va), atol=1e-12)
    np.testing.assert_allclose(wb.numpy(), np.linalg.eigvalsh(a), atol=1e-10)


def test_linalg_aliases():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 4)) + 4 * np.eye(4)
    b = rng.standard_normal(4)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(tl.solve(ta, tb).numpy(),
                               np.asarray(jl.solve(a, b)), atol=1e-12)
    np.testing.assert_allclose(tl.inv(ta).numpy(), np.asarray(jl.inv(a)),
                               atol=1e-12)
    np.testing.assert_allclose(float(tl.det(ta)), float(jl.det(a)),
                               rtol=1e-12)


# ---- polygon ----

POLYGONS = {
    "square": [[0.0, 0], [1, 0], [1, 1], [0, 1]],
    "concave": [[0.0, 0], [2, 0], [1, 0.5], [2, 2], [0, 2]],
    "cw_pentagon": [[0.0, 0], [0, 2], [1.5, 2.5], [3, 1], [2, -1]],
    "sliver": [[0.0, 0], [1, 0], [2, 0]],
}


@pytest.mark.parametrize("name", sorted(POLYGONS))
@pytest.mark.parametrize("pad", [0, 3])
def test_polygon_ops_match_jax(name, pad):
    v = np.asarray(POLYGONS[name], np.float64)
    m = len(v)
    verts = np.concatenate([v, np.full((pad, 2), 7.0)])
    valid = np.arange(m + pad) < m
    rng = np.random.default_rng(m + pad)
    pts = rng.uniform(-0.5, 3.0, (40, 2))
    jv, jm = jnp.asarray(verts), jnp.asarray(valid)
    tv, tm = torch.from_numpy(verts), torch.from_numpy(valid)
    np.testing.assert_allclose(float(tpoly.polygon_area(tv, tm)),
                               float(jpoly.polygon_area(jv, jm)), atol=1e-12)
    np.testing.assert_allclose(tpoly.polygon_centroid(tv, tm).numpy(),
                               np.asarray(jpoly.polygon_centroid(jv, jm)),
                               atol=1e-12)
    np.testing.assert_array_equal(
        tpoly.point_in_polygon(torch.from_numpy(pts), tv, tm).numpy(),
        np.asarray(jpoly.point_in_polygon(jnp.asarray(pts), jv, jm)))
    assert bool(tpoly.is_convex(tv, tm)) == bool(jpoly.is_convex(jv, jm))
    np.testing.assert_array_equal(tpoly.triangulate_earclip(v),
                                  jpoly.triangulate_earclip(v))


# ---- profiling ----

def test_stopwatch_and_device_trace(tmp_path):
    """The operator's exporter: the Chrome trace, and beside it the spans
    recorded inside it (the port's recorder replaced the Stopwatch)."""
    with tprof.device_trace(str(tmp_path / "tr")) as prof:
        with tprof.span("work"):
            x = tprof.sync(int, torch.arange(1000).sum())
    assert x == 499500
    assert (tmp_path / "tr" / "trace.json").is_file()
    assert len(prof.key_averages()) > 0
    with open(tmp_path / "tr" / "spans.json") as f:
        spans = json.load(f)
    assert [s["name"] for s in spans] == ["work", "sync"]
    assert spans[0]["counters"] == {"host_syncs": 1}


# ---- checkpoint ----

def _trees():
    rng = np.random.default_rng(0)
    from vtkcloudpoint_tpu.slam.trajectory import Trajectory as JT

    return [
        {"b": [np.arange(5, dtype=np.int32), {"c": np.float64(2.5)}],
         "a": rng.standard_normal((4, 3)).astype(np.float32)},
        (rng.standard_normal((2, 3, 3)), rng.standard_normal((2, 3)),
         np.int32(3)),
        [np.ones(2, bool), None, (np.zeros(1),)],
        JT(rng.standard_normal((3, 3, 3)), rng.standard_normal((3, 3))),
    ]


@pytest.mark.parametrize("k", range(4))
def test_checkpoint_files_cross_packages(tmp_path, k):
    """The same .npz keys and leaf order (jax.tree.flatten's: dict keys
    sorted, None no leaf) and the same __treedef__ text: a file written by
    either package restores in the other."""
    tree = _trees()[k]
    ptree = convert.from_numpy(tree, "cpu")
    assert tck.treedef_str(ptree) == str(jax.tree.structure(tree))
    pj = jck.save(str(tmp_path / "j.npz"), tree, step=7)
    pt = tck.save(str(tmp_path / "t.npz"), ptree, step=7)
    with np.load(pj) as fj, np.load(pt) as ft:
        assert sorted(fj.files) == sorted(ft.files)
        for key in fj.files:
            np.testing.assert_array_equal(fj[key], ft[key], err_msg=key)
    back, step = tck.restore(pj, ptree)
    assert step == 7
    for a, b in zip(jax.tree.leaves(tree), tck.flatten(back)):
        assert isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jback, _ = jck.restore(pt, tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(jback)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_checkpoint_manager_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "n": np.int64(4)}
    mgr = tck.CheckpointManager(str(tmp_path / "mgr"), keep=2)
    assert mgr.restore_latest(tree) == (None, None)
    for s in (1, 2, 3):
        mgr.save(s, tree)
    assert mgr.latest_step() == 3
    assert not os.path.exists(tmp_path / "mgr" / "ckpt_1.npz")
    got, s = mgr.restore_latest(tree)
    assert s == 3 and torch.equal(got["a"], tree["a"])
    assert isinstance(got["n"], np.ndarray) and int(got["n"]) == 4
    jmgr = jck.CheckpointManager(str(tmp_path / "mgr"))
    assert jmgr.latest_step() == 3


# ---- resilience: a copy ----

def test_resilience_is_a_copy(tmp_path):
    from vtkcloudpoint_tpu_torch.utils import resilience as tr

    mine = ROOT / "vtkcloudpoint_tpu_torch" / "utils" / "resilience.py"
    original = ROOT / "vtkcloudpoint_tpu" / "utils" / "resilience.py"
    assert mine.read_text() == original.read_text()
    hb = tr.Heartbeat(str(tmp_path / "hb"))
    assert hb.beat("x") == 1
    assert tr.check_heartbeat(str(tmp_path / "hb"), 60.0)[0]
    calls = []

    @tr.retry(attempts=3, backoff=0.0)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("again")
        return len(calls)

    assert flaky() == 3


# ---- SLAM state across packages ----

def test_from_numpy_maps_jax_slam_state_to_port_types():
    from vtkcloudpoint_tpu.slam import ba as jba
    from vtkcloudpoint_tpu.slam import posegraph as jpg
    from vtkcloudpoint_tpu.slam import scan2map as js2m
    from vtkcloudpoint_tpu.slam import trajectory as jtr
    from vtkcloudpoint_tpu_torch.slam import ba as tba
    from vtkcloudpoint_tpu_torch.slam import posegraph as tpg
    from vtkcloudpoint_tpu_torch.slam import scan2map as ts2m
    from vtkcloudpoint_tpu_torch.slam import trajectory as ttr

    e = 3
    graph = jpg.PoseGraph(jnp.arange(e, dtype=jnp.int32),
                          jnp.arange(1, e + 1, dtype=jnp.int32),
                          jnp.tile(jnp.eye(3), (e, 1, 1)),
                          jnp.zeros((e, 3)), jnp.ones(e))
    obs = jba.Observations(jnp.zeros(2, jnp.int32), jnp.ones(2, jnp.int32),
                           jnp.zeros((2, 3)), jnp.ones(2))
    traj = jtr.Trajectory(jnp.tile(jnp.eye(3), (2, 1, 1)), jnp.zeros((2, 3)))
    mp = js2m.MapState(jnp.zeros((4, 3)), jnp.ones(4, bool))
    state = {"graph": graph, "obs": obs, "traj": [traj], "map": mp}
    got = convert.from_numpy(jax.tree.map(np.asarray, state), "cpu")
    assert type(got["graph"]) is tpg.PoseGraph
    assert type(got["obs"]) is tba.Observations
    assert type(got["traj"][0]) is ttr.Trajectory
    assert type(got["map"]) is ts2m.MapState
    assert got["graph"].edge_i.dtype == torch.int32
    np.testing.assert_array_equal(got["graph"].r_meas.numpy(),
                                  np.asarray(graph.r_meas))
    assert got["map"].mask.dtype == torch.bool


# ---- segment sums: exact, so order-free ----

def _exact_sums(vals, ids, n):
    import math

    out = np.zeros((n,) + vals.shape[1:])
    for s in range(n):
        rows = vals[ids == s].astype(np.float64)
        for c in np.ndindex(vals.shape[1:]):
            out[(s,) + c] = math.fsum(rows[(slice(None),) + c])
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_segment_sum_is_exact_and_order_free(dtype):
    """Values spread over 60 binary orders of magnitude, where a float64
    running sum rounds: the sums equal the exact ones within half the
    fixed-point grid a value (2^(e + bits(N - 1) - 62), max|v| < 2^e) and
    float32's rounding, give the same bits for any row order, and are at
    least as close to the exact sums as jax.ops.segment_sum's, element by
    element (JAX's float32 sums lie up to ~2e-6 off here); ids out of range
    are dropped."""
    from vtkcloudpoint_tpu_torch.ops.segment import segment_sum

    rng = np.random.default_rng(11)
    n_rows, n_seg = 3000, 17
    vals = (rng.standard_normal((n_rows, 3))
            * np.exp2(rng.integers(-40, 20, (n_rows, 3)))).astype(dtype)
    ids = rng.integers(-2, n_seg + 2, n_rows)
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), n_seg)
    assert got.dtype == torch.from_numpy(vals).dtype
    keep = (ids >= 0) & (ids < n_seg)
    want = _exact_sums(vals[keep], ids[keep], n_seg)
    grid = 2.0 ** (np.frexp(np.abs(vals).max())[1]
                   + (n_rows - 1).bit_length() - 62)
    scale = grid / 2 * n_rows
    np.testing.assert_allclose(got.double().numpy(), want,
                               rtol=1e-7 if dtype == np.float32 else 0,
                               atol=scale)
    perm = rng.permutation(n_rows)
    again = segment_sum(torch.from_numpy(vals[perm]),
                        torch.from_numpy(ids[perm]), n_seg)
    assert torch.equal(got, again)
    ja = np.asarray(jax.ops.segment_sum(jnp.asarray(vals[keep]),
                                        jnp.asarray(ids[keep]),
                                        num_segments=n_seg), np.float64)
    assert (np.abs(got.double().numpy() - want)
            <= np.abs(ja - want) + scale).all()


def test_segment_sum_non_finite_ints_and_empty():
    from vtkcloudpoint_tpu_torch.ops.segment import segment_sum

    vals = torch.tensor([[1.0, 2.0], [np.nan, 3.0], [4.0, np.inf]])
    got = segment_sum(vals, torch.tensor([0, 0, 1]), 3)
    assert torch.isnan(got[0, 0]) and got[0, 1] == 5.0
    assert got[1, 0] == 4.0 and torch.isinf(got[1, 1])
    assert not got[2].any()
    ints = segment_sum(torch.tensor([3, 4, 5], dtype=torch.int32),
                       torch.tensor([1, 1, 7]), 2)
    assert ints.tolist() == [0, 7] and ints.dtype == torch.int32
    empty = segment_sum(torch.zeros((0, 3)), torch.zeros(0, dtype=torch.long),
                        4)
    assert empty.shape == (4, 3) and not empty.any()
