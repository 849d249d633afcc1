"""PyTorch port vs the JAX package: the Engine workflow end to end on the
CPU, on the scan_folder fixture of tests/test_engine.py with the
configuration of its test_full_workflow.

- import: names and count equal;
- cluster: labels and n_clusters bit-equal; centres and radii rtol 2e-5;
- reject: masks equal at two thresholds chosen away from every radius;
- register (coarse): R and t atol 1e-5; iterations equal to JAX's icp on
  its Pallas NN (the jnp NN's expansion rounding can cost it one more);
- match: n_matched equal, rmse rtol 1e-4;
- exports: the centroid and cluster-point files equal line by line;
- the fixed-point workflow and examples/demo_torch.py against the JAX
  package's Engine on the same session.
"""
import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_engine import scan_folder  # noqa: F401  (fixture)
from vtkcloudpoint_tpu.config import (ClusterConfig, EngineConfig,
                                      FilterConfig, ICPConfig, ImportConfig)
from vtkcloudpoint_tpu.engine import Engine as JEngine
from vtkcloudpoint_tpu.register import icp as jicp
from vtkcloudpoint_tpu.workflows import fixed_points as jfp
from vtkcloudpoint_tpu_torch.engine import Engine as TEngine
from vtkcloudpoint_tpu_torch.workflows import fixed_points as tfp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = EngineConfig(
    imports=ImportConfig(dedup=True),
    cluster=ClusterConfig(eps=0.08, min_pts=8, pts_in_cell=64),
    icp=ICPConfig(max_iterations=60, match_distance=1.0),
)
CAPS = dict(max_clusters=128, cluster_capacity=128, max_blocks=128)
# tests of what follows clustering keep the hull small: the plain shapes
# version scans every C(max_hull, 3) MEC candidate
SMALL_HULL = dict(CAPS, max_hull=16)


@pytest.fixture(autouse=True)
def one_thread():
    """Run on one torch thread: under parallel test workers, torch's thread
    pool oversubscribes the cores and each of the workflow's many small ops
    waits on its barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _split_thresholds(radii):
    """Two thresholds, each in the widest gap between sorted radii in the
    lower and the upper half."""
    r = np.sort(radii)
    out = []
    for lo, hi in ((0, len(r) // 2), (len(r) // 2, len(r) - 1)):
        gaps = np.diff(r[lo:hi + 1])
        i = lo + int(np.argmax(gaps))
        out.append(float((r[i] + r[i + 1]) / 2))
    return out


@pytest.fixture
def both(scan_folder):  # noqa: F811
    folder, _ = scan_folder
    ja, tb = JEngine(CFG), TEngine(CFG, device="cpu")
    (a, na), (b, nb) = ja.import_folder(folder), tb.import_folder(folder)
    return ja, tb, a, b, na, nb, folder


def test_import_and_filter(both):
    ja, tb, a, b, na, nb, _ = both
    assert nb == na == ["scan0"]
    assert int(b.count) == int(a.count) == 360
    assert tb.export_bit == ja.export_bit == 6
    a = ja.filter_by_distance(a, 52.0, 58.0, path_id=0)
    b = tb.filter_by_distance(b, 52.0, 58.0, path_id=0)
    np.testing.assert_array_equal(_np(b.valid), _np(a.valid))
    vis = np.array([False])
    np.testing.assert_array_equal(
        _np(tb.set_file_visibility(b, vis).valid),
        _np(ja.set_file_visibility(a, vis).valid))


def test_full_workflow_matches_jax(both, tmp_path):
    ja, tb, a, b, *_ = both
    a = ja.filter_by_distance(a, 10.0, 100.0)
    b = tb.filter_by_distance(b, 10.0, 100.0)
    ra, rb = ja.cluster(a, **CAPS), tb.cluster(b, **CAPS)
    np.testing.assert_array_equal(_np(rb.label), _np(ra.label))
    assert int(rb.n_clusters) == int(ra.n_clusters) >= 8
    np.testing.assert_array_equal(_np(rb.count), _np(ra.count))
    for f in ("center3d", "center2d", "radius3d", "radius2d"):
        np.testing.assert_allclose(_np(getattr(rb, f)), _np(getattr(ra, f)),
                                   rtol=2e-5, atol=1e-6, err_msg=f)

    nonempty = _np(ra.count) > 0          # the noise row 0 included
    live = nonempty & (np.arange(len(nonempty)) > 0)
    radii = _np(ra.radius3d)
    for thr in _split_thresholds(radii[live]):
        assert np.abs(radii[nonempty] / thr - 1).min() > 1e-3
        ba, ma = ja.reject_by_radius(a, ra, radius=thr)
        bb, mb = tb.reject_by_radius(b, rb, radius=thr)
        np.testing.assert_array_equal(_np(mb), _np(ma))
        np.testing.assert_array_equal(_np(bb.valid), _np(ba.valid))
        assert 0 < int(_np(mb)[live].sum()) < live.sum()

    truth = _np(ra.center3d)[_np(ra.count) > 0]
    rega = ja.register_to_truth(ra, truth, coarse=True)
    regb = tb.register_to_truth(rb, truth, coarse=True)
    np.testing.assert_allclose(_np(regb.r), _np(rega.r), atol=1e-5)
    np.testing.assert_allclose(_np(regb.t), _np(rega.t), atol=1e-5)
    # iterations: the ICP stops when the summed squared NN distance moves
    # by < tol. Here the truth is the centroids themselves, so that sum is
    # ~0 from direct differences (the port, nn_pallas) but ~4e-4 of
    # rounding from the jnp path's |a|^2 - 2ab + |b|^2 at |a| ~ 40, which
    # costs the jnp path one more iteration. Held to JAX's icp on its
    # Pallas NN (interpret mode), the same decisions as the port.
    src, tgt = ja.coarse_align(ra, truth)
    ones = jnp.ones(len(truth), bool)
    pal = jicp.icp(src, jnp.asarray(live), tgt, ones, CFG.icp,
                   backend="pallas")
    np.testing.assert_allclose(_np(regb.r), _np(pal.r), atol=1e-5)
    np.testing.assert_allclose(_np(regb.t), _np(pal.t), atol=1e-5)
    assert int(regb.iterations) == int(pal.iterations)
    assert abs(int(regb.iterations) - int(rega.iterations)) <= 1
    ma, mb = ja.match(ra, truth, rega), tb.match(rb, truth, regb)
    assert int(mb["n_matched"]) == int(ma["n_matched"]) >= 8
    np.testing.assert_allclose(float(mb["rmse"]), float(ma["rmse"]),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(_np(mb["match_idx"]),
                                  _np(ma["match_idx"]))

    for name, fn in (("cen", "export_centroids"),
                     ("pts", "export_cluster_points")):
        pa, pb = tmp_path / f"{name}_jax.txt", tmp_path / f"{name}_port.txt"
        args = (ra,) if name == "cen" else (a, ra)
        getattr(ja, fn)(str(pa), *args, bit=4)
        args = (rb,) if name == "cen" else (b, rb)
        getattr(tb, fn)(str(pb), *args, bit=4)
        la, lb = pa.read_text().splitlines(), pb.read_text().splitlines()
        assert len(lb) == len(la) > 0
        assert lb == la, [i for i, (x, y) in enumerate(zip(la, lb)) if x != y]


def test_scene_exports_and_snapshot(both, tmp_path):
    _, tb, _, b, *_ = both
    res = tb.cluster(b, **SMALL_HULL)
    truth = res.center3d[res.count > 0]
    reg = tb.register_to_truth(res, truth)
    m = tb.match(res, truth, reg)
    _, truth_tmp = tb.coarse_align(res, truth)
    prefix = str(tmp_path / "scene")
    tb.export_scene(prefix, b, res, m, truth_tmp)
    for suffix in ("_points.vtk", "_circles.vtk", "_matches.vtk"):
        assert os.path.getsize(prefix + suffix) > 0
    png = tb.screenshot(str(tmp_path / "shot"), b, res, width=64, height=48)
    assert os.path.getsize(png) > 0
    tb.export_cluster_points(str(tmp_path / "p0.txt"), b, res, path_id=0)
    tb.export_cluster_points(str(tmp_path / "p1.txt"), b, res, path_id=1)
    assert len((tmp_path / "p0.txt").read_text().splitlines()) == 360
    assert (tmp_path / "p1.txt").read_text() == ""


@pytest.mark.parametrize("icp", [
    ICPConfig(max_iterations=60, match_distance=1.0, num_starts=3),
    ICPConfig(max_iterations=60, match_distance=1.0, ransac_iters=16,
              ransac_inlier_threshold=0.2)])
def test_register_variants_run(both, icp):
    """Multi-start and RANSAC through the Engine, from a given generator:
    same generator seed, same result; the result is a rotation."""
    *_, folder = both
    eng = TEngine(CFG.replace(icp=icp), device="cpu")
    b, _ = eng.import_folder(folder)
    res = eng.cluster(b, **SMALL_HULL)
    truth = res.center3d[res.count > 0]
    regs = [eng.register_to_truth(res, truth,
                                  generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(regs[0].r, regs[1].r)
    assert torch.equal(regs[0].t, regs[1].t)
    r = regs[0].r.numpy()
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-5)


def test_engine_refusals():
    for backend in ("pallas", "jnp", "cuda"):
        with pytest.raises(ValueError):
            TEngine(CFG.replace(backend=backend), device="cpu")
    eng = TEngine(CFG, device="cpu")
    assert eng.backend == "torch"
    batch = eng.import_arrays(np.zeros((4, 2), np.float32),
                              np.ones(4, np.float32))
    out, stats = eng.cluster_grid(batch)       # ported: grid DBSCAN
    assert int(out["n_clusters"]) == 0 and int(out["overflow"]) == 0
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.cluster_sharded(batch)


@pytest.mark.parametrize("metric,cell_cap", [("l1_motor", 64),
                                             ("l1_motor", 8),
                                             ("l2_xyz", 64),
                                             ("signed_sum_xy", 64)])
def test_cluster_grid_matches_jax(both, metric, cell_cap):
    """Engine.cluster_grid on the scan_folder session: grid DBSCAN labels,
    core flags, n_clusters and overflow bit-equal, centroid table counts
    equal and centres rtol 2e-5; signed_sum_xy falls back to motor L1 on
    both sides. cell_cap 8 overflows."""
    *_, folder = both
    cfg = CFG.replace(cluster=ClusterConfig(
        eps=0.08 if metric != "l2_xyz" else 0.5, min_pts=8, pts_in_cell=64,
        metric=metric))
    ja, tb = JEngine(cfg), TEngine(cfg, device="cpu")
    (a, _), (b, _) = ja.import_folder(folder), tb.import_folder(folder)
    ao, ast = ja.cluster_grid(a, cell_cap=cell_cap, max_clusters=256)
    bo, bst = tb.cluster_grid(b, cell_cap=cell_cap, max_clusters=256)
    for key in ("label", "core", "n_clusters", "overflow"):
        np.testing.assert_array_equal(_np(ao[key]), _np(bo[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(_np(ast["count"]), _np(bst["count"]))
    np.testing.assert_allclose(_np(bst["center3d"]), _np(ast["center3d"]),
                               rtol=2e-5, atol=1e-5)
    assert int(bo["n_clusters"]) > 0
    assert (cell_cap == 8) == (int(bo["overflow"]) > 0)


def _marker_folder(path, seed):
    rng = np.random.default_rng(seed)
    names = ["A7", "B2", "C9"]
    for i, name in enumerate(names):
        m = rng.uniform(5, 25, 2) + 0.01 * rng.standard_normal((30, 2))
        d = rng.uniform(40, 45, (30, 1))
        rows = np.concatenate([m, d], 1)
        rows[25:] = rows[:5]                   # exact duplicates
        rows[3, 2] = 0.0                       # range-gated
        with open(path / f"{name}.txt", "w") as f:
            for r in rows:
                f.write(f"{r[0]:.6f}\t{r[1]:.6f}\t{r[2]:.6f}\n")
    with open(path / "truth.csv", "w") as f:
        f.write("B2,1.0,2.0,3.0\nZZ 4 5 6\nA7 7 8 9\nbad line\n")
    return names


@pytest.mark.parametrize("collapse", [True, False])
def test_fixed_points_match_jax(tmp_path, collapse):
    names = _marker_folder(tmp_path, 3)
    a = jfp.import_fixed_points(str(tmp_path), collapse_duplicates=collapse)
    b = tfp.import_fixed_points(str(tmp_path), collapse_duplicates=collapse,
                                device="cpu")
    assert b.names == a.names == names
    for f in ("motor", "rng", "mult", "cluster"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    np.testing.assert_allclose(b.xyz, a.xyz, rtol=1e-6, atol=1e-6)
    for weighted in (True, False):
        np.testing.assert_allclose(
            tfp.fixed_point_centroids(b, weighted),
            jfp.fixed_point_centroids(a, weighted), rtol=1e-6, atol=1e-6)
    tn, txyz = tfp.parse_truth_csv(str(tmp_path / "truth.csv"))
    assert (tn, txyz.tolist()) == (
        jfp.parse_truth_csv(str(tmp_path / "truth.csv"))[0],
        jfp.parse_truth_csv(str(tmp_path / "truth.csv"))[1].tolist())
    for got, want in zip(tfp.match_by_name(b.names, tn, txyz),
                         jfp.match_by_name(a.names, tn, txyz)):
        np.testing.assert_array_equal(got, want)
    cb = tfp.fixed_point_centroids(b)
    n = tfp.export_fixed_point_matches(str(tmp_path / "m_port.out"), b, cb,
                                       tn, txyz)
    ca = jfp.fixed_point_centroids(a)
    jfp.export_fixed_point_matches(str(tmp_path / "m_jax.out"), a, ca, tn,
                                   txyz)
    assert n == 2
    assert ((tmp_path / "m_port.out").read_text()
            == (tmp_path / "m_jax.out").read_text())


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_torch_matches_jax_engine(tmp_path, capsys):
    out = _load_example("demo_torch").main(["--device", "cpu", str(tmp_path / "port")])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"scan points: {out['scan_points']}"
    assert printed[1].startswith(f"clusters: {out['n_clusters']} ")

    # the same session through the JAX package's Engine (examples/demo.py)
    folder = tmp_path / "jax"
    folder.mkdir()
    _load_example("demo").make_session(str(folder))
    eng = JEngine(EngineConfig(
        cluster=ClusterConfig(eps=0.12, min_pts=10, pts_in_cell=128),
        filters=FilterConfig(dis_min=10.0, dis_max=100.0),
        icp=ICPConfig(max_iterations=80, match_distance=1.0)))
    batch, _ = eng.import_folder(str(folder))
    batch = eng.filter_by_distance(batch, 10.0, 100.0)
    res = eng.cluster(batch, max_clusters=256, cluster_capacity=256,
                      max_blocks=64)
    batch, _ = eng.reject_by_radius(batch, res, radius=5.0)
    truth = np.asarray(res.center3d)[np.asarray(res.count) > 0]
    reg = eng.register_to_truth(res, truth)
    m = eng.match(res, truth, reg)
    assert out["scan_points"] == int(batch.count)
    assert out["n_clusters"] == int(res.n_clusters) > 0
    assert out["n_matched"] == int(m["n_matched"]) > 0
    assert out["icp_iterations"] == int(reg.iterations)
    np.testing.assert_allclose(out["rmse"], float(m["rmse"]), atol=1e-5)


def test_demo_torch_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load_example("demo_torch").main(["--device", "cuda",
                                          str(tmp_path)])
