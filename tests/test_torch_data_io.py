"""PyTorch port vs the JAX package: coordinate conversion, PointBatch and
scan ingestion on the CPU.

- motor_to_xyz (all 16 xdir/ydir remaps), xyz_to_motor, xyz_to_motor_exact:
  rtol 1e-6, atol 1e-6 (torch's and XLA's trig may differ by an ulp);
- range_gate, distance_window: bit-equal;
- import_scan_arrays / import_scan_folder, with and without dedup, on scans
  with planted exact duplicates: valid, mult, path_id, motor, rng and names
  bit-equal, xyz rtol 1e-6; a capacity below the unique count raises;
- the device dedup (ingest.dedup_rows) against loaders.dedup_exact, case by
  case (-0.0 against 0.0, NaN rows), and the import against the numpy
  route (gate, convert, dedup_exact, select) on the same xyz: bit-equal.
Both packages get the same float32 arrays where the caller passes arrays;
from a folder the JAX package (x64 on under tests/conftest.py) converts in
float64 and the port in float32.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.config import ImportConfig
from vtkcloudpoint_tpu.data import convert as jc
from vtkcloudpoint_tpu.data import pointbatch as jpb
from vtkcloudpoint_tpu.io import ingest as ji
from vtkcloudpoint_tpu_torch.data import convert as tc
from vtkcloudpoint_tpu_torch.data import pointbatch as tpb
from vtkcloudpoint_tpu_torch.io import ingest as ti
from vtkcloudpoint_tpu_torch.io.loaders import dedup_exact

TOL = dict(rtol=1e-6, atol=1e-6)
FIELDS = ("xyz", "motor", "rng", "label", "mult", "valid", "path_id")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _scan(seed, n=300, dup=20):
    """motor f32 [n, 2] in 5..25 deg, ranges f32 in 40..60 m, a few 0 and
    > 1000 readings, and ``dup`` rows repeated exactly."""
    rng = np.random.default_rng(seed)
    motor = rng.uniform(5, 25, (n, 2)).astype(np.float32)
    dist = rng.uniform(40, 60, n).astype(np.float32)
    dist[[3, 50]] = 0.0
    dist[[7, 90]] = 1500.0
    src = rng.choice(n - dup, dup, replace=False)
    motor[n - dup:] = motor[src]
    dist[n - dup:] = dist[src]
    pid = (np.arange(n) % 3).astype(np.int32)
    return motor, dist, pid


@pytest.mark.parametrize("xdir", [1, 2, 3, 4])
@pytest.mark.parametrize("ydir", [1, 2, 3, 4])
def test_motor_to_xyz_remaps(xdir, ydir):
    motor, dist, _ = _scan(xdir * 4 + ydir, n=200, dup=0)
    cfg = ImportConfig(x_angle=1.5, y_angle=-2.0, xdir=xdir, ydir=ydir)
    want = np.asarray(jc.motor_to_xyz(jnp.asarray(motor), jnp.asarray(dist),
                                      cfg))
    got = tc.motor_to_xyz(_t(motor), _t(dist), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("fn", ["xyz_to_motor", "xyz_to_motor_exact"])
def test_inverse_conversions(fn):
    motor, dist, _ = _scan(1, n=200, dup=0)
    cfg = ImportConfig(x_angle=0.5, y_angle=0.25)
    xyz = np.asarray(jc.motor_to_xyz(jnp.asarray(motor), jnp.asarray(dist),
                                     cfg)).astype(np.float32)
    wm, wd = getattr(jc, fn)(jnp.asarray(xyz), cfg)
    gm, gd = getattr(tc, fn)(_t(xyz), cfg)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), **TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    if fn == "xyz_to_motor_exact":   # the true inverse of the default rig
        live = dist > 0
        np.testing.assert_allclose(gm.numpy()[live], motor[live], rtol=1e-4)
        np.testing.assert_allclose(gd.numpy()[live], dist[live], rtol=1e-4)


def test_range_gate_and_distance_window():
    _, dist, _ = _scan(2)
    dist = np.concatenate([dist, np.float32([1000.0, 10.0, 100.0, -1.0])])
    cfg = ImportConfig()
    np.testing.assert_array_equal(
        tc.range_gate(_t(dist), cfg).numpy(),
        np.asarray(jc.range_gate(jnp.asarray(dist), cfg)))
    for lo, hi in ((10.0, 100.0), (45.0, 55.0), (0.0, 1000.0)):
        np.testing.assert_array_equal(
            tc.distance_window(_t(dist), lo, hi).numpy(),
            np.asarray(jc.distance_window(jnp.asarray(dist), lo, hi)))


def _compare_batches(a, b):
    """JAX PointBatch a vs the port's b: every field but xyz bit-equal."""
    assert b.capacity == a.capacity
    for f in FIELDS:
        want = np.asarray(getattr(a, f))
        got = getattr(b, f).numpy()
        if f == "xyz":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("with_pid", [True, False])
def test_import_scan_arrays(dedup, with_pid):
    motor, dist, pid = _scan(3)
    cfg = ImportConfig(dedup=dedup)
    pid = pid if with_pid else None
    a = ji.import_scan_arrays(motor, dist, cfg, path_id=pid)
    b = ti.import_scan_arrays(motor, dist, cfg, path_id=pid, device="cpu")
    _compare_batches(a, b)
    n_in = 300 - 4
    assert int(b.count) == (n_in - 20 if dedup else n_in)
    assert int(b.mult.sum() - (b.capacity - b.count)) == n_in
    assert b.capacity == 1024
    with pytest.raises(ValueError, match="capacity"):
        ti.import_scan_arrays(motor, dist, cfg, capacity=int(b.count) - 1,
                              path_id=pid, device="cpu")


def _dedup_case(case):
    """(motor f32 [n, 2], dist f32 [n], path_id i32 [n]) of a scan, or
    xyz f32 [n, 3] rows for the dedup alone."""
    rng = np.random.default_rng(len(case))
    motor = rng.uniform(5, 25, (200, 2)).astype(np.float32)
    dist = rng.uniform(40, 60, 200).astype(np.float32)
    pid = (np.arange(200) // 50).astype(np.int32)
    if case == "planted":
        dist[[3, 50, 120]] = [0.0, 1500.0, 0.0]
        src = rng.choice(150, 40, replace=False)
        dst = 150 + rng.permutation(50)[:40]
        motor[dst], dist[dst] = motor[src], dist[src]
        motor[[160, 170]], dist[[160, 170]] = motor[3], dist[3]   # gated
    elif case == "all_same":
        motor[:], dist[:] = motor[0], dist[0]
    elif case == "one_row":
        motor, dist, pid = motor[:1], dist[:1], pid[:1]
    elif case == "signed_zero":     # motor x 0.0 / -0.0: y is -0.0 / 0.0
        motor[::2, 0], motor[1::2, 0] = 0.0, -0.0
        motor[:, 1] = np.repeat(motor[:100:2, 1], 4)
        dist[:] = np.repeat(dist[:50], 4)
    elif case == "first_in_later_file":    # rows 0-49 (file 3) recur in
        pid = 3 - pid                        # rows 150-199 (file 0)
        motor[150:], dist[150:] = motor[:50], dist[:50]
    elif case == "nan_rows":
        xyz = rng.integers(0, 3, (300, 3)).astype(np.float32)
        for col in range(3):
            xyz[col::7, col] = np.nan
        xyz[5::11] = np.nan
        return xyz
    return motor, dist, pid


DEDUP_CASES = ("planted", "all_same", "no_duplicates", "one_row",
               "signed_zero", "nan_rows", "first_in_later_file")


@pytest.mark.parametrize("case", DEDUP_CASES)
def test_dedup_rows_matches_dedup_exact(case):
    """dedup_rows gives dedup_exact's rows and multiplicities; the import
    gives the numpy route's batch (the first occurrence's file)."""
    scan = _dedup_case(case)
    if case == "nan_rows":
        xyz = scan
    else:
        motor, dist, pid = scan
        keep = tc.range_gate(_t(dist)).numpy()
        xyz = tc.motor_to_xyz(_t(motor[keep]), _t(dist[keep])).numpy()
    idx, counts = dedup_exact(xyz)
    first, mult = (t.numpy() for t in ti.dedup_rows(_t(xyz)))
    np.testing.assert_array_equal(np.flatnonzero(first), idx)
    np.testing.assert_array_equal(mult[first], counts)
    assert (mult[~first] == 1).all()
    if case == "nan_rows":
        assert len(idx) < len(xyz) and np.isnan(xyz[idx]).any()
        return
    if case == "signed_zero":
        y = xyz[:, 1]
        assert (y == 0).all() and np.signbit(y).any() and len(idx) == 50
    if case == "first_in_later_file":
        assert len(idx) == 150 and (pid[idx][:50] == 3).all()
    b = ti.import_scan_arrays(motor, dist, path_id=pid, device="cpu")
    got = b.to_numpy()
    np.testing.assert_array_equal(got["xyz"], xyz[idx])
    np.testing.assert_array_equal(got["motor"], motor[keep][idx])
    np.testing.assert_array_equal(got["rng"], dist[keep][idx])
    np.testing.assert_array_equal(got["path_id"], pid[keep][idx])
    np.testing.assert_array_equal(got["mult"], counts)
    assert (got["label"] == 0).all() and b.capacity == 1024
    pad = ~b.valid.numpy()
    assert (b.mult.numpy()[pad] == 1).all() and not b.xyz.numpy()[pad].any()


@pytest.mark.parametrize("dedup", [True, False])
def test_import_scan_folder(tmp_path, dedup):
    for i in range(3):
        motor, dist, _ = _scan(10 + i, n=120, dup=10)
        with open(tmp_path / f"scan{i}.txt", "w") as f:
            for m, d in zip(motor, dist):
                f.write(f"{m[0]:.6f}\t{m[1]:.6f}\t{d:.6f}\n")
    cfg = ImportConfig(dedup=dedup)
    a, names_a = ji.import_scan_folder(str(tmp_path), cfg, capacity=2048)
    b, names_b = ti.import_scan_folder(str(tmp_path), cfg, capacity=2048,
                                       device="cpu")
    assert names_b == names_a == ["scan0", "scan1", "scan2"]
    _compare_batches(a, b)
    assert int(b.path_id[b.valid].max()) == 2


def test_pointbatch_methods():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1, 1, (50, 3))
    motor = rng.uniform(0, 1, (50, 2))
    lab = rng.integers(0, 5, 50).astype(np.int32)
    a = jpb.PointBatch.from_arrays(xyz, motor=motor, label=lab, capacity=64)
    b = tpb.PointBatch.from_arrays(xyz, motor=motor, label=lab, capacity=64,
                                   device="cpu")
    _compare_batches(a, b)
    assert b.capacity == 64 and int(b.count) == 50
    assert b.device == torch.device("cpu")

    ea, eb = jpb.PointBatch.empty(16), tpb.PointBatch.empty(16, "cpu")
    _compare_batches(ea, eb)
    assert eb.xyz.dtype == torch.float32 and eb.mult.dtype == torch.int32

    new_lab = np.arange(64, dtype=np.int32)
    new_valid = np.arange(64) % 2 == 0
    a2 = a.with_labels(jnp.asarray(new_lab)).with_valid(
        jnp.asarray(new_valid))
    b2 = b.with_labels(_t(new_lab)).with_valid(_t(new_valid))
    _compare_batches(a2, b2)
    assert b.label.numpy().tolist() == a.label.tolist()     # frozen copy
    with pytest.raises(dataclasses.FrozenInstanceError):
        b.valid = None

    da, db = a2.to_numpy(), b2.to_numpy()
    assert sorted(da) == sorted(db)
    for k in da:
        np.testing.assert_array_equal(db[k], np.asarray(da[k]).astype(
            db[k].dtype))

    ca = jpb.concat([a, a2], capacity=128)
    cb = tpb.concat([b, b2], capacity=128)
    _compare_batches(ca, cb)
    with pytest.raises(ValueError, match="capacity"):
        tpb.PointBatch.from_arrays(xyz, capacity=10, device="cpu")
