"""Guards of the PyTorch port: no JAX import, backend policy, launch counts,
the argument checks of the kernel wrappers, and state conversion."""
import dataclasses
import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vtkcloudpoint_tpu import config as jax_config
from vtkcloudpoint_tpu_torch import config as port_config
from vtkcloudpoint_tpu_torch import convert, device
from vtkcloudpoint_tpu_torch.config import (ClusterConfig, EngineConfig,
                                            ICPConfig)
from vtkcloudpoint_tpu_torch.cluster import dbscan as td
from vtkcloudpoint_tpu_torch.cluster.pipeline import ClusterResult, cluster_scan
from vtkcloudpoint_tpu_torch.kernels import build
from vtkcloudpoint_tpu_torch.kernels import dbscan as k_dbscan
from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn
from vtkcloudpoint_tpu_torch.kernels import shapes as k_shapes
from vtkcloudpoint_tpu_torch.ops.geometry import cluster_shapes
from vtkcloudpoint_tpu_torch.register.icp import icp, nn_correspond

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "vtkcloudpoint_tpu_torch"
SLICE_MODULES = sorted(
    "vtkcloudpoint_tpu_torch." + ".".join(p.relative_to(PACKAGE).with_suffix(
        "").parts) for p in PACKAGE.rglob("*.py") if p.name != "__init__.py")


@pytest.fixture
def one_thread():
    """Run on one torch thread: under parallel test workers, torch's thread
    pool oversubscribes the cores and each of the workflow's many small ops
    waits on its barrier."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_slice_modules_present():
    for mod in ("device", "convert", "ops.metrics", "ops.segment",
                "ops.geometry", "ops.se3", "cluster.blocks",
                "cluster.dbscan", "cluster.fusion", "cluster.pipeline",
                "register.icp", "kernels.build", "kernels.dbscan",
                "kernels.shapes", "kernels.neighbor", "data.convert",
                "data.pointbatch", "io.ingest", "register.matching",
                "register.coarse", "cluster.seeded",
                "workflows.fixed_points", "engine", "cluster.grid",
                "cluster.halo_fusion", "register.nn_grid", "ops.voxel",
                "ops.linalg", "ops.polygon", "utils.checkpoint",
                "utils.profiling", "utils.resilience", "slam.posegraph",
                "slam.ba", "slam.trajectory", "slam.scan2map",
                "parallel.mesh", "parallel.distributed", "parallel.sharded",
                "parallel.noise_shard"):
        assert f"vtkcloudpoint_tpu_torch.{mod}" in SLICE_MODULES
    for src in build.SOURCES:
        assert (build.CSRC / src).is_file()


# what runs the port on the card besides the package itself
PORT_SCRIPTS = ("chip_smoke", "tools.engine_session", "tools.tier3_inputs",
                "tools.tier4_inputs", "tools.profile_k1", "tools.profile_k2",
                "tools.sharded_session", "tests.test_torch_sharded")


def test_port_imports_no_jax():
    """Every port module, chip_smoke.py and the tools it drives load
    neither JAX nor any module of the JAX package vtkcloudpoint_tpu (the
    port keeps its own copies of the numpy-only ones)."""
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in SLICE_MODULES + list(
                PORT_SCRIPTS))
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib')) or m == 'vtkcloudpoint_tpu'"
              " or m.startswith('vtkcloudpoint_tpu.'))\n"
            + "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _dataclasses(module):
    return {name: cls for name, cls in vars(module).items()
            if dataclasses.is_dataclass(cls) and isinstance(cls, type)
            and cls.__module__ == module.__name__}


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            value = f.default
        elif f.default_factory is not dataclasses.MISSING:
            value = f.default_factory()
        else:
            value = dataclasses.MISSING
        out[f.name] = (_defaults(type(value))
                       if dataclasses.is_dataclass(value) else value)
    return out


def test_config_copy_matches_jax_package():
    """The port's config.py is a copy of the JAX package's: the same
    dataclasses with the same fields, in the same order, and the same
    defaults (nested ones included)."""
    jax_classes, port_classes = (_dataclasses(jax_config),
                                 _dataclasses(port_config))
    assert sorted(port_classes) == sorted(jax_classes)
    assert "EngineConfig" in port_classes
    for name, cls in jax_classes.items():
        mine = port_classes[name]
        assert ([f.name for f in dataclasses.fields(mine)]
                == [f.name for f in dataclasses.fields(cls)]), name
        assert _defaults(mine) == _defaults(cls), name


def _scan_folder(path):
    rng = np.random.default_rng(3)
    rows = np.concatenate([rng.uniform(5, 25, (20, 2)),
                           rng.uniform(40, 45, (20, 1))], 1)
    with open(path / "a.txt", "w") as f:
        for r in rows:
            f.write(f"{r[0]:.6f}\t{r[1]:.6f}\t{r[2]:.6f}\n")
    return str(path)


def _entry_points(folder):
    """Every entry point that places data on a device, called with the
    given keyword arguments (none: the default device)."""
    from vtkcloudpoint_tpu_torch.data.pointbatch import PointBatch
    from vtkcloudpoint_tpu_torch.engine import Engine
    from vtkcloudpoint_tpu_torch.io.ingest import (import_scan_arrays,
                                                   import_scan_folder)
    from vtkcloudpoint_tpu_torch.register.icp import multistart_rotations
    from vtkcloudpoint_tpu_torch.workflows.fixed_points import (
        import_fixed_points)

    motor = np.zeros((4, 2), np.float32)
    dist = np.full(4, 42.0, np.float32)
    xyz = np.zeros((4, 3), np.float32)
    return {
        "convert.from_numpy": (convert.from_numpy,
                               lambda **kw: convert.from_numpy(
                                   {"a": xyz}, **kw)),
        "import_scan_arrays": (import_scan_arrays,
                               lambda **kw: import_scan_arrays(
                                   motor, dist, **kw)),
        "import_scan_folder": (import_scan_folder,
                               lambda **kw: import_scan_folder(folder, **kw)),
        "PointBatch.empty": (PointBatch.empty,
                             lambda **kw: PointBatch.empty(8, **kw)),
        "PointBatch.from_arrays": (PointBatch.from_arrays,
                                   lambda **kw: PointBatch.from_arrays(
                                       xyz, **kw)),
        "import_fixed_points": (import_fixed_points,
                                lambda **kw: import_fixed_points(
                                    folder, **kw)),
        "multistart_rotations": (multistart_rotations,
                                 lambda **kw: multistart_rotations(
                                     4, torch.Generator().manual_seed(0),
                                     **kw)),
        "Engine": (Engine.__init__, lambda **kw: Engine(EngineConfig(), **kw)),
    }


ENTRY_POINTS = ("convert.from_numpy", "import_scan_arrays",
                "import_scan_folder", "PointBatch.empty",
                "PointBatch.from_arrays", "import_fixed_points",
                "multistart_rotations", "Engine")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name, tmp_path, monkeypatch):
    """Every entry point that places data defaults to device.DEFAULT_DEVICE
    ("cuda"). On a host without CUDA that default raises -- it never
    becomes the CPU quietly -- and device="cpu" runs."""
    fn, call = _entry_points(_scan_folder(tmp_path))[name]
    assert device.DEFAULT_DEVICE == "cuda"
    assert (inspect.signature(fn).parameters["device"].default
            == device.DEFAULT_DEVICE)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    call(device="cpu")


def test_resolve_backend():
    cpu = torch.device("cpu")
    assert device.resolve_backend("auto", cpu) == "torch"
    assert device.resolve_backend("torch", cpu) == "torch"
    assert device.resolve_backend("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="CUDA"):
        device.resolve_backend("cuda", cpu)
    for bad in ("pallas", "jnp", "gpu"):
        with pytest.raises(ValueError, match="auto"):
            device.resolve_backend(bad, cpu)


def test_matmul_precision_is_full_float32():
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _small_inputs():
    rng = np.random.default_rng(0)
    coords = torch.from_numpy(rng.uniform(0, 1, (2, 32, 2)).astype(
        np.float32))
    return coords, torch.ones(2, 32, dtype=torch.bool)


@pytest.mark.parametrize("backend", ["cuda", "pallas", "nope"])
def test_entry_points_refuse_bad_backend_on_cpu(backend):
    coords, valid = _small_inputs()
    with pytest.raises(ValueError):
        td.dbscan_blocks_dispatch(coords, valid, 0.1, 3, backend=backend)
    with pytest.raises(ValueError):
        cluster_shapes(coords, valid, torch.full((2,), 32), max_hull=8,
                       backend=backend)
    with pytest.raises(ValueError):
        nn_correspond(torch.zeros(4, 3), torch.zeros(5, 3),
                      torch.ones(5, dtype=torch.bool), backend=backend)


def test_kernel_wrappers_refuse_cpu_tensors():
    coords, valid = _small_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        k_dbscan.dbscan_blocks_cuda(coords, valid, 0.1, 3)
    with pytest.raises(ValueError, match="CUDA"):
        k_shapes.shapes_cuda(coords, valid, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k_nn.nn_cuda(torch.zeros(4, 3), torch.zeros(5, 3),
                     torch.ones(5, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        k_nn.radius_count_cuda(coords[0], valid[0], 0.1)


def test_cpu_run_launches_no_kernel():
    mods = (k_dbscan, k_shapes, k_nn)
    for m in mods:
        m.launches = 0
    rng = np.random.default_rng(1)
    motor = torch.from_numpy(rng.uniform(0, 1, (400, 2)).astype(np.float32))
    xyz = torch.cat([motor, torch.zeros(400, 1)], dim=1)
    valid = torch.ones(400, dtype=torch.bool)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.05, min_pts=4,
                                             block_capacity=64))
    res = cluster_scan(xyz, motor, valid, cfg, mode="balanced",
                       max_blocks=8, max_clusters=64, cluster_capacity=64,
                       max_hull=8, noise_capacity=256)
    icp(res.center3d, res.count > 0, xyz[:50], valid[:50],
        ICPConfig(max_iterations=5))
    assert int(res.n_clusters) > 0
    assert [m.launches for m in mods] == [0, 0, 0]


def test_cpu_engine_session_launches_no_kernel(one_thread):
    """import -> filter -> cluster -> reject -> register (single start,
    multi-start, RANSAC) -> match -> radius count on CPU tensors: every
    kernel's counter stays 0."""
    from vtkcloudpoint_tpu_torch.engine import Engine

    counters = [(k_dbscan, "launches"), (k_shapes, "launches"),
                (k_nn, "launches"), (k_nn, "radius_launches")]
    for mod, name in counters:
        setattr(mod, name, 0)
    rng = np.random.default_rng(2)
    centers = rng.uniform(5, 25, (6, 2))
    motor = np.concatenate([c + 0.02 * rng.standard_normal((40, 2))
                            for c in centers]).astype(np.float32)
    dist = rng.uniform(40, 45, len(motor)).astype(np.float32)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.08, min_pts=6,
                                             pts_in_cell=64))
    eng = Engine(cfg, device="cpu")
    batch = eng.filter_by_distance(eng.import_arrays(motor, dist), 10.0,
                                   100.0)
    res = eng.cluster(batch, mode="balanced", max_clusters=64,
                      cluster_capacity=64, max_blocks=8, max_hull=16)
    batch, _ = eng.reject_by_radius(batch, res, radius=1.0)
    truth = res.center3d[res.count > 0]
    for icfg in (ICPConfig(max_iterations=10),
                 ICPConfig(max_iterations=10, num_starts=2),
                 ICPConfig(max_iterations=10, ransac_iters=4)):
        reg = Engine(cfg.replace(icp=icfg), device="cpu").register_to_truth(
            res, truth)
        eng.match(res, truth, reg)
    k_nn.radius_count(batch.motor, batch.valid, 0.08)
    assert int(res.n_clusters) > 0
    assert [getattr(mod, name) for mod, name in counters] == [0, 0, 0, 0]


def test_build_is_keyed_by_sources_and_flags():
    path = build.library_path()
    assert path.parent == ROOT / "build" / "kernels"
    assert path.name.startswith("libvtkcp_kernels_")
    assert path == build.library_path()
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.LINK_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
    assert "radius.cu" in build.SOURCES
    assert "vtkcp_radius_count" in build.SIGNATURES


def test_convert_round_trip_keeps_dtypes():
    tree = {"a": np.arange(5, dtype=np.int32),
            "b": (np.ones(3, bool), np.float32([1.5, 2.5])),
            "r": ClusterResult(*([np.zeros(2, np.float32)] * 10)),
            "s": 3}
    t = convert.from_numpy(tree, "cpu")
    assert t["a"].dtype == torch.int32 and t["b"][0].dtype == torch.bool
    assert t["b"][1].dtype == torch.float32
    assert isinstance(t["r"], ClusterResult) and t["s"] == 3
    back = convert.to_numpy(t)
    assert back["a"].dtype == np.int32 and back["b"][0].dtype == bool
    np.testing.assert_array_equal(back["b"][1], tree["b"][1])
    assert isinstance(back["r"], ClusterResult)


def test_multi_device_parts_raise_naming_item_7():
    """The multi-device parts, once raising and naming ROADMAP item 7, run:
    on a one-rank gloo mesh halo_buffers(axis=...) sees no other rank, so
    it equals the single-device buffers."""
    from vtkcloudpoint_tpu_torch.cluster.halo_fusion import halo_buffers
    from vtkcloudpoint_tpu_torch.parallel.distributed import one_rank_group

    coords, valid = _small_inputs()
    labels = torch.ones(2, 32, dtype=torch.int32)
    one = halo_buffers(coords, valid, labels, valid, 0.1, 8,
                       cell_table_bits=10)
    with one_rank_group("cpu") as mesh:
        sharded = halo_buffers(coords, valid, labels, valid, 0.1, 8,
                               axis=mesh, cell_table_bits=10)
    for a, b in zip(one, sharded):
        assert torch.equal(a, b)
    assert one[0].shape == (16, 2) and int(one[3]) >= 0


def test_no_not_implemented_left_but_multi_device():
    """grep NotImplementedError over the port: none is left (the last ones
    were the multi-device entry points of ROADMAP item 7, ported)."""
    hits = sorted({f"{p.relative_to(PACKAGE)}"
                   for p in PACKAGE.rglob("*.py")
                   for line in p.read_text().splitlines()
                   if "NotImplementedError" in line or "item 7" in line})
    assert hits == []


@pytest.mark.parametrize("n,m", [(1024, 450), (12_288, 5_120),
                                 (4_096, 100_000), (1, 5), (300_000, 1_000),
                                 (3, 10_000_000)])
def test_nn_splits_cover_m_in_whole_tiles(n, m):
    """K3's grid on an H100 (132 SMs, 256 queries a block): the splits
    cover every reference once, hold at least one 128-reference tile,
    number at most 65,535, and fill 4 blocks an SM where M allows."""
    target = k_nn.NN_BLOCKS_PER_SM * 132
    splits, split_len = k_nn.nn_splits(n, m, 256, target)
    assert split_len >= k_nn.NN_MIN_SPLIT == 128
    assert (splits - 1) * split_len < m <= splits * split_len
    assert splits <= 65_535
    tiles = -(-n // 256)
    if m >= target * k_nn.NN_MIN_SPLIT:
        assert tiles * splits >= target
    if m <= k_nn.NN_MIN_SPLIT:
        assert splits == 1


def test_kernel_bounds_count_unordered_pairs_at_the_issue_rate():
    """chip_smoke's bound: l1_motor pair tests of nv valid points are
    nv (nv - 1) / 2 unordered pairs at 2 D FP32 instructions, over the
    non-FMA issue rate (half the published 67 TFLOP/s)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    nv = torch.tensor([1024.0, 3.0], dtype=torch.float64)
    instr = chip_smoke.l1_pair_instr(nv, 2)
    assert instr == (1024 * 1023 // 2 + 3) * 4
    assert chip_smoke.FP32_INSTR_PER_S == 33.5e12
    b = chip_smoke.bound(1000, instr)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(instr / 33.5e9)
    assert chip_smoke.bound(10**9, 1)["bound_by"] == "bytes"
