"""PyTorch port vs the JAX package: the tier-2 job end to end on the CPU.

cluster_scan in both partition modes and both quirk settings, then ICP of
the centres onto the truth points. Labels, n_clusters and counts bit-equal;
centres and radii rtol 2e-5; ICP R and t atol 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import bench
from vtkcloudpoint_tpu.cluster import pipeline as jp
from vtkcloudpoint_tpu.config import ClusterConfig, EngineConfig, ICPConfig
from vtkcloudpoint_tpu.register.icp import icp as jicp
from vtkcloudpoint_tpu_torch.cluster import pipeline as tp
from vtkcloudpoint_tpu_torch.convert import from_numpy, to_numpy
from vtkcloudpoint_tpu_torch.register.icp import icp as ticp

from tests.conftest import make_blobs

INT_FIELDS = ("label", "n_clusters", "count", "block_overflow",
              "noise_overflow")
FLOAT_FIELDS = ("center3d", "center2d", "radius3d", "radius2d")


def _compare(a, b):
    """ClusterResult of JAX vs the port's, field by field, as numpy."""
    a, b = to_numpy(a), to_numpy(b)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      getattr(b, f), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(b, f), np.asarray(getattr(a, f)),
                                   rtol=2e-5, atol=1e-6, err_msg=f)


def _both(xyz, motor, valid, cfg, **kw):
    a = jp.cluster_scan(jnp.asarray(xyz), jnp.asarray(motor),
                        jnp.asarray(valid), cfg, backend="jnp", **kw)
    b = tp.cluster_scan(*from_numpy((xyz, motor, valid), "cpu"), cfg, **kw)
    return a, b


def _blob_scan():
    """The fixture of tests/test_pallas_dbscan.py::test_backend_dispatch_
    pipeline."""
    rng = np.random.default_rng(0)
    pts = make_blobs(rng, n_clusters=4, pts_per=40, noise=30,
                     spread=0.012).astype(np.float32)
    n = len(pts)
    xyz = np.concatenate([pts, np.zeros((n, 1), np.float32)], 1)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.06, min_pts=6,
                                             block_capacity=128))
    return xyz, pts, np.ones(n, bool), cfg


BLOB_KW = dict(max_blocks=8, max_clusters=64, cluster_capacity=128,
               noise_capacity=128, max_hull=16)


@pytest.mark.parametrize("mode", ["reference", "balanced"])
@pytest.mark.parametrize("quirks", [True, False])
def test_cluster_scan_blobs(mode, quirks):
    xyz, motor, valid, cfg = _blob_scan()
    a, b = _both(xyz, motor, valid, cfg, mode=mode, quirks=quirks,
                 **BLOB_KW)
    _compare(a, b)
    assert int(b.n_clusters) > 0


@pytest.mark.parametrize("mode,quirks", [("balanced", False),
                                         ("reference", True)])
def test_bench_cloud_and_icp(mode, quirks):
    """bench.synthetic_cloud cut to 20k points (eps scaled with the lower
    density), block capacity 256, then ICP of the centres."""
    n = 20_000
    motor, xyz, truth = bench.synthetic_cloud(n)
    valid = np.ones(n, bool)
    cfg = EngineConfig(cluster=ClusterConfig(
        eps=0.02, min_pts=bench.MIN_PTS, block_capacity=256,
        pts_in_cell=256))
    a, b = _both(xyz, motor, valid, cfg, mode=mode, quirks=quirks,
                 max_blocks=120, noise_capacity=4096, max_clusters=1024,
                 cluster_capacity=256, max_hull=32)
    _compare(a, b)
    if mode == "balanced":   # equal-count blocks cannot overflow
        assert int(b.block_overflow) == 0 and int(b.noise_overflow) == 0
    tv = np.ones(len(truth), bool)
    icfg = ICPConfig(max_iterations=50)
    ra = jicp(a.center3d, a.count > 0, jnp.asarray(truth), jnp.asarray(tv),
              icfg, backend="jnp")
    rb = to_numpy(ticp(b.center3d, b.count > 0,
                       *from_numpy((truth, tv), "cpu"), icfg))
    np.testing.assert_allclose(rb.r, np.asarray(ra.r), atol=1e-5)
    np.testing.assert_allclose(rb.t, np.asarray(ra.t), atol=1e-5)
    assert int(rb.iterations) == int(ra.iterations)


def test_centroid_merge_and_reject():
    xyz, motor, valid, cfg = _blob_scan()
    cfg = cfg.replace(cluster=ClusterConfig(eps=0.06, min_pts=6,
                                            block_capacity=128,
                                            merge_threshold=0.3))
    a, b = _both(xyz, motor, valid, cfg, centroid_merge=True, **BLOB_KW)
    _compare(a, b)
    va, ra = jp.reject_clusters(a, jnp.asarray(valid), 0.02)
    vb, rb = tp.reject_clusters(b, torch.from_numpy(valid), 0.02)
    np.testing.assert_array_equal(np.asarray(va), vb.numpy())
    np.testing.assert_array_equal(np.asarray(ra), rb.numpy())


def test_single_block_dbscan():
    xyz, motor, valid, cfg = _blob_scan()
    a = jp.single_block_dbscan(jnp.asarray(xyz), jnp.asarray(motor),
                               jnp.asarray(valid), cfg)
    b = tp.single_block_dbscan(torch.from_numpy(xyz), torch.from_numpy(motor),
                               torch.from_numpy(valid), cfg)
    for key in ("label", "n_clusters", "core"):
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy())


def test_halo_merge_not_ported():
    """cluster_scan(halo_merge=True) equals JAX on the blob scan in both
    partition modes. (The name dates from when the port refused the halo
    union; it is kept so the test's record stays one.)"""
    xyz, motor, valid, cfg = _blob_scan()
    for mode in ("reference", "balanced"):
        a, b = _both(xyz, motor, valid, cfg, mode=mode, halo_merge=True,
                     **BLOB_KW)
        _compare(a, b)


@pytest.mark.parametrize("halo_cap", [64, 8])
def test_halo_merge_unifies_split_cluster(halo_cap):
    """The split stripe of tests/test_halo_fusion.py through cluster_scan:
    the halo union merges the stripe's block pieces as JAX does."""
    from tests.test_halo_fusion import split_cluster_scene

    pts = split_cluster_scene(np.random.default_rng(0)).astype(np.float32)
    n = len(pts)
    xyz = np.concatenate([pts, np.zeros((n, 1), np.float32)], 1)
    cfg = EngineConfig(cluster=ClusterConfig(eps=0.08, min_pts=6,
                                             block_capacity=128))
    kw = dict(mode="balanced", max_blocks=4, quirks=False,
              noise_capacity=512, max_clusters=64, cluster_capacity=512,
              max_hull=16)
    a, b = _both(xyz, pts, np.ones(n, bool), cfg, halo_merge=True,
                 halo_cap=halo_cap, **kw)
    _compare(a, b)
    plain = tp.cluster_scan(
        *from_numpy((xyz, pts, np.ones(n, bool)), "cpu"), cfg, **kw)
    # 8 halo slots per block hold too few boundary points to link a piece
    if halo_cap == 64:
        assert int(b.n_clusters) < int(plain.n_clusters)
