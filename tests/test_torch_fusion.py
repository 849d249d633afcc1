"""PyTorch port vs the JAX package: cross-block fusion (quirks on and off,
PARITY Q4-Q6) and the centroid merge (Q7). Everything is integer: bit-equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.cluster import blocks as jb
from vtkcloudpoint_tpu.cluster import dbscan as jd
from vtkcloudpoint_tpu.cluster import fusion as jf
from vtkcloudpoint_tpu_torch.cluster import fusion as tf

from tests.conftest import make_blobs

OUT_KEYS = ("label", "n_kept", "n_total", "noise_overflow")


def _blocked(seed, capacity=64, max_blocks=10):
    """A cloud split into Morton blocks and clustered per block by the JAX
    package: the inputs merge_blocks takes, as numpy."""
    rng = np.random.default_rng(seed)
    pts = make_blobs(rng, n_clusters=8, pts_per=45, noise=60,
                     spread=0.02).astype(np.float32)
    valid = np.ones(len(pts), bool)
    bc, bv, pidx, _ = jb.partition_gather_sorted(
        jnp.asarray(pts), jnp.asarray(valid), capacity, max_blocks)
    db = jd.dbscan_blocks(bc, bv, 0.05, 5)
    return (len(pts), np.asarray(db["label"]), np.asarray(bv),
            np.asarray(bc), np.asarray(pidx))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("engine,noise_capacity",
                         [("auto", 256), ("dense_chunked", 256),
                          ("auto", 24)])
def test_merge_blocks(seed, quirks, engine, noise_capacity):
    n, lab, bv, bc, pidx = _blocked(seed)
    a = jf.merge_blocks(jnp.asarray(lab), jnp.asarray(bv), jnp.asarray(bc),
                        jnp.asarray(pidx), n, 0.05, 5, quirks=quirks,
                        noise_capacity=noise_capacity, noise_engine=engine)
    b = tf.merge_blocks(torch.from_numpy(lab), torch.from_numpy(bv),
                        torch.from_numpy(bc), torch.from_numpy(pidx), n,
                        0.05, 5, quirks=quirks,
                        noise_capacity=noise_capacity, noise_engine=engine)
    for key in OUT_KEYS:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)
    if noise_capacity == 24:
        assert int(b["noise_overflow"]) > 0


def test_grid_noise_engine_not_ported():
    n, lab, bv, bc, pidx = _blocked(2)
    with pytest.raises(NotImplementedError, match="grid"):
        tf.merge_blocks(torch.from_numpy(lab), torch.from_numpy(bv),
                        torch.from_numpy(bc), torch.from_numpy(pidx), n,
                        0.05, 5, noise_engine="grid")


@pytest.mark.parametrize("quirks", [True, False])
@pytest.mark.parametrize("min_cluster_size", [0, 3])
def test_block_keep_renumber(quirks, min_cluster_size):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 6, (7, 9)).astype(np.int32)
    counts[rng.random((7, 9)) < 0.4] = 0
    a = jf.block_keep_renumber(jnp.asarray(counts), min_cluster_size, quirks)
    b = tf.block_keep_renumber(torch.from_numpy(counts), min_cluster_size,
                               quirks)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert (jf.gid_bound(7, 8, min_cluster_size, quirks)
            == tf.gid_bound(7, 8, min_cluster_size, quirks))


def test_noise_pack_order():
    rng = np.random.default_rng(4)
    lab = rng.integers(0, 5, (6, 16)).astype(np.int32)
    mask = rng.random((6, 16)) < 0.3
    for cap in (8, 200):
        a = jf.noise_pack_order(jnp.asarray(lab), jnp.asarray(mask), cap)
        b = tf.noise_pack_order(torch.from_numpy(lab), torch.from_numpy(mask),
                                cap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_centroid_clusters(seed):
    rng = np.random.default_rng(seed)
    k = 40
    centers = rng.uniform(0, 1, (k + 1, 2)).astype(np.float32)
    # a few near-coincident groups to merge
    centers[5:9] = centers[5] + 0.01 * rng.standard_normal((4, 2))
    centers[20:22] = centers[20] + 0.01 * rng.standard_normal((2, 2))
    centers = centers.astype(np.float32)
    cvalid = rng.random(k + 1) < 0.9
    a = jf.merge_centroid_clusters(jnp.asarray(centers), jnp.asarray(cvalid),
                                   0.1, 2)
    b = tf.merge_centroid_clusters(torch.from_numpy(centers),
                                   torch.from_numpy(cvalid), 0.1, 2)
    np.testing.assert_array_equal(np.asarray(a["remap"]), b["remap"].numpy())
    assert int(a["n_after"]) == int(b["n_after"])
    assert int(b["n_after"]) < int(cvalid[1:].sum())
