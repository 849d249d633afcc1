"""PyTorch port vs the JAX package: cross-block fusion (quirks on and off,
PARITY Q4-Q6), the noise engines and their "auto" choice, and the centroid
merge (Q7). Everything is integer: bit-equal.
"""
import numpy as np
import jax
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
                          ("auto", 24), ("grid", 256)])
def test_merge_blocks(seed, quirks, engine, noise_capacity):
    n, lab, bv, bc, pidx = _blocked(seed)
    if engine == "grid":
        # JAX 0.9's executable cache can hand this jitted merge_blocks a
        # program compiled for the other quirks setting ("supplied 4
        # buffers but compiled program expected 5"); start it clean
        jax.clear_caches()
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
    """noise_engine="grid" equals JAX's grid engine, and a metric without a
    grid form is refused as JAX refuses it. (The name dates from when the
    port refused this engine; it is kept so the test's record stays one.)"""
    n, lab, bv, bc, pidx = _blocked(2)
    args = (n, 0.05, 5)
    a = jf.merge_blocks(jnp.asarray(lab), jnp.asarray(bv), jnp.asarray(bc),
                        jnp.asarray(pidx), *args, noise_engine="grid",
                        noise_cell_cap=8)
    b = tf.merge_blocks(torch.from_numpy(lab), torch.from_numpy(bv),
                        torch.from_numpy(bc), torch.from_numpy(pidx), *args,
                        noise_engine="grid", noise_cell_cap=8)
    for key in OUT_KEYS:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)
    with pytest.raises(ValueError, match="grid form"):
        tf.merge_blocks(torch.from_numpy(lab), torch.from_numpy(bv),
                        torch.from_numpy(bc), torch.from_numpy(pidx), *args,
                        metric="signed_sum_xy", noise_engine="grid")


def _overflowing_noise(seed=0, B=10, cap=1024, blob=100, scatter=200):
    """Block inputs with no block cluster: every valid point is noise. 100
    of them sit inside one eps-cell (spread 0.0004 about the centre of the
    cell [0.5, 0.55)^2 at eps 0.05; a point at the origin fixes the grid),
    the rest are uniform in [0, 1]^2."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([0.525 + 0.0004 * rng.standard_normal((blob, 2)),
                          np.zeros((1, 2)),
                          rng.uniform(0, 1, (scatter, 2))]).astype(np.float32)
    coords = np.zeros((B * cap, 2), np.float32)
    valid = np.zeros(B * cap, bool)
    slots = np.sort(rng.choice(B * cap, len(pts), replace=False))
    coords[slots] = pts
    valid[slots] = True
    pidx = np.full(B * cap, -1, np.int32)
    pidx[slots] = np.arange(len(pts), dtype=np.int32)
    return (len(pts), np.zeros((B, cap), np.int32), valid.reshape(B, cap),
            coords.reshape(B, cap, 2), pidx.reshape(B, cap))


def test_auto_noise_engine_follows_jax_above_dense_max():
    """Above DENSE_MAX slots "auto" is the grid engine (JAX's rule off a
    TPU). With 100 points in one cell and noise_cell_cap 32 the grid
    overflows and, at min_pts 40, finds no core where the dense engines find
    one cluster: the port must give JAX's grid labels, n_total and
    noise_overflow (the cell overflow included)."""
    n, lab, bv, bc, pidx = _overflowing_noise()
    kw = dict(quirks=False, noise_capacity=9000, noise_cell_cap=32)
    a = jf.merge_blocks(jnp.asarray(lab), jnp.asarray(bv), jnp.asarray(bc),
                        jnp.asarray(pidx), n, 0.05, 40, noise_engine="auto",
                        **kw)
    dense = jf.merge_blocks(jnp.asarray(lab), jnp.asarray(bv),
                            jnp.asarray(bc), jnp.asarray(pidx), n, 0.05, 40,
                            noise_engine="dense_chunked", **kw)
    assert int(a["noise_overflow"]) > 0
    assert not np.array_equal(np.asarray(a["label"]),
                              np.asarray(dense["label"]))
    b = tf.merge_blocks(torch.from_numpy(lab), torch.from_numpy(bv),
                        torch.from_numpy(bc), torch.from_numpy(pidx), n,
                        0.05, 40, noise_engine="auto", **kw)
    for key in OUT_KEYS:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)


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
