"""PyTorch port vs the JAX package: block partitioning and segment tables.

Same numpy inputs (float32) into both; integer outputs bit-equal, centres
within rtol 2e-5 (the port sums in float64 then rounds, JAX in float32
chunks).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.cluster import blocks as jb
from vtkcloudpoint_tpu.ops import segment as js
from vtkcloudpoint_tpu_torch.cluster import blocks as tb
from vtkcloudpoint_tpu_torch.ops import segment as ts

from tests.conftest import make_blobs


def _cloud(seed, n_invalid=17):
    rng = np.random.default_rng(seed)
    motor = make_blobs(rng, n_clusters=6, pts_per=60, noise=40,
                       spread=0.02).astype(np.float32)
    n = len(motor)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_invalid, replace=False)] = False
    xyz = np.concatenate([motor, rng.uniform(0, 1, (n, 1))],
                         axis=1).astype(np.float32)
    return motor, xyz, valid


def _eq(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("capacity,max_blocks", [(64, 8), (32, 6)])
def test_partition_gather_sorted(seed, capacity, max_blocks):
    motor, xyz, valid = _cloud(seed)
    for coords in (None, xyz):
        a = jb.partition_gather_sorted(
            jnp.asarray(motor), jnp.asarray(valid), capacity, max_blocks,
            coords=None if coords is None else jnp.asarray(coords))
        b = tb.partition_gather_sorted(
            torch.from_numpy(motor), torch.from_numpy(valid), capacity,
            max_blocks,
            coords=None if coords is None else torch.from_numpy(coords))
        for x, y in zip(a, b):
            _eq(x, y)


def test_partition_overflow_counted():
    motor, _, valid = _cloud(2)
    a = jb.partition_gather_sorted(jnp.asarray(motor), jnp.asarray(valid),
                                   16, 4)
    b = tb.partition_gather_sorted(torch.from_numpy(motor),
                                   torch.from_numpy(valid), 16, 4)
    assert int(b[3][0]) == int(valid.sum()) - 64 > 0
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("seed", [0, 3])
def test_assign_blocks_reference(seed):
    motor, _, valid = _cloud(seed)
    a = jb.assign_blocks_reference(jnp.asarray(motor), jnp.asarray(valid),
                                   50)
    b = tb.assign_blocks_reference(torch.from_numpy(motor),
                                   torch.from_numpy(valid), 50)
    assert set(a) == set(b)
    for key in a:
        _eq(a[key], b[key])


@pytest.mark.parametrize("capacity", [32, 100])
def test_assign_blocks_balanced_and_gather_ordered(capacity):
    motor, xyz, valid = _cloud(4)
    a = jb.assign_blocks_balanced(jnp.asarray(motor), jnp.asarray(valid),
                                  capacity)
    b = tb.assign_blocks_balanced(torch.from_numpy(motor),
                                  torch.from_numpy(valid), capacity)
    for key in ("block", "n_blocks", "order"):
        _eq(a[key], b[key])
    mb = int(b["n_blocks"])
    ga = jb.gather_blocks_ordered(jnp.asarray(xyz), a["order"],
                                  jnp.asarray(valid), mb, capacity)
    gb = tb.gather_blocks_ordered(torch.from_numpy(xyz), b["order"],
                                  torch.from_numpy(valid), mb, capacity)
    for x, y in zip(ga, gb):
        _eq(x, y)


@pytest.mark.parametrize("capacity", [64, 24])
def test_gather_blocks(capacity):
    motor, xyz, valid = _cloud(5)
    part = tb.assign_blocks_reference(torch.from_numpy(motor),
                                      torch.from_numpy(valid), 50)
    nb = int(part["n_blocks"])
    a = jb.gather_blocks(jnp.asarray(xyz), jnp.asarray(part["block"].numpy()),
                         jnp.asarray(valid), nb, capacity)
    b = tb.gather_blocks(torch.from_numpy(xyz), part["block"],
                         torch.from_numpy(valid), nb, capacity)
    for x, y in zip(a, b):
        _eq(x, y)


def _labels(seed, n=500, k=20):
    rng = np.random.default_rng(seed)
    # ids 0..k+2: the top ids fall outside a k-row table and are dropped
    label = rng.integers(0, k + 3, n).astype(np.int32)
    label[rng.random(n) < 0.5] = 3          # one big cluster -> overflow
    valid = rng.random(n) < 0.9
    return label, valid


@pytest.mark.parametrize("capacity", [8, 64])
def test_bucket_by_cluster(capacity):
    label, valid = _labels(0)
    a = js.bucket_by_cluster(jnp.asarray(label), jnp.asarray(valid), 20,
                             capacity)
    b = ts.bucket_by_cluster(torch.from_numpy(label),
                             torch.from_numpy(valid), 20, capacity)
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("capacity", [8, 300])
@pytest.mark.parametrize("as_tuple", [True, False])
def test_bucket_payload_by_cluster(capacity, as_tuple):
    label, valid = _labels(1)
    pay = np.random.default_rng(2).uniform(-1, 1, (len(label), 4)).astype(
        np.float32)
    jp = tuple(jnp.asarray(pay[:, i]) for i in range(4)) if as_tuple \
        else jnp.asarray(pay)
    tp = tuple(torch.from_numpy(pay[:, i].copy()) for i in range(4)) \
        if as_tuple else torch.from_numpy(pay)
    a = js.bucket_payload_by_cluster(jnp.asarray(label), jnp.asarray(valid),
                                     jp, 20, capacity)
    b = ts.bucket_payload_by_cluster(torch.from_numpy(label),
                                     torch.from_numpy(valid), tp, 20,
                                     capacity)
    for x, y in zip(a, b):
        _eq(x, y)


@pytest.mark.parametrize("with_mult", [False, True])
def test_cluster_stats(with_mult):
    motor, xyz, valid = _cloud(6)
    rng = np.random.default_rng(7)
    label = rng.integers(0, 12, len(motor)).astype(np.int32)
    mult = rng.integers(1, 4, len(motor)).astype(np.int32) if with_mult \
        else None
    a = js.cluster_stats(jnp.asarray(xyz), jnp.asarray(motor),
                         jnp.asarray(label), jnp.asarray(valid), 10,
                         mult=None if mult is None else jnp.asarray(mult))
    b = ts.cluster_stats(torch.from_numpy(xyz), torch.from_numpy(motor),
                         torch.from_numpy(label), torch.from_numpy(valid),
                         10,
                         mult=None if mult is None else torch.from_numpy(mult))
    _eq(a["count"], b["count"])
    for key in ("weighted_count", "center3d", "center2d"):
        np.testing.assert_allclose(b[key].numpy(), np.asarray(a[key]),
                                   rtol=2e-5, err_msg=key)


def test_cluster_counts_and_means():
    motor, xyz, valid = _cloud(8)
    label = np.random.default_rng(9).integers(0, 9, len(motor)).astype(
        np.int32)
    _eq(js.cluster_counts(jnp.asarray(label), jnp.asarray(valid), 7),
        ts.cluster_counts(torch.from_numpy(label), torch.from_numpy(valid),
                          7))
    ma, ca = js.cluster_means(jnp.asarray(xyz), jnp.asarray(label),
                              jnp.asarray(valid), 7)
    mb, cb = ts.cluster_means(torch.from_numpy(xyz), torch.from_numpy(label),
                              torch.from_numpy(valid), 7)
    np.testing.assert_allclose(mb.numpy(), np.asarray(ma), rtol=2e-5)
    np.testing.assert_array_equal(cb.numpy(), np.asarray(ca))
