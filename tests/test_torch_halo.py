"""PyTorch port vs the JAX package: the halo union (cluster/halo_fusion.py)
on the scenes of tests/test_halo_fusion.py -- halo_buffers, union_ids,
grid_union_ids, halo_merge_labels, pack_cells and the foreign-cell filter.
Everything is integer or a copy of input coordinates: bit-equal.

The JAX side of halo_buffers runs under jit, as halo_merge_labels runs it:
XLA then divides by shell_eps as a multiplication by its float32
reciprocal, which the port follows (the eager JAX call divides). The CPU
tests use 2^16-entry cell tables where the call takes the size.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_halo_fusion import run_blocked, split_cluster_scene
from vtkcloudpoint_tpu.cluster import grid as jg
from vtkcloudpoint_tpu.cluster import halo_fusion as jh
from vtkcloudpoint_tpu_torch.cluster import halo_fusion as th

BITS = 16


def _scene(kind, seed=0):
    """Blocked inputs of a scene, as numpy: (coords, valid, global labels,
    core, n_total, eps, flat labels)."""
    rng = np.random.default_rng(seed)
    if kind == "split":
        pts = split_cluster_scene(rng)
        eps, cap = 0.08, 128
    else:
        corners = [(0.0, 0.0), (10.0, 0.0), (0.0, 10.0), (10.0, 10.0)]
        pts = np.concatenate([np.array(c) + 0.01 * rng.standard_normal(
            (32, 2)) for c in corners])
        rng.shuffle(pts)
        eps, cap = 0.08, 32
    pts = pts.astype(np.float32)
    db, fused, bc, bv, pidx = run_blocked(pts, eps, 6, cap)
    flat = np.asarray(fused["label"]).astype(np.int32)
    pidx = np.asarray(pidx)
    glab = np.where(pidx >= 0, flat[np.clip(pidx, 0, None)], 0).astype(
        np.int32)
    return (np.asarray(bc, np.float32), np.asarray(bv), glab,
            np.asarray(db["core"]), int(fused["n_total"]), eps, flat)


@partial(jax.jit, static_argnames=("eps", "halo_cap", "bits"))
def _jax_buffers(bc, bv, lab, core, eps, halo_cap, bits):
    return jh.halo_buffers(bc, bv, lab, core, eps, halo_cap,
                           cell_table_bits=bits)


@pytest.mark.parametrize("kind", ["split", "nosplit"])
@pytest.mark.parametrize("halo_cap", [128, 16])
def test_halo_buffers(kind, halo_cap):
    bc, bv, glab, core, _, eps, _ = _scene(kind)
    a = _jax_buffers(*map(jnp.asarray, (bc, bv, glab, core)), eps, halo_cap,
                     BITS)
    b = th.halo_buffers(*map(torch.from_numpy, (bc, bv, glab, core)), eps,
                        halo_cap, cell_table_bits=BITS)
    for x, y, name in zip(a, b, ("hx", "hlab", "hvalid", "overflow")):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), name)
    if kind == "split":
        assert int(b[2].sum()) > 0
        assert (halo_cap == 16) == (int(b[3]) > 0)


@pytest.mark.parametrize("kind", ["split", "nosplit"])
def test_halo_merge_labels(kind):
    bc, bv, glab, core, n_total, eps, flat = _scene(kind)
    a = jh.halo_merge_labels(*map(jnp.asarray, (bc, bv, glab, core)),
                             jnp.int32(n_total), eps, halo_cap=128,
                             max_ids=256)
    b = th.halo_merge_labels(*map(torch.from_numpy, (bc, bv, glab, core)),
                             n_total, eps, halo_cap=128, max_ids=256)
    for key in ("remap", "n_after", "idmap", "halo_overflow"):
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)
    merged = th.apply_halo_merge(torch.from_numpy(flat), b["remap"])
    np.testing.assert_array_equal(
        np.asarray(jh.apply_halo_merge(jnp.asarray(flat), a["remap"])),
        merged.numpy())
    if kind == "split":
        assert int(b["n_after"]) == 3 < n_total
    else:
        assert int(b["n_after"]) == n_total


def _halo_sets(seed):
    """The random halo sets of test_grid_union_ids_matches_pairwise: chains
    of touching mini-clusters (links exactly eps apart) and isolated
    points, random ids."""
    r = np.random.default_rng(seed)
    n = 160
    hx = np.zeros((n, 2), np.float32)
    k, x = 0, 0.0
    while k < n - 8:
        for _ in range(int(r.integers(2, 7))):
            hx[k] = [x, 0.0]
            x += 0.05
            k += 1
        x += 0.2
    hx[k:] = r.uniform(5, 6, size=(n - k, 2)).astype(np.float32)
    hlab = r.integers(1, 40, size=n).astype(np.int32)
    hval = r.random(n) < 0.9
    return hx, hlab, hval


@pytest.mark.parametrize("seed", range(4))
def test_union_ids_and_grid_union_ids(seed):
    hx, hlab, hval = _halo_sets(seed)
    ja = (jnp.asarray(hx), jnp.asarray(hlab), jnp.asarray(hval),
          jnp.int32(40), 0.05, "l1_motor", 64)
    ta = (torch.from_numpy(hx), torch.from_numpy(hlab),
          torch.from_numpy(hval), 40, 0.05, "l1_motor", 64)
    a, b = jh.union_ids(*ja), th.union_ids(*ta)
    for key in ("remap", "n_after", "idmap"):
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)
    ga = jh.grid_union_ids(*ja, cell_cap=32)
    gb = th.grid_union_ids(*ta, cell_cap=32)
    for key in ("remap", "n_after", "idmap", "overflow"):
        np.testing.assert_array_equal(np.asarray(ga[key]), gb[key].numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(b["remap"].numpy(), gb["remap"].numpy())
    assert int(b["n_after"]) < 39


def test_grid_union_ids_overflow_and_seed():
    """A cell_cap that truncates, and a seeded id table (idm_init)."""
    hx, hlab, hval = _halo_sets(5)
    idm = np.arange(64, dtype=np.int32)
    idm[7] = 3
    ja = (jnp.asarray(hx), jnp.asarray(hlab), jnp.asarray(hval),
          jnp.int32(40), 0.05, "l1_motor", 64)
    ta = (torch.from_numpy(hx), torch.from_numpy(hlab),
          torch.from_numpy(hval), 40, 0.05, "l1_motor", 64)
    for cap, init in ((2, None), (32, idm)):
        a = jh.grid_union_ids(*ja, cell_cap=cap, idm_init=None if init is None
                              else jnp.asarray(init))
        b = th.grid_union_ids(*ta, cell_cap=cap, idm_init=None if init is None
                              else torch.from_numpy(init))
        for key in ("remap", "n_after", "idmap", "overflow"):
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          b[key].numpy(), err_msg=key)
    assert int(b["idmap"][7]) <= 3


def test_pack_cells_and_foreign_filter():
    rng = np.random.default_rng(2)
    c = rng.integers(-30, 30, (300, 2)).astype(np.float32) * 0.05 + 0.01
    use = rng.random(300) < 0.8
    p1, p2 = jg._PRIMES[:2], jg._PRIMES2[:2]
    # cells 0.2 of a cell away from every boundary: the eager JAX division
    # and the port's reciprocal multiplication floor alike
    raw1, d1 = jh.cell_hashes(jnp.asarray(c), 0.05, p1)
    traw1, td1 = th.cell_hashes(torch.from_numpy(c), 0.05, p1)
    raw2, d2 = jh.cell_hashes(jnp.asarray(c), 0.05, p2)
    traw2, td2 = th.cell_hashes(torch.from_numpy(c), 0.05, p2)
    np.testing.assert_array_equal(np.asarray(raw1), traw1.numpy())
    np.testing.assert_array_equal(np.asarray(raw2), traw2.numpy())
    assert list(d1) == list(td1) and list(d2) == list(td2)
    for cap in (64, 4096):
        a = jh.pack_cells(raw1, raw2, jnp.asarray(use), cap)
        b = th.pack_cells(traw1, traw2, torch.from_numpy(use), cap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    cells, sel, _ = b
    fa = jh.foreign_cell_filter(raw1[:100], raw2[:100], d1, d2,
                                jnp.asarray(cells.numpy()),
                                jnp.asarray(sel.numpy()), BITS)
    fb = th.foreign_cell_filter(traw1[:100], traw2[:100], td1, td2, cells,
                                sel, BITS)
    np.testing.assert_array_equal(np.asarray(fa), fb.numpy())
    assert 0 < int(fb.sum()) <= 100
