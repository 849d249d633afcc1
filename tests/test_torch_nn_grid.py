"""PyTorch port vs the JAX package: grid-hash nearest neighbour and grid
ICP (register/nn_grid.py) on the fixtures of tests/test_nn_grid.py, plus an
exact tie across two stencil cells.

The JAX side runs under jit, as icp_grid does: XLA then divides by the cell
size as a multiplication by its float32 reciprocal, which the port follows
(the eager JAX build divides). idx, resolved and the overflow counter
bit-equal; d2 rtol 1e-6 (XLA may fuse the squared-difference sum); icp_grid
R and t atol 1e-5, iterations equal.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vtkcloudpoint_tpu.config import ICPConfig
from vtkcloudpoint_tpu.register import nn_grid as jn
from vtkcloudpoint_tpu_torch.register import nn_grid as tn


@partial(jax.jit, static_argnames=("cell", "cell_cap", "fallback_cap"))
def _jax_nn(query, ref, ref_valid, cell, cell_cap, fallback_cap):
    grid = jn.build_nn_grid(ref, ref_valid, cell)
    return grid, jn.nn_grid(grid, query, ref, ref_valid, cell,
                            cell_cap=cell_cap, fallback_cap=fallback_cap)


def _both(query, ref, ref_valid, cell, cell_cap, fallback_cap):
    query, ref = np.float32(query), np.float32(ref)
    ref_valid = np.asarray(ref_valid, bool)
    jgrid, a = _jax_nn(jnp.asarray(query), jnp.asarray(ref),
                       jnp.asarray(ref_valid), cell, cell_cap, fallback_cap)
    tref, tval = torch.from_numpy(ref), torch.from_numpy(ref_valid)
    tgrid = tn.build_nn_grid(tref, tval, cell)
    for f in ("sc", "order", "dims", "strides"):
        np.testing.assert_array_equal(np.asarray(getattr(jgrid, f)),
                                      getattr(tgrid, f).numpy(), err_msg=f)
    b = tn.nn_grid(tgrid, torch.from_numpy(query), tref, tval, cell,
                   cell_cap=cell_cap, fallback_cap=fallback_cap)
    np.testing.assert_array_equal(np.asarray(a[0]), b[0].numpy(), "idx")
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=1e-6,
                               atol=0, err_msg="d2")
    np.testing.assert_array_equal(np.asarray(a[2]), b[2].numpy(), "resolved")
    assert int(a[3]) == int(b[3])
    return b


@pytest.mark.parametrize("seed", range(3))
def test_exact_vs_jax(seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 10, (2000, 3))
    rv = rng.uniform(size=2000) > 0.1
    query = np.float32(ref[rng.integers(0, 2000, 500)]) \
        + 0.05 * rng.standard_normal((500, 3)).astype(np.float32)
    _, _, resolved, overflow = _both(query, ref, rv, 0.5, 32, 500)
    assert int(overflow) == 0 and bool(resolved.all())


def test_far_queries_fall_back():
    rng = np.random.default_rng(7)
    ref = rng.uniform(0, 1, (300, 3))
    query = rng.uniform(5, 6, (50, 3))
    _, _, resolved, overflow = _both(query, ref, np.ones(300, bool), 0.2, 8,
                                     64)
    assert int(overflow) == 0 and bool(resolved.all())


def test_cell_overflow_falls_back():
    rng = np.random.default_rng(3)
    dense = 0.5 + 0.001 * rng.standard_normal((200, 3))
    ref = np.concatenate([dense, rng.uniform(2, 3, (20, 3))])
    query = 0.5 + 0.001 * rng.standard_normal((40, 3))
    _both(query, ref, np.ones(len(ref), bool), 1.0, 8, 64)


@pytest.mark.parametrize("fallback_cap", [0, 10])
def test_overflow_counter(fallback_cap):
    rng = np.random.default_rng(5)
    ref = rng.uniform(0, 1, (100, 3))
    query = rng.uniform(9, 10, (30, 3))          # all unresolved
    _, _, resolved, overflow = _both(query, ref, np.ones(100, bool), 0.5, 8,
                                     fallback_cap)
    assert int(overflow) == 30 - fallback_cap
    assert int((~resolved).sum()) == 30 - fallback_cap


def test_exact_tie_follows_stencil_order():
    """Two targets 0.25 from the query, in the cells x = 0 and x = 1: the
    stencil visits dx = -1 first, so the tie goes to the x = 0 target
    (index 5), not to the lowest index (2) -- as in JAX."""
    ref = np.zeros((8, 3), np.float32)
    ref[1:] = [3.0, 3.0, 3.0]
    ref[2] = [1.25, 0.5, 0.5]
    ref[5] = [0.75, 0.5, 0.5]
    query = np.array([[1.0, 0.5, 0.5], [1.0, 0.5, 0.5]], np.float32)
    idx, d2, resolved, _ = _both(query, ref, np.ones(8, bool), 1.0, 4, 2)
    assert idx.tolist() == [5, 5] and d2.tolist() == [0.0625, 0.0625]
    assert bool(resolved.all())


@pytest.mark.parametrize("fallback_cap", [400, 8])
def test_icp_grid_matches_jax(fallback_cap):
    rng = np.random.default_rng(11)
    src = rng.uniform(-2, 2, (400, 3)).astype(np.float32)
    ang = 0.15
    r = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]], np.float32)
    tgt = (src @ r.T + np.float32([0.3, -0.2, 0.1])).astype(np.float32)
    valid = np.ones(400, bool)
    valid[::17] = False
    cfg = ICPConfig(max_iterations=40)
    kw = dict(cell_size=1.0, cell_cap=16, fallback_cap=fallback_cap)
    ra, oa = jn.icp_grid(jnp.asarray(src), jnp.asarray(valid),
                         jnp.asarray(tgt), jnp.asarray(valid), cfg, **kw)
    rb, ob = tn.icp_grid(torch.from_numpy(src), torch.from_numpy(valid),
                         torch.from_numpy(tgt), torch.from_numpy(valid), cfg,
                         **kw)
    np.testing.assert_allclose(rb.r.numpy(), np.asarray(ra.r), atol=1e-5)
    np.testing.assert_allclose(rb.t.numpy(), np.asarray(ra.t), atol=1e-5)
    assert int(rb.iterations) == int(ra.iterations)
    assert int(ob) == int(oa)


@pytest.mark.parametrize("iterations", [1, 5])
def test_icp_grid_float64_matches_jax(iterations):
    """The crossover case of tools/tier3_inputs.py at m = 4,000 in float64:
    the loop, weights and composition are JAX's, so R and t agree to
    float64 rounding after every iteration count; in float32 they differ
    only by the order of the float32 sums (tools/icp_grid_witness.py)."""
    from tools.tier3_inputs import nn_cell, nn_inputs

    src, tgt = (a.astype(np.float64) for a in nn_inputs(4000, 2000))
    valid_s, valid_t = np.ones(len(src), bool), np.ones(len(tgt), bool)
    cfg = ICPConfig(max_iterations=iterations, tol=1e-10)
    kw = dict(cell_size=nn_cell(4000), cell_cap=64, fallback_cap=256)
    ra, oa = jn.icp_grid(jnp.asarray(src), jnp.asarray(valid_s),
                         jnp.asarray(tgt), jnp.asarray(valid_t), cfg, **kw)
    rb, ob = tn.icp_grid(torch.from_numpy(src), torch.from_numpy(valid_s),
                         torch.from_numpy(tgt), torch.from_numpy(valid_t),
                         cfg, **kw)
    assert rb.t.dtype == torch.float64
    np.testing.assert_allclose(rb.r.numpy(), np.asarray(ra.r), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(rb.t.numpy(), np.asarray(ra.t), rtol=0,
                               atol=1e-12)
    assert int(rb.iterations) == int(ra.iterations) == iterations
    assert int(ob) == int(oa) == 0


def test_float64_cells_use_the_double_reciprocal():
    """In float64 XLA divides by the static cell size as a multiplication by
    the double 1 / cell, not by the float32 reciprocal: references next to
    multiples of the cell size get JAX's cell ids, and the queries JAX's
    neighbours (the port took the float32 reciprocal for every dtype until
    cluster.grid.reciprocal; this failed on sc)."""
    rng = np.random.default_rng(7)
    cell = 0.3
    inv32 = np.float64(np.float32(1.0) / np.float32(cell))
    x = rng.integers(1, 30, 4000) * cell
    cand = np.concatenate([x, np.nextafter(x, -np.inf),
                           np.nextafter(x, np.inf)])
    tricky = cand[np.floor(cand * (1.0 / cell)) != np.floor(cand * inv32)]
    assert len(tricky) >= 100
    ref = rng.uniform(0, 9, (800, 3))
    ref[0] = 0.0                      # the grid origin: x - lo is exact
    ref[1:101, 0] = tricky[:100]
    ref[101:201, 2] = tricky[:100]
    rv = np.ones(800, bool)
    query = ref[rng.integers(0, 800, 300)] + 0.01 * rng.standard_normal(
        (300, 3))
    jgrid, a = _jax_nn(jnp.asarray(query), jnp.asarray(ref), jnp.asarray(rv),
                       cell, 32, 300)
    tref, tval = torch.from_numpy(ref), torch.from_numpy(rv)
    tgrid = tn.build_nn_grid(tref, tval, cell)
    for f in ("sc", "order", "dims", "strides"):
        np.testing.assert_array_equal(np.asarray(getattr(jgrid, f)),
                                      getattr(tgrid, f).numpy(), err_msg=f)
    b = tn.nn_grid(tgrid, torch.from_numpy(query), tref, tval, cell,
                   cell_cap=32, fallback_cap=300)
    np.testing.assert_array_equal(np.asarray(a[0]), b[0].numpy(), "idx")
    np.testing.assert_allclose(b[1].numpy(), np.asarray(a[1]), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(a[2]), b[2].numpy(), "resolved")
