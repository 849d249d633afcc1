"""PyTorch port vs the JAX package: the shape variants of ops/geometry.py --
quickhull, exact candidate pruning, the MEC of <= 4 points and the
Elzinga-Hearn MEC -- and each cluster_shapes variant.

Tolerances: rtol 2e-5, atol 1e-6 on radius, area and centre
(tests/test_pallas_shapes.py:42). Hull vertex SETS are compared (the
counter-clockwise order starts where the centroid's pseudo-angle puts it,
and the centroid is a sum whose rounding may differ); pruning is compared
by its overflow count and by its exactness, not by packed arrays (the
projection argmax may pick another extreme at an ulp tie).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_shapes import _clusters, _close, _torch
from vtkcloudpoint_tpu.ops import geometry as jg
from vtkcloudpoint_tpu_torch.ops import geometry as tg


def _vertex_set(pts, valid):
    return sorted(map(tuple, np.asarray(pts)[np.asarray(valid)].tolist()))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_hull", [4, 16])
def test_convex_hull_quick(seed, max_hull):
    points, valid, _ = _clusters(seed, K=8, cap=64)
    hp, hv = tg.convex_hull_quick(*map(torch.from_numpy, (points, valid)),
                                  max_hull)
    jp, jv = jax.vmap(lambda p, v: jg.convex_hull_quick(p, v, max_hull))(
        jnp.asarray(points), jnp.asarray(valid))
    for k in range(points.shape[0]):
        assert _vertex_set(hp[k], hv[k]) == _vertex_set(jp[k], jv[k]), k
    if max_hull == 16:   # where the gift wrap is not truncated, quickhull's
        # vertices are among its (wrap also keeps collinear points)
        wp, wv = tg.convex_hull(*map(torch.from_numpy, (points, valid)), 16)
        for k in np.nonzero(~wv.numpy().all(1))[0]:
            assert set(_vertex_set(hp[k], hv[k])) <= set(
                _vertex_set(wp[k], wv[k]))


@pytest.mark.parametrize("cap_out", [8, 48, 200])
def test_hull_prune_pack(cap_out):
    points, valid, _ = _clusters(4, K=10, cap=128)
    pp, pv, povf = tg.hull_prune_pack(*map(torch.from_numpy,
                                           (points, valid)), cap_out)
    _, jv, jovf = jax.vmap(lambda p, v: jg.hull_prune_pack(p, v, cap_out))(
        jnp.asarray(points), jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(jovf), povf.numpy())
    np.testing.assert_array_equal(np.asarray(jv).sum(1), pv.numpy().sum(1))
    # exactness: without overflow the survivors keep every hull vertex
    wp, wv = tg.convex_hull(*map(torch.from_numpy, (points, valid)), 64)
    qp, qv = tg.convex_hull(pp, pv, 64)
    for k in np.nonzero(povf.numpy() == 0)[0]:
        assert _vertex_set(wp[k], wv[k]) == _vertex_set(qp[k], qv[k]), k
    assert (povf.numpy() > 0).any() == (cap_out < 128)


def test_mec_of_4():
    rng = np.random.default_rng(5)
    K = 64
    sx = rng.uniform(0, 1, (K, 4)).astype(np.float32)
    sy = rng.uniform(0, 1, (K, 4)).astype(np.float32)
    sv = rng.random((K, 4)) < 0.8
    sx[:8, 3], sy[:8, 3] = sx[:8, 0], sy[:8, 0]        # duplicates
    sx[8:16, 2] = (sx[8:16, 0] + sx[8:16, 1]) / 2       # collinear
    sy[8:16, 2] = (sy[8:16, 0] + sy[8:16, 1]) / 2
    a = jax.vmap(jg._mec_of_4)(*map(jnp.asarray, (sx, sy, sv)))
    b = tg._mec_of_4(*map(torch.from_numpy, (sx, sy, sv)))
    live = sv.sum(1) >= 2
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_allclose(y.numpy()[live], np.asarray(x)[live],
                                   rtol=2e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(a[3])[live], b[3].numpy()[live])


@pytest.mark.parametrize("seed", range(2))
def test_min_enclosing_circle_eh(seed):
    points, valid, _ = _clusters(seed, K=10, cap=64)
    hp, hv = tg.convex_hull(*map(torch.from_numpy, (points, valid)), 16)
    b = tg.min_enclosing_circle_eh(hp, hv)
    a = jax.vmap(jg.min_enclosing_circle_eh)(jnp.asarray(hp.numpy()),
                                             jnp.asarray(hv.numpy()))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=2e-5,
                                   atol=1e-6)
    scan = tg.min_enclosing_circle(hp, hv)
    np.testing.assert_allclose(b[2].numpy(), scan[2].numpy(), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [
    {"hull": "quick"}, {"mec": "eh"}, {"prune_cap": 48}, {"prune_cap": 8},
    {"hull": "quick", "mec": "eh", "prune_cap": 40}])
@pytest.mark.parametrize("seed", range(2))
def test_cluster_shapes_variants(kw, seed):
    points, valid, counts = _clusters(seed)
    ref = jg.cluster_shapes(jnp.asarray(points), jnp.asarray(valid),
                            jnp.asarray(counts), max_hull=16, chunk_k=12,
                            backend="jnp", **kw)
    out = tg.cluster_shapes(*_torch(points, valid, counts), max_hull=16,
                            chunk_k=5, tri_chunk=100, **kw)
    _close(ref, out)
    assert int(out["prune_overflow"]) == int(ref["prune_overflow"])


def test_unknown_hull_raises():
    points, valid, counts = _clusters(0, K=2)
    with pytest.raises(ValueError, match="hull"):
        tg.cluster_shapes(*_torch(points, valid, counts), hull="graham")
