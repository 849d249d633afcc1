"""PyTorch port vs the JAX package: block-sparse pose-graph Gauss-Newton and
landmark bundle adjustment (slam/ba.py) and the dense pose-graph solve
(slam/posegraph.py), on the problems of tests/test_ba.py, in float64.

Tolerances (float64 throughout):
- edge residuals and 6x6 Jacobian blocks, normal equations (with a
  duplicated edge, whose blocks must add), _solve_spd, one Schur step:
  atol 1e-12 (relative 1e-12 for H, whose entries reach 1e2);
- dense and sparse pose-graph GN, bundle adjustment: poses and landmarks
  atol 1e-9, costs rtol 1e-9 (or both below 1e-18);
- observations_from_scans: landmark ids, pose ids, weights and
  n_landmarks equal, z and lms0 atol 1e-12.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_ba import _make_ba_problem, _make_problem
from vtkcloudpoint_tpu.slam import ba as jba
from vtkcloudpoint_tpu.slam import posegraph as jpg
from vtkcloudpoint_tpu_torch import convert
from vtkcloudpoint_tpu_torch.parallel.distributed import one_rank_group
from vtkcloudpoint_tpu_torch.slam import ba as tba
from vtkcloudpoint_tpu_torch.slam import posegraph as tpg

TOL = 1e-12
SOLVE_TOL = 1e-9
# the JAX package runs these inside jitted solvers; jitted here too (eager
# vmap-of-jacfwd dispatches op by op)
J_EDGE_BLOCKS = jax.jit(jba.edge_blocks)
J_SCHUR_STEP = jax.jit(jba.ba_schur_step, static_argnames=("damping",
                                                           "axis"))


def _np(x):
    return np.array(x)


def _port(tree):
    return convert.from_numpy(tree, "cpu")


@pytest.fixture(scope="module")
def graph_problem():
    (r_true, t_true), (r0, t0), graph = _make_problem()
    return (r_true, t_true), (_np(r0), _np(t0)), graph


def _duplicated(graph):
    """The graph with its loop edge (0, S-1) twice and edge (2, 3) thrice."""
    take = np.r_[np.arange(len(graph.edge_i)), len(graph.edge_i) - 1, 2, 2]
    return jpg.PoseGraph(*(x[take] for x in graph))


@pytest.mark.parametrize("dup", [False, True])
def test_edge_blocks_and_normal_eqs_match_jax(graph_problem, dup):
    _, (r0, t0), graph = graph_problem
    if dup:
        graph = _duplicated(graph)
    s = r0.shape[0]
    a = J_EDGE_BLOCKS(jnp.asarray(r0), jnp.asarray(t0), graph)
    tgraph = _port(graph)
    b = tba.edge_blocks(torch.from_numpy(r0), torch.from_numpy(t0), tgraph)
    assert isinstance(tgraph, tpg.PoseGraph)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), _np(x), atol=TOL)
    ha, ga = jba.assemble_normal_eqs(*a, graph.edge_i, graph.edge_j, s)
    hb, gb = tba.assemble_normal_eqs(*b, tgraph.edge_i, tgraph.edge_j, s)
    np.testing.assert_allclose(hb.numpy(), _np(ha), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(gb.numpy(), _np(ga), atol=TOL)
    if dup:
        # the duplicated blocks add: H differs from the plain graph's
        once = tba.assemble_normal_eqs(
            *tba.edge_blocks(torch.from_numpy(r0), torch.from_numpy(t0),
                             _port(graph_problem[2])),
            *_port((graph_problem[2].edge_i, graph_problem[2].edge_j)), s)[0]
        assert not torch.allclose(once, hb)


def test_solve_spd_matches_jax(graph_problem):
    _, (r0, t0), graph = graph_problem
    s = r0.shape[0]
    h, g = jba.assemble_normal_eqs(*J_EDGE_BLOCKS(
        jnp.asarray(r0), jnp.asarray(t0), graph), graph.edge_i, graph.edge_j,
        s)
    h = h.at[:6, :6].add(jba.GAUGE_WEIGHT * jnp.eye(6)) + 1e-6 * jnp.eye(6 * s)
    xa = jba._solve_spd(h, g)
    xb = tba._solve_spd(torch.from_numpy(_np(h)), torch.from_numpy(_np(g)))
    np.testing.assert_allclose(xb.numpy(), _np(xa), atol=TOL)


@pytest.mark.parametrize("solver", ["dense", "sparse"])
def test_pose_graph_gn_matches_jax(graph_problem, solver):
    (r_true, t_true), (r0, t0), graph = graph_problem
    ja = (jpg.optimize_pose_graph if solver == "dense"
          else jba.optimize_pose_graph_sparse)
    tb = (tpg.optimize_pose_graph if solver == "dense"
          else tba.optimize_pose_graph_sparse)
    ra, ta, ca = ja(jnp.asarray(r0), jnp.asarray(t0), graph, iterations=8)
    rb, tb_, cb = tb(torch.from_numpy(r0), torch.from_numpy(t0),
                     _port(graph), iterations=8)
    np.testing.assert_allclose(rb.numpy(), _np(ra), atol=SOLVE_TOL)
    np.testing.assert_allclose(tb_.numpy(), _np(ta), atol=SOLVE_TOL)
    assert (float(cb) < 1e-18 and float(ca) < 1e-18) or np.isclose(
        float(cb), float(ca), rtol=1e-9)
    ate = float(tpg.absolute_trajectory_error(
        rb, tb_, torch.from_numpy(r_true), torch.from_numpy(t_true)))
    np.testing.assert_allclose(ate, float(jpg.absolute_trajectory_error(
        ra, ta, jnp.asarray(r_true), jnp.asarray(t_true))), atol=SOLVE_TOL)


@pytest.fixture(scope="module")
def ba_problem():
    (r_true, t_true, lms), (r0, t0, l0), obs = _make_ba_problem()
    return (r_true, t_true, lms), tuple(map(_np, (r0, t0, l0))), obs


def test_ba_schur_step_matches_jax(ba_problem):
    _, (r0, t0, l0), obs = ba_problem
    a = J_SCHUR_STEP(jnp.asarray(r0), jnp.asarray(t0), jnp.asarray(l0), obs,
                     damping=1e-6)
    b = tba.ba_schur_step(*map(torch.from_numpy, (r0, t0, l0)), _port(obs),
                          1e-6)
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), _np(x), atol=TOL)
    # axis= (a one-rank gloo mesh): the all_reduced moments of one rank
    # are its own, so the step is the single-device step bit for bit
    with one_rank_group("cpu") as mesh:
        c = tba.ba_schur_step(*map(torch.from_numpy, (r0, t0, l0)),
                              _port(obs), 1e-6, axis=mesh)
    for x, y in zip(b, c):
        assert torch.equal(x, y)


def test_bundle_adjust_matches_jax(ba_problem):
    (r_true, t_true, lms_true), (r0, t0, l0), obs = ba_problem
    ra, ta, la, ca = jba.bundle_adjust(jnp.asarray(r0), jnp.asarray(t0),
                                       jnp.asarray(l0), obs, iterations=15,
                                       damping=1e-6)
    tobs = _port(obs)
    assert isinstance(tobs, tba.Observations)
    rb, tb_, lb, cb = tba.bundle_adjust(*map(torch.from_numpy, (r0, t0, l0)),
                                        tobs, iterations=15, damping=1e-6)
    np.testing.assert_allclose(rb.numpy(), _np(ra), atol=SOLVE_TOL)
    np.testing.assert_allclose(tb_.numpy(), _np(ta), atol=SOLVE_TOL)
    np.testing.assert_allclose(lb.numpy(), _np(la), atol=SOLVE_TOL)
    assert float(cb) < 1e-9 and float(ca) < 1e-9
    np.testing.assert_allclose(tb_.numpy(), t_true, atol=1e-3)


def _landmark_scans(seed=3, s=6, n=300, n_marks=6):
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 0.5, s)
    r_true = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]] for a in th])
    t_true = np.stack([0.4 * np.arange(s), 0.1 * np.arange(s),
                       np.zeros(s)], 1)
    marks = rng.uniform(-5, 5, (n_marks, 3)) * [1, 1, 0.2]
    per = (2 * n // 3) // n_marks
    blob = (marks[:, None] + 0.05 * rng.standard_normal((n_marks, per, 3))
            ).reshape(-1, 3)
    world = np.concatenate([blob, rng.uniform(-5, 5, (n - len(blob), 3))
                            * [1, 1, 0.2]])
    scans = np.stack([(world - t_true[k]) @ r_true[k] for k in range(s)])
    valid = rng.random((s, n)) < 0.95
    return scans, valid, r_true, t_true


def test_observations_from_scans_matches_jax():
    scans, valid, r, t = _landmark_scans()
    args = (0.3, 6, 8)
    oa, la, na = jba.observations_from_scans(
        jnp.asarray(scans), jnp.asarray(valid), jnp.asarray(r),
        jnp.asarray(t), *args)
    ob, lb, nb = tba.observations_from_scans(
        *map(torch.from_numpy, (scans, valid, r, t)), *args)
    assert int(nb) == int(na) == 6
    for key in ("pose", "lm", "weight"):
        np.testing.assert_array_equal(getattr(ob, key).numpy(),
                                      _np(getattr(oa, key)), err_msg=key)
    np.testing.assert_allclose(ob.z.numpy(), _np(oa.z), atol=TOL)
    np.testing.assert_allclose(lb.numpy(), _np(la), atol=TOL)


def test_sharded_solvers_raise_naming_item_7(graph_problem, ba_problem):
    """The sharded pose graph and BA -- ported, once named ROADMAP item 7
    -- on a one-rank gloo mesh against JAX's on make_mesh(1): poses and
    landmarks atol 1e-9, costs rtol 1e-9 (2 and 4 ranks:
    tests/test_torch_sharded.py)."""
    from vtkcloudpoint_tpu.parallel.mesh import make_mesh

    jmesh = make_mesh(1)
    _, (r0, t0), graph = graph_problem
    ra, ta, ca = jba.optimize_pose_graph_sharded(
        jmesh, jnp.asarray(r0), jnp.asarray(t0), graph, iterations=8)
    _, (r1, t1, l1), obs = ba_problem
    rb_a, tb_a, lb_a, cb_a = jba.bundle_adjust_sharded(
        jmesh, jnp.asarray(r1), jnp.asarray(t1), jnp.asarray(l1), obs,
        iterations=15, damping=1e-6)
    with one_rank_group("cpu") as mesh:
        rb, tb_, cb = tba.optimize_pose_graph_sharded(
            mesh, torch.from_numpy(r0), torch.from_numpy(t0), _port(graph),
            iterations=8)
        rb_b, tb_b, lb_b, cb_b = tba.bundle_adjust_sharded(
            mesh, *map(torch.from_numpy, (r1, t1, l1)), _port(obs),
            iterations=15, damping=1e-6)
    for x, y in ((rb, ra), (tb_, ta), (rb_b, rb_a), (tb_b, tb_a),
                 (lb_b, lb_a)):
        np.testing.assert_allclose(x.numpy(), _np(y), atol=SOLVE_TOL)
    for x, y in ((cb, ca), (cb_b, cb_a)):
        assert (float(x) < 1e-18 and float(y) < 1e-18) or np.isclose(
            float(x), float(y), rtol=1e-9)
