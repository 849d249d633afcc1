"""Block-sparse pose-graph Gauss-Newton and landmark bundle adjustment
(port of vtkcloudpoint_tpu.slam.ba).

- Per-edge 6x6 Jacobian blocks from local forward-mode autodiff
  (``torch.func.vmap`` of ``torch.func.jacfwd``): each edge residual is a
  function of its two poses' 12 increment dims only, so the [6E, 6S]
  Jacobian is never formed.
- Landmark (cluster-centroid) observations are eliminated by a Schur
  complement: H_ll is 3x3-block-diagonal, the reduced camera system is
  H_pp - H_pl H_ll^-1 H_lp, and the landmark update back-substitutes.

Pose convention as slam.posegraph: world-from-scan (R_s, t_s), edge (i, j)
measures i_from_j, local right perturbations R <- R exp(w), t <- t + dt.

Every segment sum goes through ``ops.segment.segment_sum`` (exact, so the
same bits in any order on the card), and the normal-equation blocks are
laid into H by ``index_put_(accumulate=True)`` on its [S, S, 6, 6] view,
which adds duplicate (i, j) edges as JAX's ``.at[].add`` does, each
position's blocks in edge order. The JAX ``lax.scan``
over iterations is a Python loop that reads nothing from the device.

The sharded solvers take this rank's edges or observations (any count, at
least one) and a parallel.mesh.Mesh: each rank assembles its share of the
normal equations, one all_reduce per iteration sums them, and the small
solve runs replicated -- the single-device result up to the order of the
float sums. ``pad_pose_graph`` / ``pad_observations`` add JAX's zero-weight
padding so a global array cuts into equal shards (``parallel.mesh.
shard_blocks``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from .. import device as _device  # noqa: F401  (full-f32 matmuls)
from ..ops import se3
from ..ops.segment import segment_sum
from ..utils import profiling as prof
from .posegraph import PoseGraph, _residuals

GAUGE_WEIGHT = 1e6  # prior stiffness pinning pose 0 (matches posegraph 1e3^2)
# scans a dense per-scan DBSCAN batch holds: [8, N, N] distances, 134 MB of
# float32 at N = 2,048
SCAN_CHUNK = 8


def _edge_residual_local(dxi, dxj, ri, ti, rj, tj, rm, tm, w):
    """Residual [6] of one edge at local increments dxi/dxj in R^6
    (w, t)."""
    ri_new = ri @ se3.so3_exp(dxi[:3])
    ti_new = ti + dxi[3:]
    rj_new = rj @ se3.so3_exp(dxj[:3])
    tj_new = tj + dxj[3:]
    r_rel = ri_new.T @ rj_new
    t_rel = ri_new.T @ (tj_new - ti_new)
    e_rot = se3.so3_log(rm.T @ r_rel)
    return torch.sqrt(w) * torch.cat([e_rot, t_rel - tm])


def edge_blocks(rots, trans, graph: PoseGraph):
    """Per-edge residuals and 6x6 Jacobian blocks at zero increments:
    (res [E,6], ji [E,6,6], jj [E,6,6])."""
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    zero = torch.zeros(ei.shape[0], 6, dtype=rots.dtype, device=rots.device)
    args = (zero, zero, rots[ei], trans[ei], rots[ej], trans[ej],
            graph.r_meas, graph.t_meas, graph.weight)
    res = vmap(_edge_residual_local)(*args)
    ji, jj = vmap(jacfwd(_edge_residual_local, argnums=(0, 1)))(*args)
    return res, ji, jj


def _block_add(h, rows, cols, blocks):
    """h [S, S, 6, 6] += blocks [E, 6, 6] at (rows[e], cols[e]), duplicate
    pairs summed."""
    return h.index_put_((rows.long(), cols.long()), blocks, accumulate=True)


def assemble_normal_eqs(res, ji, jj, edge_i, edge_j, s: int):
    """Dense (H [6S,6S], g [6S]) from per-edge blocks.

    H = sum_e J_e^T J_e laid into its (ii, jj, ij, ji) 6x6 blocks; the dense
    matrix is small (S ~ 10^2) -- the sparsity win is in never forming the
    [6E x 6S] Jacobian.
    """
    hii = torch.einsum("eab,eac->ebc", ji, ji)
    hjj = torch.einsum("eab,eac->ebc", jj, jj)
    hij = torch.einsum("eab,eac->ebc", ji, jj)
    gi = torch.einsum("eab,ea->eb", ji, res)
    gj = torch.einsum("eab,ea->eb", jj, res)

    diag = segment_sum(hii, edge_i, s) + segment_sum(hjj, edge_j, s)
    g = segment_sum(gi, edge_i, s) + segment_sum(gj, edge_j, s)

    ar = torch.arange(s, device=res.device)
    h = torch.zeros((s, s, 6, 6), dtype=res.dtype, device=res.device)
    _block_add(h, ar, ar, diag)
    _block_add(h, edge_i, edge_j, hij)
    _block_add(h, edge_j, edge_i, hij.transpose(1, 2))
    return h.transpose(1, 2).reshape(6 * s, 6 * s), g.reshape(6 * s)


def _apply_update(rots, trans, dx):
    s = rots.shape[0]
    d6 = dx[:6 * s].reshape(s, 6)
    return rots @ vmap(se3.so3_exp)(d6[:, :3]), trans + d6[:, 3:]


def _solve_spd(h, g):
    """float32-robust SPD solve: Jacobi equilibration plus one iterative
    refinement step (the gauge prior against O(1) edge rows gives H a
    condition number ~1e6; D^-1/2 H D^-1/2 drops the spread to the graph's
    own conditioning)."""
    d = torch.sqrt(torch.clamp_min(torch.diagonal(h), 1e-20))
    hs = h / (d[:, None] * d[None, :])
    gs = g / d
    # each solve's error check reads the card
    x = prof.sync(torch.linalg.solve, hs, gs)
    r = gs - hs @ x
    x = x + prof.sync(torch.linalg.solve, hs, r)
    return x / d


def _gauge(h, s: int, damping: float):
    eye6 = torch.eye(6, dtype=h.dtype, device=h.device)
    h = h.clone()
    h[:6, :6] += GAUGE_WEIGHT * eye6
    return h + damping * torch.eye(6 * s, dtype=h.dtype, device=h.device)


def optimize_pose_graph_sparse(rot0, t0, graph: PoseGraph,
                               iterations: int = 10, damping: float = 1e-6):
    """Gauss-Newton with block-sparse assembly (single device): the problem
    and minimum of posegraph.optimize_pose_graph, the Jacobian per edge.

    Returns (R [S,3,3], t [S,3], final_cost)."""
    s = rot0.shape[0]
    rots, trans = rot0, t0
    for _ in range(iterations):
        res, ji, jj = edge_blocks(rots, trans, graph)
        h, g = assemble_normal_eqs(res, ji, jj, graph.edge_i, graph.edge_j,
                                   s)
        dx = -_solve_spd(_gauge(h, s, damping), g)
        rots, trans = _apply_update(rots, trans, dx)
    final_cost = (_residuals(rots, trans, graph) ** 2).sum()
    return rots, trans, final_cost


def pad_pose_graph(graph: PoseGraph, n: int) -> PoseGraph:
    """The graph with weight-0 edges (0, 0) measuring the identity appended
    up to a multiple of n: sqrt(0) zeroes their residual and Jacobian, and
    the measurement stays in SO(3), so so3_log never sees garbage."""
    pad = (-graph.edge_i.shape[0]) % n
    if not pad:
        return graph
    eye = torch.eye(3, dtype=graph.r_meas.dtype,
                    device=graph.r_meas.device).expand(pad, 3, 3)

    def zeros(x, *tail):
        return torch.cat([x, x.new_zeros((pad,) + tail)])

    return PoseGraph(edge_i=zeros(graph.edge_i), edge_j=zeros(graph.edge_j),
                     r_meas=torch.cat([graph.r_meas, eye]),
                     t_meas=zeros(graph.t_meas, 3),
                     weight=zeros(graph.weight))


def optimize_pose_graph_sharded(mesh, rot0, t0, graph: PoseGraph,
                                iterations: int = 10, damping: float = 1e-6,
                                axis: str = "blocks"):
    """Distributed pose-graph GN, this rank's part: ``graph`` holds this
    rank's edges, the poses are replicated. Per iteration each rank
    assembles (H, g, cost) over its edges and one all_reduce sums them; the
    6S solve runs replicated. Returns (R [S,3,3], t [S,3], cost at the
    start of the last iteration), replicated. ``axis`` is JAX's name of the mesh axis, kept
    for its signature and not read: the mesh has one axis."""
    s = rot0.shape[0]
    rots, trans = rot0, t0
    cost = None
    for _ in range(iterations):
        res, ji, jj = edge_blocks(rots, trans, graph)
        h, g = assemble_normal_eqs(res, ji, jj, graph.edge_i, graph.edge_j,
                                   s)
        n6 = 6 * s
        tot = mesh.psum(torch.cat([h.reshape(-1), g, (res * res).sum()[
            None]]))
        h, g, cost = tot[:n6 * n6].reshape(n6, n6), tot[n6 * n6:-1], tot[-1]
        dx = -_solve_spd(_gauge(h, s, damping), g)
        rots, trans = _apply_update(rots, trans, dx)
    return rots, trans, cost


# ---------------------------------------------------------------------------
# Landmark (centroid) bundle adjustment with Schur elimination
# ---------------------------------------------------------------------------

class Observations(NamedTuple):
    """Landmark observations: scan ``pose`` sees world landmark ``lm`` at
    scan-frame coordinates ``z`` (e.g. a cluster centroid in scan coords)."""

    pose: torch.Tensor    # i32[O]
    lm: torch.Tensor      # i32[O]
    z: torch.Tensor       # f[O,3]
    weight: torch.Tensor  # f[O]


def _obs_blocks(rots, trans, lms, obs: Observations):
    """Residual and analytic Jacobians of the landmark observations:
    r = R_s^T (m_l - t_s) - z (scan frame), with right-perturbed pose
    dr/dw = [R^T (m - t)]_x, dr/dt = -R^T, dr/dm = R^T. Returns
    (res [O,3], jp [O,3,6], jl [O,3,3])."""
    r_t = rots[obs.pose.long()].transpose(1, 2)
    local = (r_t @ (lms[obs.lm.long()] - trans[obs.pose.long()])[:, :, None]
             )[:, :, 0]
    sw = torch.sqrt(obs.weight)[:, None]
    res = sw * (local - obs.z)
    jw = vmap(se3.so3_hat)(local)
    jp = sw[:, :, None] * torch.cat([jw, -r_t], dim=2)
    jl = sw[:, :, None] * r_t
    return res, jp, jl


def ba_schur_step(rots, trans, lms, obs: Observations, damping: float,
                  axis=None):
    """One Gauss-Newton step over (poses, landmarks) with the landmarks
    eliminated by Schur complement. Returns (rots, trans, lms, cost).
    With ``axis`` the observations are this rank's and the moment matrices
    all_reduce before the replicated solve: where JAX names the mesh axis
    inside shard_map, the port takes this rank's parallel.mesh.Mesh."""
    s = rots.shape[0]
    nl = lms.shape[0]
    dtype, dev = rots.dtype, rots.device
    res, jp, jl = _obs_blocks(rots, trans, lms, obs)

    # pose system moments
    hpp_d = segment_sum(torch.einsum("oab,oac->obc", jp, jp), obs.pose, s)
    gp = segment_sum(torch.einsum("oab,oa->ob", jp, res), obs.pose, s)
    # landmark system (3x3 block diagonal)
    hll = segment_sum(torch.einsum("oab,oac->obc", jl, jl), obs.lm, nl)
    gl = segment_sum(torch.einsum("oab,oa->ob", jl, res), obs.lm, nl)
    # cross term H_pl as [S, L, 6, 3] dense moments
    key = obs.pose.long() * nl + obs.lm.long()
    hpl = segment_sum(torch.einsum("oab,oac->obc", jp, jl), key,
                      s * nl).reshape(s, nl, 6, 3)
    cost = (res * res).sum()
    if axis is not None:
        parts = (hpp_d, gp, hll, gl, hpl, cost)
        tot = axis.psum(torch.cat([x.reshape(-1) for x in parts]))
        out, at = [], 0
        for x in parts:
            out.append(tot[at:at + x.numel()].reshape(x.shape))
            at += x.numel()
        hpp_d, gp, hll, gl, hpl, cost = out

    hll = hll + damping * torch.eye(3, dtype=dtype, device=dev)[None]
    hll_inv = prof.sync(torch.linalg.inv, hll)

    # reduced camera system: Hred dxp = -(gp - Hpl Hll^-1 gl)
    w_mat = torch.einsum("slab,lbc->slac", hpl, hll_inv)        # [S,L,6,3]
    hred = -torch.einsum("slac,tlbc->satb", w_mat, hpl)         # [S,6,S,6]
    ar = torch.arange(s, device=dev)
    _block_add(hred.permute(0, 2, 1, 3), ar, ar, hpp_d)
    hred = _gauge(hred.reshape(6 * s, 6 * s), s, damping)
    gred = (gp - torch.einsum("slac,lc->sa", w_mat, gl)).reshape(6 * s)
    dxp = -_solve_spd(hred, gred)

    # landmark back-substitution: dxl = -Hll^-1 (gl + Hlp dxp)
    hlp_dxp = torch.einsum("slab,sa->lb", hpl, dxp.reshape(s, 6))
    dxl = -torch.einsum("lab,lb->la", hll_inv, gl + hlp_dxp)

    rots, trans = _apply_update(rots, trans, dxp)
    return rots, trans, lms + dxl, cost


def bundle_adjust(rot0, t0, lms0, obs: Observations, iterations: int = 10,
                  damping: float = 1e-4):
    """Pose + landmark bundle adjustment (single device, Schur-eliminated).

    Returns (R [S,3,3], t [S,3], landmarks [L,3], final_cost)."""
    rots, trans, lms = rot0, t0, lms0
    for _ in range(iterations):
        rots, trans, lms, _ = ba_schur_step(rots, trans, lms, obs, damping)
    res, _, _ = _obs_blocks(rots, trans, lms, obs)
    return rots, trans, lms, (res * res).sum()


def pad_observations(obs: Observations, n: int) -> Observations:
    """The observations with weight-0 rows (pose 0, landmark 0, z 0)
    appended up to a multiple of n: exact no-ops in the normal
    equations."""
    pad = (-obs.pose.shape[0]) % n
    if not pad:
        return obs
    return Observations(*(torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                          for x in obs))


def bundle_adjust_sharded(mesh, rot0, t0, lms0, obs: Observations,
                          iterations: int = 10, damping: float = 1e-4,
                          axis: str = "blocks"):
    """Distributed BA, this rank's part: ``obs`` holds this rank's
    observations; per iteration the (H_pp, H_pl, H_ll, g) moments all_reduce
    and both the reduced camera solve and the landmark back-substitution
    run replicated. Returns (R, t, landmarks, cost at the start of the last
    iteration), replicated. ``axis`` is JAX's name of the mesh axis, kept
    for its signature and not read: the mesh has one axis."""
    rots, trans, lms = rot0, t0, lms0
    cost = None
    for _ in range(iterations):
        rots, trans, lms, cost = ba_schur_step(rots, trans, lms, obs,
                                               damping, axis=mesh)
    return rots, trans, lms, cost


def observations_from_scans(scans, scan_valid, traj_r, traj_t, eps: float,
                            min_pts: int, max_clusters_per_scan: int = 32,
                            assoc_eps: float = None,
                            assoc_cell_cap: int = 64):
    """Landmark ``Observations`` from per-scan cluster centroids.

    1. each scan clusters on its own (dense DBSCAN, ``l2_xyz``: the
       per-scan ``dbscan_padded`` of the JAX package, SCAN_CHUNK scans a
       batch) and reduces to <= max_clusters_per_scan centroids in scan
       frame (the observations z);
    2. centroids move into the world by the current trajectory and
       associate by eps-connectivity (``dbscan_grid`` over the S*K centroid
       cloud with min_pts=1: components are landmarks);
    3. landmark initial positions are the component means.

    Returns (Observations, lms0 [L_cap, 3], n_landmarks) with
    L_cap = S * max_clusters_per_scan + 1; invalid slots carry weight 0
    (exact no-ops in the BA normal equations).
    """
    from ..cluster.dbscan import dbscan_blocks
    from ..cluster.grid import dbscan_grid
    from ..ops.segment import cluster_stats

    s, n, _ = scans.shape
    k = max_clusters_per_scan
    dtype, dev = scans.dtype, scans.device
    if assoc_eps is None:
        assoc_eps = 4.0 * eps

    # per-scan DBSCAN (local ids 1.., cf = 0, as dbscan_padded per scan),
    # then every scan's K + 1 centroid rows in one segment pass
    lab = dbscan_blocks(scans, scan_valid, eps, min_pts, "l2_xyz",
                        chunk=SCAN_CHUNK)["label"]
    scan_id = torch.arange(s, device=dev)[:, None]
    seg = torch.where(lab <= k, lab + scan_id * (k + 1), -1).reshape(-1)
    flat = scans.reshape(s * n, 3)
    st = cluster_stats(flat, flat[:, :2], seg, scan_valid.reshape(-1),
                       s * (k + 1))
    cents = st["center3d"].reshape(s, k + 1, 3)[:, 1:, :]     # [S, K, 3]
    cval = (st["count"] > 0).reshape(s, k + 1)[:, 1:]
    world = torch.einsum("sab,skb->ska", traj_r, cents) + traj_t[:, None, :]

    flat_w = world.reshape(s * k, 3)
    flat_z = cents.reshape(s * k, 3)
    flat_v = cval.reshape(s * k)
    comp = dbscan_grid(flat_w, flat_v, assoc_eps, 1, "l2_xyz",
                       cell_cap=assoc_cell_cap)
    lm = comp["label"]                       # 1..L, 0 invalid
    l_cap = s * k + 1
    cnt = segment_sum(flat_v.to(dtype), lm, l_cap)
    lm_sum = segment_sum(torch.where(flat_v[:, None], flat_w, 0.0), lm,
                         l_cap)
    lms0 = lm_sum / torch.clamp_min(cnt, 1.0)[:, None]
    obs = Observations(
        pose=torch.arange(s, dtype=torch.int32, device=dev).repeat_interleave(
            k),
        lm=lm, z=flat_z, weight=flat_v.to(dtype))
    return obs, lms0, comp["n_clusters"]
