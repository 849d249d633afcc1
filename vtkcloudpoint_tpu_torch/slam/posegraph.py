"""Pose-graph optimisation over scan poses, dense Gauss-Newton (port of
vtkcloudpoint_tpu.slam.posegraph).

Poses are world-from-scan (R, t). Edge (i, j) carries the measured i_from_j
transform; its residual is

    R_rel = R_i^T R_j,  t_rel = R_i^T (t_j - t_i)
    e_rot = log(R_meas^T R_rel),  e_t = t_rel - t_meas

times sqrt(weight), plus a gauge prior pinning pose 0. The Jacobian of the
dense solve is ``torch.func.jacfwd`` over the 6S local increments; the
JAX ``lax.scan`` over iterations is a Python loop that reads nothing from
the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from .. import device as _device  # noqa: F401  (full-f32 matmuls)
from ..ops import se3
from ..utils import profiling as prof


class PoseGraph(NamedTuple):
    edge_i: torch.Tensor    # i32[E]
    edge_j: torch.Tensor    # i32[E]
    r_meas: torch.Tensor    # f[E,3,3] measured R_ij
    t_meas: torch.Tensor    # f[E,3]
    weight: torch.Tensor    # f[E] information weight


def _edge_residual(ri, ti, rj, tj, rm, tm, w):
    """Residual [6] of one edge at absolute poses."""
    r_rel = ri.T @ rj
    t_rel = ri.T @ (tj - ti)
    e_rot = se3.so3_log(rm.T @ r_rel)
    return torch.sqrt(w) * torch.cat([e_rot, t_rel - tm])


def _residuals(rots, trans, graph: PoseGraph):
    """Edge residuals for absolute poses (rots [S,3,3], trans [S,3]):
    [6E] in edge order."""
    ei, ej = graph.edge_i.long(), graph.edge_j.long()
    return vmap(_edge_residual)(rots[ei], trans[ei], rots[ej], trans[ej],
                                graph.r_meas, graph.t_meas,
                                graph.weight).reshape(-1)


def optimize_pose_graph(rot0, t0, graph: PoseGraph, iterations: int = 10,
                        damping: float = 1e-6):
    """On-manifold Gauss-Newton pose-graph solve with a dense Jacobian.

    Each iteration linearises in local increments (R_i <- R_i exp(dw_i),
    t_i <- t_i + dt_i; dx = [dw_0..dw_{S-1}, dt_0..dt_{S-1}]); pose 0 is
    gauge-fixed by a 1e3-weighted prior on its increment.

    Returns (R [S,3,3], t [S,3], final_cost).
    """
    s = rot0.shape[0]
    dtype, dev = rot0.dtype, rot0.device
    anchor_idx = prof.sync(torch.tensor,
                           [0, 1, 2, 3 * s, 3 * s + 1, 3 * s + 2],
                           device=dev)
    eye = torch.eye(6 * s, dtype=dtype, device=dev)

    def res_of_delta(dx, rots, trans):
        dw = dx[:3 * s].reshape(s, 3)
        dt = dx[3 * s:].reshape(s, 3)
        r_new = rots @ vmap(se3.so3_exp)(dw)
        res = _residuals(r_new, trans + dt, graph)
        return torch.cat([res, dx[anchor_idx] * 1e3])

    rots, trans = rot0, t0
    zero = torch.zeros(6 * s, dtype=dtype, device=dev)
    for _ in range(iterations):
        r0 = res_of_delta(zero, rots, trans)
        jmat = jacfwd(res_of_delta)(zero, rots, trans)
        h = jmat.T @ jmat + damping * eye
        dx = -prof.sync(torch.linalg.solve, h, jmat.T @ r0)
        rots = rots @ vmap(se3.so3_exp)(dx[:3 * s].reshape(s, 3))
        trans = trans + dx[3 * s:].reshape(s, 3)
    final_cost = (_residuals(rots, trans, graph) ** 2).sum()
    return rots, trans, final_cost


def absolute_trajectory_error(r_est, t_est, r_true, t_true):
    """ATE-trans RMSE after SE(3) alignment of the two trajectories
    (the BASELINE.json acceptance metric)."""
    r_align, t_align = se3.kabsch_solve(t_est, t_true)
    aligned = t_est @ r_align.T + t_align
    return torch.sqrt(((aligned - t_true) ** 2).sum(dim=-1).mean())
