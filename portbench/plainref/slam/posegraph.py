"""Pose-graph edges and residuals over scan poses (port of
vtkcloudpoint_tpu.slam.posegraph; the solver is slam/ba.py's block-sparse
Gauss-Newton).

Poses are world-from-scan (R, t). Edge (i, j) carries the measured i_from_j
transform; its residual is

    R_rel = R_i^T R_j,  t_rel = R_i^T (t_j - t_i)
    e_rot = log(R_meas^T R_rel),  e_t = t_rel - t_meas

times sqrt(weight).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from .. import device as _device  # noqa: F401  (full-f32 matmuls)
from ..ops import se3


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


