"""Iterative Closest Point registration (port of
vtkcloudpoint_tpu.register.icp: nn_correspond and icp).

The JAX while_loop becomes a Python loop; reading ``converged`` syncs with
the device once per iteration. Correspondences come from the nearest-
neighbour kernel K3 on CUDA tensors (kernels/neighbor.py) and from its plain
version on CPU tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from vtkcloudpoint_tpu.config import ICPConfig

from ..device import resolve_backend
from ..kernels.neighbor import nn_cuda, nn_plain
from ..ops import se3


class ICPResult(NamedTuple):
    r: torch.Tensor          # [3, 3] rotation
    t: torch.Tensor          # [3] translation
    error: torch.Tensor      # final summed squared correspondence distance
    iterations: torch.Tensor
    converged: torch.Tensor


def nn_correspond(query, ref, ref_valid, chunk: int = 2048,
                  backend: str = "auto"):
    """Nearest valid reference point per query: (idx i32[N], sqdist f[N]),
    ties to the lowest reference index."""
    if resolve_backend(backend, query.device) == "cuda":
        idx, d2 = nn_cuda(query, ref, ref_valid)
    else:
        idx, d2 = nn_plain(query, ref, ref_valid, chunk)
    return idx, d2.to(query.dtype)


def icp(source, source_valid, target, target_valid,
        cfg: ICPConfig = ICPConfig(), r0=None, t0=None, chunk: int = 2048,
        backend: str = "auto"):
    """Register source onto target: (R, t) with target ~= R source + t.

    source/target [N, 3]/[M, 3] padded, *_valid masks.
    Stops when |d - prev_d| < cfg.tol or after cfg.max_iterations, d being
    the summed squared correspondence distance over valid sources.
    """
    dtype, dev = source.dtype, source.device
    w_src = source_valid.to(dtype)
    n_src = torch.clamp_min(w_src.sum(), 1.0)
    if r0 is None:
        r0 = torch.eye(3, dtype=dtype, device=dev)
    if t0 is None:
        if cfg.start_by_matching_centroids:
            mean_s = (source * w_src[:, None]).sum(dim=0) / n_src
            w_tgt = target_valid.to(dtype)
            mean_t = (target * w_tgt[:, None]).sum(dim=0) / torch.clamp_min(
                w_tgt.sum(), 1.0)
            t0 = mean_t - r0 @ mean_s
        else:
            t0 = torch.zeros(3, dtype=dtype, device=dev)
    solve = se3.horn_solve if cfg.solver == "horn" else se3.kabsch_solve

    r, t = r0, t0
    d = torch.tensor(math.inf, dtype=dtype, device=dev)
    prev_d = d
    it = 0
    converged = False
    while not converged and it < cfg.max_iterations:
        p = se3.apply_rigid(r, t, source)
        idx, d2 = nn_correspond(p, target, target_valid, chunk, backend)
        y = target[idx.long()]
        d = torch.where(source_valid, d2, 0.0).sum()
        r1, t1 = solve(p, y, weights=w_src)
        r, t = se3.compose(r1, t1, r, t)
        converged = bool(torch.abs(d - prev_d) < cfg.tol)
        prev_d = d
        it += 1
    return ICPResult(r=r, t=t, error=d,
                     iterations=torch.tensor(it, dtype=torch.int32),
                     converged=torch.tensor(converged))
