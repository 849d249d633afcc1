"""Iterative Closest Point registration (port of
vtkcloudpoint_tpu.register.icp: nn_correspond, icp, ransac_init,
icp_ransac, icp_multistart).

The JAX while_loop becomes one of two loops. On CUDA float32 tensors with
the Horn solver, ``icp`` keeps the iteration's state on the card: each
iteration is the correspondence search and one step of kernels/icp.py's
state transition, and the host reads the done flag once per chunk of
iterations. Through the kernels those are two launches, K3
(kernels/neighbor.py) and K5 (kernels/icp.py); with backend="torch" their
plain versions, ``nn_plain`` and ``icp_step_plain``, compute the same
function. Everywhere else (CPU tensors, the Kabsch solver,
``nn_grid.icp_grid``) the Python loop of ``icp_loop`` runs, reading
``converged`` once per iteration, with correspondences from K3 on CUDA
tensors and from its plain version on CPU tensors.

RANSAC and multi-start draw their randomness from an explicit
``torch.Generator`` (seeded 0 when none is given), never from the global
RNG. jax.random and torch give different numbers for one seed, so each is
split into a sampling step and a deterministic step that takes the samples
(``ransac_sample`` / ``ransac_score``, ``multistart_rotations`` /
``icp_best_of``); the tests feed the JAX package's own samples to the
deterministic step.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import ICPConfig
from ..device import DEFAULT_DEVICE, resolve_backend, resolve_device
from ..kernels import icp as k_icp
from ..kernels.neighbor import nn_cuda, nn_plain
from ..ops import se3
from ..utils import profiling as prof


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


def _start(source, source_valid, target, target_valid, cfg: ICPConfig,
           r0, t0):
    """The start pose (R, t): r0 or the identity; t0, or the valid
    centroids matched under r0 (cfg.start_by_matching_centroids), or 0."""
    dtype, dev = source.dtype, source.device
    if r0 is None:
        r0 = torch.eye(3, dtype=dtype, device=dev)
    if t0 is None:
        if cfg.start_by_matching_centroids:
            w_src = source_valid.to(dtype)
            mean_s = ((source * w_src[:, None]).sum(dim=0)
                      / torch.clamp_min(w_src.sum(), 1.0))
            w_tgt = target_valid.to(dtype)
            mean_t = ((target * w_tgt[:, None]).sum(dim=0)
                      / torch.clamp_min(w_tgt.sum(), 1.0))
            t0 = mean_t - r0 @ mean_s
        else:
            t0 = torch.zeros(3, dtype=dtype, device=dev)
    return r0, t0


def icp_loop(source, source_valid, target, target_valid, cfg: ICPConfig,
             r0, t0, correspond):
    """The Python ICP loop: ``icp`` off the card's loop (CPU tensors, the
    Kabsch solver) and ``nn_grid.icp_grid``. ``correspond(p)`` gives
    (idx, d2, w) for the moved sources p: the nearest target, its squared
    distance and the bool mask of the sources that enter the solve and the
    error. Records a span ``icp`` counting its ``iterations``."""
    with prof.span("icp"):
        dtype, dev = source.dtype, source.device
        r, t = _start(source, source_valid, target, target_valid, cfg, r0,
                      t0)
        solve = se3.horn_solve if cfg.solver == "horn" else se3.kabsch_solve
        d = prof.sync(torch.tensor, math.inf, dtype=dtype, device=dev)
        prev_d = d
        it = 0
        converged = False
        while not converged and it < cfg.max_iterations:
            p = se3.apply_rigid(r, t, source)
            idx, d2, w = correspond(p)
            y = target[idx.long()]
            d = torch.where(w, d2, 0.0).sum()
            r1, t1 = solve(p, y, weights=w.to(dtype))
            r, t = se3.compose(r1, t1, r, t)
            converged = prof.sync(bool, torch.abs(d - prev_d) < cfg.tol)
            prev_d = d
            it += 1
            prof.count("iterations")
        return ICPResult(r=r, t=t, error=d,
                         iterations=torch.tensor(it, dtype=torch.int32),
                         converged=torch.tensor(converged))


def icp(source, source_valid, target, target_valid,
        cfg: ICPConfig = ICPConfig(), r0=None, t0=None, chunk: int = 2048,
        backend: str = "auto"):
    """Register source onto target: (R, t) with target ~= R source + t.

    source/target [N, 3]/[M, 3] padded, *_valid masks.
    Stops when |d - prev_d| < cfg.tol or after cfg.max_iterations, d being
    the summed squared correspondence distance over valid sources. CUDA
    float32 tensors with the Horn solver take ``icp_on_card``; everything
    else ``icp_loop``.
    """
    if (source.is_cuda and source.dtype == torch.float32
            and target.dtype == torch.float32 and cfg.solver == "horn"):
        return icp_on_card(source, source_valid, target, target_valid, cfg,
                           r0, t0, chunk, backend)

    def correspond(p):
        idx, d2 = nn_correspond(p, target, target_valid, chunk, backend)
        return idx, d2, source_valid

    return icp_loop(source, source_valid, target, target_valid, cfg, r0, t0,
                    correspond)


def icp_on_card(source, source_valid, target, target_valid, cfg: ICPConfig,
                r0=None, t0=None, chunk: int = 2048, backend: str = "auto"):
    """``icp`` on CUDA float32 tensors with the Horn solver: the state of
    the iteration lives on the card, each iteration is a correspondence
    search and a step (K3 and K5 through the kernels, ``nn_plain`` and
    ``icp_step_plain`` with backend="torch"), and the host reads the flags
    once per chunk of ``kernels.icp.chunk_schedule``. Iterations launched
    after the loop is done are no-ops, so the result does not depend on the
    chunks. Records a span ``icp`` counting its ``iterations`` (those that
    ran, read from the card) and the iterations ``launched``, no-ops
    included."""
    if resolve_backend(backend, source.device) == "cuda":
        nn, step = nn_cuda, k_icp.icp_step_cuda
    else:
        def nn(p, ref, ref_valid):
            return nn_plain(p, ref, ref_valid, chunk)
        step = k_icp.icp_step_plain
    with prof.span("icp"):
        r, t = _start(source, source_valid, target, target_valid, cfg, r0,
                      t0)
        source, target = source.contiguous(), target.contiguous()
        source_valid = source_valid.contiguous()
        state = k_icp.init_state(r, t, source)
        it, converged = 0, False
        for size in k_icp.chunk_schedule(cfg.max_iterations):
            for _ in range(size):
                idx, d2 = nn(state.p, target, target_valid)
                step(state, idx, d2, source, source_valid, target, cfg.tol,
                     cfg.max_iterations)
            prof.count("launched", size)
            it, converged, done = prof.sync(state.flags[:3].tolist)
            if done:
                break
        prof.count("iterations", it)
        # copies: the result shares no storage with the loop's state
        return ICPResult(r=state.pose[:9].view(3, 3).clone(),
                         t=state.pose[9:12].clone(),
                         error=state.pose[12].clone(),
                         iterations=torch.tensor(it, dtype=torch.int32),
                         converged=torch.tensor(bool(converged)))


def _generator(generator):
    return torch.Generator().manual_seed(0) if generator is None \
        else generator


def ransac_sample(source_valid, target_valid, iters: int, generator=None):
    """Index pairs of the RANSAC hypotheses: (si [iters, 2], tj [iters, 2])
    int64, each pair drawn WITH replacement (jax.random.choice's default)
    with probability proportional to validity. Drawn on the generator's
    device, returned on source_valid's."""
    g = _generator(generator)

    def draw(valid):
        w = prof.sync(valid.to, device=g.device, dtype=torch.float32)
        w = (w / w.sum()).expand(iters, -1)
        return prof.sync(torch.multinomial(w, 2, replacement=True,
                                           generator=g).to,
                         source_valid.device)

    return draw(source_valid), draw(target_valid)


def ransac_score(source, source_valid, target, target_valid,
                 inlier_threshold: float, si, tj, chunk: int = 2048,
                 backend: str = "auto"):
    """Score every hypothesis (source pair si[h] -> target pair tj[h]):
    the z-rotation + translation mapping one pair onto the other, scored by
    the valid sources whose nearest target lies within inlier_threshold;
    pairs whose lengths differ by 2 * inlier_threshold or more score 0.
    All hypotheses' moved sources form ONE [iters * N, 3] nearest-neighbour
    query. Returns (rs [iters, 3, 3], ts [iters, 3], scores [iters])."""
    s1, s2 = source[si[:, 0]], source[si[:, 1]]
    t1, t2 = target[tj[:, 0]], target[tj[:, 1]]
    ang = (torch.atan2(t2[:, 1] - t1[:, 1], t2[:, 0] - t1[:, 0])
           - torch.atan2(s2[:, 1] - s1[:, 1], s2[:, 0] - s1[:, 0]))
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rs = torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    ts = t1 - (rs @ s1[:, :, None])[:, :, 0]
    len_ok = (torch.linalg.norm(s2 - s1, dim=-1)
              - torch.linalg.norm(t2 - t1, dim=-1)).abs() \
        < 2.0 * inlier_threshold
    moved = source[None] @ rs.transpose(1, 2) + ts[:, None, :]
    _, d2 = nn_correspond(moved.reshape(-1, 3).contiguous(), target,
                          target_valid, chunk, backend)
    thr2 = float(np.float32(inlier_threshold ** 2))
    hit = source_valid[None, :] & (d2.reshape(si.shape[0], -1) < thr2)
    inliers = hit.to(source.dtype).sum(dim=1)
    return rs, ts, torch.where(len_ok, inliers, 0.0)


def ransac_init(source, source_valid, target, target_valid,
                inlier_threshold: float, iters: int = 64, generator=None,
                chunk: int = 2048, backend: str = "auto"):
    """Congruent-pair RANSAC for a rigid, 2D-dominant initial pose. Returns
    (r0, t0, best_inliers), the first best hypothesis on ties. Refine with
    icp(r0=..., t0=...)."""
    si, tj = ransac_sample(source_valid, target_valid, iters, generator)
    rs, ts, scores = ransac_score(source, source_valid, target,
                                  target_valid, inlier_threshold, si, tj,
                                  chunk, backend)
    best = torch.argmax(scores)
    return (prof.sync(lambda: rs[best]), prof.sync(lambda: ts[best]),
            prof.sync(lambda: scores[best]))


def icp_ransac(source, source_valid, target, target_valid,
               cfg: ICPConfig = ICPConfig(), generator=None,
               chunk: int = 2048, backend: str = "auto"):
    """RANSAC init (cfg.ransac_iters hypotheses) + ICP refine."""
    r0, t0, _ = ransac_init(source, source_valid, target, target_valid,
                            cfg.ransac_inlier_threshold,
                            max(int(cfg.ransac_iters), 1), generator, chunk,
                            backend)
    return icp(source, source_valid, target, target_valid, cfg, r0=r0,
               t0=t0, chunk=chunk, backend=backend)


def multistart_rotations(k: int, generator=None, dtype=torch.float32,
                         device=DEFAULT_DEVICE):
    """The k initial rotations of icp_multistart, [k, 3, 3] on ``device``
    (default the card): (k + 1) // 2 uniform z-spins (deterministic), then
    random rotations from the generator."""
    device = resolve_device(device)
    g = _generator(generator)
    n_z = (k + 1) // 2
    thetas = torch.arange(n_z, dtype=dtype) * (2.0 * math.pi / max(n_z, 1))
    rots = [se3.rotz(th) for th in thetas]
    rots += [se3.random_rotation(g, dtype) for _ in range(k - n_z)]
    return torch.stack([prof.sync(r.to, device=device, dtype=dtype)
                        for r in rots])


def icp_best_of(source, source_valid, target, target_valid,
                cfg: ICPConfig, r0s, chunk: int = 2048,
                backend: str = "auto"):
    """ICP from each initial rotation r0s [K, 3, 3]; the run of lowest final
    error, the first on ties."""
    runs = [icp(source, source_valid, target, target_valid, cfg, r0=r0,
                chunk=chunk, backend=backend) for r0 in r0s]
    best = prof.sync(int, torch.argmin(torch.stack([r.error
                                                    for r in runs])))
    return runs[best]


def icp_multistart(source, source_valid, target, target_valid,
                   cfg: ICPConfig = ICPConfig(), generator=None,
                   chunk: int = 2048, backend: str = "auto"):
    """Multi-start ICP: cfg.num_starts initial rotations (uniform z-spins,
    then random ones), keeping the lowest-error run."""
    k = max(int(cfg.num_starts), 1)
    if k == 1:
        return icp(source, source_valid, target, target_valid, cfg,
                   chunk=chunk, backend=backend)
    r0s = multistart_rotations(k, generator, source.dtype, source.device)
    return icp_best_of(source, source_valid, target, target_valid, cfg, r0s,
                       chunk, backend)
