"""Multi-scan trajectory registration: sequential scan-to-scan ICP odometry,
loop-closure detection and pose-graph assembly (port of
vtkcloudpoint_tpu.slam.trajectory).

Each scan registers to its predecessor (an ICP odometry edge); scans whose
odometry positions come close again get a loop-closure ICP edge; the pose
graph then relaxes drift globally (slam/ba.py). Every ICP goes through
``register.icp.icp`` with the caller's ``backend``: on CUDA tensors its
correspondences come from K3, the nearest-neighbour kernel. The JAX
``lax.map`` / ``lax.scan`` loops are Python loops; results stay on the
tensors' device.

``slam_pipeline`` and ``slam_pipeline_ba`` take an optional ``timer``: a
callable that, given a stage name (odometry, closures, posegraph,
observations, ba), returns a context manager run around that stage.
"""
from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch

from .. import device as _device  # noqa: F401  (full-f32 matmuls)
from ..config import ICPConfig
from ..ops import se3
from ..register.icp import icp
from .posegraph import PoseGraph


class Trajectory(NamedTuple):
    r: torch.Tensor   # [S,3,3] world-from-scan rotations
    t: torch.Tensor   # [S,3]


def _stage(timer, name):
    return timer(name) if timer is not None else contextlib.nullcontext()


def _stack(rs, ts, like):
    """(R [P,3,3], t [P,3]) of per-pair results, P possibly 0."""
    if not rs:
        return (like.new_zeros((0, 3, 3)), like.new_zeros((0, 3)))
    return torch.stack(rs), torch.stack(ts)


def _pair_edges(scans, scan_valid, first, last, cfg, backend):
    """ICP of scan k + 1 onto scan k for k in [first, last): (R, t)."""
    rs, ts = [], []
    for k in range(first, last):
        res = icp(scans[k + 1], scan_valid[k + 1], scans[k], scan_valid[k],
                  cfg, backend=backend)
        rs.append(res.r)
        ts.append(res.t)
    return _stack(rs, ts, scans)


def chain_poses(r_rel, t_rel) -> Trajectory:
    """World trajectory of relative edges: pose 0 at the identity, then
    world_from_next = world_from_prev o prev_from_next."""
    dt, dev = r_rel.dtype, r_rel.device
    rw, tw = torch.eye(3, dtype=dt, device=dev), torch.zeros(3, dtype=dt,
                                                             device=dev)
    rs, ts = [rw], [tw]
    for k in range(r_rel.shape[0]):
        rw, tw = se3.compose(rw, tw, r_rel[k], t_rel[k])
        rs.append(rw)
        ts.append(tw)
    return Trajectory(torch.stack(rs), torch.stack(ts))


def odometry_chain(scans, scan_valid, cfg: ICPConfig = ICPConfig(),
                   backend: str = "auto"):
    """Register each scan to its predecessor.

    scans: [S, N, 3] padded; scan_valid: [S, N].
    Returns (relative (r_rel [S-1,3,3], t_rel [S-1,3]) with
    scan_{s} ~= r_rel[s] scan_{s+1} + t_rel[s], world Trajectory).
    """
    r_rel, t_rel = _pair_edges(scans, scan_valid, 0, scans.shape[0] - 1,
                               cfg, backend)
    return (r_rel, t_rel), chain_poses(r_rel, t_rel)


def loop_closure_mask(positions, radius: float, min_separation: int = 5):
    """All-pairs closure test. positions: [S, 3].

    Returns (ii [P], jj [P], mask [P]) with P = S*(S-1)/2 upper-triangle
    pairs in (i, j) lexicographic order. As in the jitted JAX function
    (``radius`` traced), radius * radius is a product in the positions'
    precision on the device, not a Python double."""
    s = positions.shape[0]
    d2 = ((positions[:, None, :] - positions[None, :, :]) ** 2).sum(dim=-1)
    ii, jj = torch.triu_indices(s, s, offset=1, device=positions.device)
    r = torch.tensor(radius, dtype=positions.dtype, device=positions.device)
    mask = (jj - ii >= min_separation) & (d2[ii, jj] < r * r)
    return ii.to(torch.int32), jj.to(torch.int32), mask


def detect_loop_closures(traj: Trajectory, radius: float,
                         min_separation: int = 5):
    """Scan pairs whose odometry positions are within ``radius`` and at
    least ``min_separation`` apart in sequence: (i, j) i32 tensors on the
    trajectory's device."""
    li, lj, mask = loop_closure_mask(traj.t, radius, min_separation)
    return li[mask], lj[mask]


def closure_edges(scans, scan_valid, traj: Trajectory, li, lj,
                  cfg: ICPConfig = ICPConfig(), backend: str = "auto"):
    """ICP each loop-closure pair (j registered onto i), initialised from
    the current odometry estimate. Returns (r_meas [L,3,3], t_meas [L,3])."""
    rs, ts = [], []
    for i, j in zip(torch.as_tensor(li).tolist(),
                    torch.as_tensor(lj).tolist()):
        # init: i_from_j = world_from_i^{-1} o world_from_j
        ri, ti, rj, tj = traj.r[i], traj.t[i], traj.r[j], traj.t[j]
        res = icp(scans[j], scan_valid[j], scans[i], scan_valid[i], cfg,
                  r0=ri.T @ rj, t0=ri.T @ (tj - ti), backend=backend)
        rs.append(res.r)
        ts.append(res.t)
    return _stack(rs, ts, scans)


def build_pose_graph(r_rel, t_rel, li, lj, r_loop, t_loop,
                     odom_weight: float = 1.0, loop_weight: float = 1.0):
    """Assemble odometry + loop edges into a PoseGraph.

    Convention: edge (i, j) stores i_from_j measurements (scan_i frame), so
    edge residuals compare against X_i^{-1} X_j.
    """
    s1 = r_rel.shape[0]
    dt, dev = r_rel.dtype, r_rel.device
    li = torch.as_tensor(li, dtype=torch.int32, device=dev)
    lj = torch.as_tensor(lj, dtype=torch.int32, device=dev)
    ei = torch.cat([torch.arange(s1, dtype=torch.int32, device=dev), li])
    ej = torch.cat([torch.arange(1, s1 + 1, dtype=torch.int32, device=dev),
                    lj])
    w = torch.cat([torch.full((s1,), odom_weight, dtype=dt, device=dev),
                   torch.full((r_loop.shape[0],), loop_weight, dtype=dt,
                              device=dev)])
    return PoseGraph(edge_i=ei, edge_j=ej, r_meas=torch.cat([r_rel, r_loop]),
                     t_meas=torch.cat([t_rel, t_loop]), weight=w)


def _closures_and_graph(scans, scan_valid, r_rel, t_rel, traj, icp_cfg,
                        loop_radius, gn_iterations, damping, backend, timer):
    from .ba import optimize_pose_graph_sparse

    with _stage(timer, "closures"):
        li, lj = detect_loop_closures(traj, loop_radius)
        r_loop, t_loop = closure_edges(scans, scan_valid, traj, li, lj,
                                       icp_cfg, backend)
    with _stage(timer, "posegraph"):
        graph = build_pose_graph(r_rel, t_rel, li, lj, r_loop, t_loop)
        r_opt, t_opt, cost = optimize_pose_graph_sparse(
            traj.r, traj.t, graph, iterations=gn_iterations, damping=damping)
    return Trajectory(r_opt, t_opt), cost


def slam_pipeline(scans, scan_valid, icp_cfg: ICPConfig = ICPConfig(),
                  loop_radius: float = 5.0, gn_iterations: int = 10,
                  damping: float = 1e-6, backend: str = "auto", timer=None):
    """Full tier-4 pipeline: odometry -> loop closures -> pose-graph solve
    (block-sparse GN, slam.ba). Returns (Trajectory optimised, Trajectory
    odometry, cost)."""
    with _stage(timer, "odometry"):
        (r_rel, t_rel), traj = odometry_chain(scans, scan_valid, icp_cfg,
                                              backend)
    opt, cost = _closures_and_graph(scans, scan_valid, r_rel, t_rel, traj,
                                    icp_cfg, loop_radius, gn_iterations,
                                    damping, backend, timer)
    return opt, traj, cost


def odometry_chain_checkpointed(scans, scan_valid, manager,
                                cfg: ICPConfig = ICPConfig(),
                                every: int = 10, max_chunks=None,
                                backend: str = "auto"):
    """Resumable odometry: ICP pair edges computed ``every`` at a time, each
    chunk checkpointed through a utils.checkpoint.CheckpointManager.

    Per-pair ICP edges are independent, so the chunked run is bit-identical
    to odometry_chain. On restart the latest checkpoint restores and work
    continues from the first uncomputed pair. ``max_chunks`` bounds how many
    chunks this CALL computes (a kill/preemption stand-in for tests).

    Returns ((r_rel, t_rel), n_done) -- n_done == S-1 means complete.
    """
    from ..utils.resilience import Heartbeat

    n_pairs = scans.shape[0] - 1
    dt, dev = scans.dtype, scans.device
    template = (torch.zeros((n_pairs, 3, 3), dtype=dt, device=dev),
                torch.zeros((n_pairs, 3), dtype=dt, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    state, _ = manager.restore_latest(template)
    if state is None:
        r_rel = torch.eye(3, dtype=dt, device=dev).repeat(n_pairs, 1, 1)
        t_rel = torch.zeros((n_pairs, 3), dtype=dt, device=dev)
        done = 0
    else:
        r_rel, t_rel, done = state[0], state[1], int(state[2])

    hb = Heartbeat(os.path.join(manager.directory, "heartbeat"))
    chunks = 0
    while done < n_pairs:
        if max_chunks is not None and chunks >= max_chunks:
            break
        end = min(done + every, n_pairs)
        rr, tr = _pair_edges(scans, scan_valid, done, end, cfg, backend)
        r_rel = torch.cat([r_rel[:done], rr, r_rel[end:]])
        t_rel = torch.cat([t_rel[:done], tr, t_rel[end:]])
        done = end
        manager.save(done, (r_rel, t_rel,
                            torch.tensor(done, dtype=torch.int32)))
        hb.beat(f"odometry {done}/{n_pairs}")
        chunks += 1
    return (r_rel, t_rel), done


def slam_pipeline_checkpointed(scans, scan_valid, ckpt_dir: str,
                               icp_cfg: ICPConfig = ICPConfig(),
                               every: int = 10, loop_radius: float = 5.0,
                               gn_iterations: int = 10, damping: float = 1e-6,
                               max_chunks=None, backend: str = "auto"):
    """slam_pipeline with save/resume through ``ckpt_dir``: odometry
    checkpoints every ``every`` pairs; a killed run picks up from the last
    checkpoint and the final trajectory is bit-identical to the
    uninterrupted pipeline.

    Returns None while interrupted (max_chunks hit before completion);
    otherwise (Trajectory optimised, Trajectory odometry, cost)."""
    from ..utils.checkpoint import CheckpointManager

    manager = CheckpointManager(ckpt_dir)
    (r_rel, t_rel), done = odometry_chain_checkpointed(
        scans, scan_valid, manager, icp_cfg, every, max_chunks, backend)
    if done < scans.shape[0] - 1:
        return None
    traj = chain_poses(r_rel, t_rel)
    opt, cost = _closures_and_graph(scans, scan_valid, r_rel, t_rel, traj,
                                    icp_cfg, loop_radius, gn_iterations,
                                    damping, backend, None)
    return opt, traj, cost


def slam_pipeline_ba(scans, scan_valid, icp_cfg: ICPConfig = ICPConfig(),
                     loop_radius: float = 5.0, gn_iterations: int = 10,
                     damping: float = 1e-6, landmark_eps: float = 0.5,
                     landmark_min_pts: int = 5,
                     max_clusters_per_scan: int = 32,
                     ba_iterations: int = 8, ba_damping: float = 1e-4,
                     mesh=None, backend: str = "auto", timer=None):
    """Tier-4 pipeline with landmark refinement: odometry -> loop closures
    -> pose-graph GN -> cluster-centroid BA (slam.ba.observations_from_scans,
    then a Schur-eliminated bundle adjustment of poses and landmarks).
    With ``mesh`` (a parallel.mesh.Mesh) the BA observations pad to a
    multiple of the mesh size, each rank takes its shard and
    bundle_adjust_sharded sums the Schur moments across ranks.

    Returns (Trajectory ba, Trajectory posegraph, Trajectory odometry,
    dict(graph_cost, ba_cost, n_landmarks)).
    """
    from .ba import (Observations, bundle_adjust, bundle_adjust_sharded,
                     observations_from_scans, pad_observations)

    opt, odo, cost = slam_pipeline(scans, scan_valid, icp_cfg, loop_radius,
                                   gn_iterations, damping, backend, timer)
    with _stage(timer, "observations"):
        obs, lms0, n_lm = observations_from_scans(
            scans, scan_valid, opt.r, opt.t, landmark_eps, landmark_min_pts,
            max_clusters_per_scan)
    with _stage(timer, "ba"):
        if mesh is not None:
            from ..parallel.mesh import shard_blocks

            obs_loc = Observations(*(shard_blocks(mesh, x) for x in
                                     pad_observations(obs, mesh.size)))
            r_ba, t_ba, _, ba_cost = bundle_adjust_sharded(
                mesh, opt.r, opt.t, lms0, obs_loc, iterations=ba_iterations,
                damping=ba_damping)
        else:
            r_ba, t_ba, _, ba_cost = bundle_adjust(
                opt.r, opt.t, lms0, obs, iterations=ba_iterations,
                damping=ba_damping)
    stats = {"graph_cost": cost, "ba_cost": ba_cost, "n_landmarks": n_lm}
    return Trajectory(r_ba, t_ba), opt, odo, stats
