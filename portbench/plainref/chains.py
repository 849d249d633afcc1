"""The reference's three jobs, end to end, from the benchmark's generated
inputs: the scan chain (partition, per-block DBSCAN, fusion, statistics,
tables, shapes, ICP), the Engine session and the SLAM pipeline. Each
follows the program's entry point step for step (``cluster_scan``,
``Engine``'s methods, ``slam_pipeline_ba``) through the plain versions
copied beside this file.

``*_lowered`` gives the control: a stage computed in the nearest
precision below float32 that moves it beyond what a sound run reads.
Matmuls run in TF32 (the configurations state float32 with TF32 off); that
is the control of the SLAM pipeline. A stage with no matmul (DBSCAN, the
segment sums, the shapes), and the ICP registrations, which TF32 moves no
further than the float64 witness does (their products are three wide),
take their float32 inputs rounded to bfloat16.

``*_witness`` gives a sound run that rounds otherwise: the float stages in
float64 from the same float32 inputs, under the reference's own exact
decisions (labels, tables, rejections, matches). Its gap from the
reference is what a sound float32 program that sums in another order may
read; the limits are set above it.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

from .cluster.blocks import partition_gather_sorted
from .cluster.dbscan import dbscan_blocks
from .cluster.fusion import merge_blocks
from .config import ClusterConfig, EngineConfig, ICPConfig, ImportConfig
from .data.convert import distance_window
from .io.ingest import import_scan_arrays
from .ops.geometry import cluster_shapes, convex_hull
from .ops.metrics import coords_for_metric
from .ops.segment import bucket_payload_by_cluster, cluster_stats
from .register.coarse import auto_rescale_centers
from .register.icp import (icp, icp_best_of, icp_ransac,
                           multistart_rotations)
from .register.matching import assign_matches, registration_rmse
from .slam.trajectory import detect_loop_closures, slam_pipeline_ba


def bf16(x):
    """float32 values rounded to bfloat16 and back."""
    return x.to(torch.bfloat16).to(x.dtype)


@contextlib.contextmanager
def tf32():
    """Matmuls and convolutions in TF32 inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


# ---- the scan -------------------------------------------------------------

def cluster_cfg(cfg: dict) -> ClusterConfig:
    return ClusterConfig(eps=cfg["eps"], min_pts=cfg["min_pts"],
                         block_capacity=cfg["block_capacity"],
                         metric=cfg["metric"])


def labels(xyz, motor, valid, cfg: dict):
    """Partition, per-block DBSCAN and fusion: (label i32[N], n_total,
    block valid [B, cap])."""
    cc = cluster_cfg(cfg)
    n = xyz.shape[0]
    coords = coords_for_metric(xyz, motor, cc.metric)
    bc, bv, pidx, _ = partition_gather_sorted(
        motor, valid, cc.block_capacity, cfg["max_blocks"], coords=coords)
    db = dbscan_blocks(bc.contiguous(), bv, cc.eps, cc.min_pts, cc.metric,
                       cc.propagate_max_iters)
    noise_cap = min(cfg["noise_capacity"],
                    cfg["max_blocks"] * cc.block_capacity)
    fused = merge_blocks(db["label"], bv, bc, pidx, n, cc.eps, cc.min_pts,
                         cc.metric, min_cluster_size=cc.min_cluster_size,
                         quirks=cfg["quirks"], noise_capacity=noise_cap)
    return fused["label"], int(fused["n_total"]), bv


def tables(xyz, motor, label, valid, cfg: dict):
    """cluster_scan's one payload table of both coordinate systems:
    (points [2K, cap, 2], valid [2K, cap], counts [2K])."""
    pay = (xyz[:, 0], xyz[:, 1], motor[:, 0], motor[:, 1])
    tabs, tval, runs, _ = bucket_payload_by_cluster(
        label, valid, pay, cfg["max_clusters"], cfg["cluster_capacity"])
    both = torch.cat([tabs[..., 0:2], tabs[..., 2:4]], dim=0).contiguous()
    return both, torch.cat([tval, tval]), torch.cat([runs, runs])


def shapes(both, bval, bcnt, cfg: dict, max_hull: int):
    k = cfg["max_clusters"]
    sh = cluster_shapes(both, bval, bcnt, max_hull=max_hull,
                        min_points=EngineConfig().filters.circle_min_points)
    return {"radius3d": sh["radius"][:k], "radius2d": sh["radius"][k:],
            "aspect": sh["aspect"][:k]}


def hull_sizes(both, bval, max_hull: int):
    """Hull size of each table (the roofline count of K2)."""
    return convex_hull(both, bval, max_hull)[1].sum(dim=1)


def scan_icp(center3d, count, truth, cfg: dict):
    icfg = ICPConfig(max_iterations=cfg["icp_max_iterations"])
    tv = torch.ones(truth.shape[0], dtype=torch.bool, device=truth.device)
    return icp(center3d, count > 0, truth, tv, icfg, chunk=cfg["icp_chunk"],
               backend="torch")


def scan(xyz, motor, valid, truth, cfg: dict, with_icp: bool,
         max_hull=None):
    """The scan job: every output the comparison reads."""
    max_hull = cfg["max_hull"] if max_hull is None else max_hull
    label, n_total, bv = labels(xyz, motor, valid, cfg)
    st = cluster_stats(xyz, motor, label, valid, cfg["max_clusters"])
    both, bval, bcnt = tables(xyz, motor, label, valid, cfg)
    out = SimpleNamespace(label=label, n_clusters=n_total,
                          count=st["count"], center3d=st["center3d"],
                          center2d=st["center2d"],
                          block_valid=bv, tables=(both, bval, bcnt),
                          **shapes(both, bval, bcnt, cfg, max_hull))
    if with_icp:
        reg = scan_icp(st["center3d"], st["count"], truth, cfg)
        out.r, out.t, out.iterations = reg.r, reg.t, int(reg.iterations)
    return out


def scan_lowered(ref, xyz, motor, valid, truth, cfg: dict, with_icp: bool,
                 max_hull=None):
    """The control of the scan job, stage by stage from the reference's own
    float32 stage inputs."""
    max_hull = cfg["max_hull"] if max_hull is None else max_hull
    label, n_total, _ = labels(bf16(xyz), bf16(motor), valid, cfg)
    st = cluster_stats(bf16(xyz), bf16(motor), ref.label, valid,
                       cfg["max_clusters"])
    both, bval, bcnt = ref.tables
    out = SimpleNamespace(label=label, n_clusters=n_total,
                          count=st["count"], center3d=st["center3d"],
                          center2d=st["center2d"],
                          **shapes(bf16(both), bval, bcnt, cfg, max_hull))
    if with_icp:
        with tf32():
            reg = scan_icp(bf16(ref.center3d), ref.count, bf16(truth), cfg)
        out.r, out.t, out.iterations = reg.r, reg.t, int(reg.iterations)
    return out


def scan_witness(ref, xyz, motor, valid, truth, cfg: dict, with_icp: bool,
                 max_hull=None):
    """The scan job's float stages in float64 under the reference's labels
    and tables: centroids, shapes, and the ICP of the float64 centres."""
    max_hull = cfg["max_hull"] if max_hull is None else max_hull
    st = cluster_stats(xyz.double(), motor.double(), ref.label, valid,
                       cfg["max_clusters"])
    both, bval, bcnt = ref.tables
    out = SimpleNamespace(label=ref.label, n_clusters=ref.n_clusters,
                          count=st["count"], center3d=st["center3d"],
                          center2d=st["center2d"],
                          **shapes(both.double(), bval, bcnt, cfg, max_hull))
    if with_icp:
        reg = scan_icp(st["center3d"], st["count"], truth.double(), cfg)
        out.r, out.t, out.iterations = reg.r, reg.t, int(reg.iterations)
    return out


# ---- the Engine session -----------------------------------------------------

def _live(count):
    return (count > 0) & (torch.arange(count.shape[0],
                                       device=count.device) > 0)


def coarse_align(center3d, count, truth_xyz):
    """Engine.coarse_align with no region mask: (centers_tmp, truth_tmp)."""
    tvalid = torch.ones(truth_xyz.shape[0], dtype=torch.bool,
                        device=truth_xyz.device)
    tmp_xy, _, _ = auto_rescale_centers(center3d[:, :2], _live(count),
                                        truth_xyz[:, :2], tvalid)
    centers_tmp = torch.cat([tmp_xy, torch.zeros_like(tmp_xy[:, :1])], -1)
    t_xy = truth_xyz[:, :2]
    return centers_tmp, torch.cat([t_xy, torch.zeros_like(t_xy[:, :1])], -1)


def session_registrations(src, cvalid, tgt, traffic: dict, gen_seed: int):
    """The three registrations of the session: coarse ICP, multi-start,
    RANSAC, each from the coarse-aligned centres."""
    tvalid = torch.ones(tgt.shape[0], dtype=torch.bool, device=tgt.device)
    reg = icp(src, cvalid, tgt, tvalid, ICPConfig(), backend="torch")
    # icp_multistart with more than one start: the starts drawn as the
    # program draws them, in float32 whatever the centres' precision
    r0s = multistart_rotations(traffic["num_starts"],
                               torch.Generator().manual_seed(gen_seed),
                               torch.float32, src.device).to(src.dtype)
    ms = icp_best_of(src, cvalid, tgt, tvalid,
                     ICPConfig(num_starts=traffic["num_starts"]), r0s,
                     backend="torch")
    rs = icp_ransac(src, cvalid, tgt, tvalid,
                    ICPConfig(ransac_iters=traffic["ransac_iters"]),
                    torch.Generator().manual_seed(gen_seed),
                    backend="torch")
    return {"coarse": reg, "multistart": ms, "ransac": rs}


def session(motor, dist, truth_xyz, cfg: dict, traffic: dict, gen_seed: int,
            device):
    """The Engine session's steps: import, distance filter, cluster, radius
    rejection, three registrations, match, centroid export (as numbers)."""
    batch = import_scan_arrays(motor, dist, ImportConfig(),
                               traffic["capacity"], device=device)
    keep = distance_window(batch.rng, traffic["dis_min"], traffic["dis_max"])
    valid = batch.valid & keep
    sc = scan(batch.xyz, batch.motor, valid, None, cfg, with_icp=False,
              max_hull=traffic["max_hull"])
    rejected = (sc.radius3d > traffic["reject_radius"]) & (sc.count > 0)
    truth = torch.as_tensor(truth_xyz, device=device)
    src, tgt = coarse_align(sc.center3d, sc.count, truth)
    cvalid = _live(sc.count)
    regs = session_registrations(src, cvalid, tgt, traffic, gen_seed)
    m = assign_matches(src, cvalid, tgt,
                       torch.ones(tgt.shape[0], dtype=torch.bool,
                                  device=device),
                       regs["coarse"].r, regs["coarse"].t,
                       ICPConfig().match_distance, backend="torch")
    m["rmse"] = registration_rmse(m, tgt)
    return SimpleNamespace(scan=sc, label=sc.label, rejected=rejected,
                           regs=regs, src=src, tgt=tgt, cvalid=cvalid,
                           match=m, centroids=sc.center3d[cvalid],
                           xyz=batch.xyz, motor=batch.motor, valid=valid)


def session_lowered(ref, motor, dist, truth_xyz, cfg: dict, traffic: dict,
                    gen_seed: int, device):
    """The control of the session: the exact outputs (labels, rejection,
    matches) from bfloat16-rounded scan inputs end to end; the
    registrations, in TF32, from the reference's coarse-aligned centres
    rounded to bfloat16; the centroids from bfloat16-rounded points under
    the reference's labels."""
    low = session(bf16(torch.as_tensor(motor)).numpy(),
                  bf16(torch.as_tensor(dist)).numpy(), truth_xyz, cfg,
                  traffic, gen_seed, device)
    with tf32():
        regs = session_registrations(bf16(ref.src), ref.cvalid,
                                     bf16(ref.tgt), traffic, gen_seed)
    st = cluster_stats(bf16(ref.xyz), bf16(ref.motor), ref.label, ref.valid,
                       cfg["max_clusters"])
    low.regs = regs
    low.centroids = st["center3d"][ref.cvalid]
    return low


def session_witness(ref, truth_xyz, cfg: dict, traffic: dict,
                    gen_seed: int):
    """The session's float stages in float64 under the reference's labels:
    the centroids (written at the traffic's ``export_decimals``), the
    coarse alignment and the three registrations."""
    st = cluster_stats(ref.xyz.double(), ref.motor.double(), ref.label,
                       ref.valid, cfg["max_clusters"])
    truth = torch.as_tensor(truth_xyz, device=ref.xyz.device).double()
    src, tgt = coarse_align(st["center3d"], ref.scan.count, truth)
    regs = session_registrations(src, ref.cvalid, tgt, traffic, gen_seed)
    cents = torch.round(st["center3d"][ref.cvalid],
                        decimals=traffic["export_decimals"])
    return SimpleNamespace(label=ref.label, rejected=ref.rejected,
                           regs=regs, match=ref.match, centroids=cents)


# ---- the SLAM pipeline ------------------------------------------------------

def slam(scans, valid, cfg: dict):
    """slam_pipeline_ba at the configuration's settings, and the closure
    pairs of its odometry."""
    icfg = ICPConfig(max_iterations=cfg["icp_max_iterations"],
                     tol=cfg["icp_tol"])
    ba, pg, odo, stats = slam_pipeline_ba(
        scans, valid, icfg, loop_radius=cfg["loop_radius"],
        gn_iterations=cfg["gn_iterations"],
        landmark_eps=cfg["landmark_eps"],
        landmark_min_pts=cfg["landmark_min_pts"],
        max_clusters_per_scan=cfg["max_clusters_per_scan"],
        ba_iterations=cfg["ba_iterations"], backend="torch")
    li, lj = detect_loop_closures(odo, cfg["loop_radius"])
    return SimpleNamespace(odometry=odo, posegraph=pg, ba=ba,
                           pairs=(li.tolist(), lj.tolist()),
                           n_landmarks=int(stats["n_landmarks"]))


def slam_lowered(ref, scans, valid, cfg: dict):
    """The control of the SLAM job: the pipeline with TF32 matmuls."""
    with tf32():
        return slam(scans, valid, cfg)


def slam_witness(ref, scans, valid, cfg: dict):
    """The SLAM job in float64 from the same float32 scans."""
    return slam(scans.double(), valid, cfg)
