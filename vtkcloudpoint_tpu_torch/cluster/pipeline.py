"""End-to-end single-device clustering pipeline (port of
vtkcloudpoint_tpu.cluster.pipeline): partition -> per-block DBSCAN ->
cross-block fusion -> optional centroid merge -> centroids -> per-cluster
tables -> hull/MEC/rect in both coordinate systems.

``backend``: "auto" runs the hand-written kernels on CUDA tensors and the
plain versions on CPU tensors; "torch" runs the plain versions anywhere.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EngineConfig
from ..ops.geometry import cluster_shapes
from ..ops.metrics import coords_for_metric
from ..ops.segment import bucket_payload_by_cluster, cluster_stats
from ..utils.profiling import span, spanned
from .blocks import (assign_blocks_reference, gather_blocks,
                     partition_gather_sorted)
from .dbscan import dbscan_blocks_dispatch, dbscan_padded
from .fusion import merge_blocks, merge_centroid_clusters
from .halo_fusion import apply_halo_merge, halo_merge_labels


class ClusterResult(NamedTuple):
    label: torch.Tensor          # i32[N] global cluster ids (0 noise)
    n_clusters: torch.Tensor     # i32[]
    count: torch.Tensor          # i32[K+1] per-cluster point counts
    center3d: torch.Tensor       # f[K+1, 3]
    center2d: torch.Tensor       # f[K+1, 2]
    radius3d: torch.Tensor       # f[K+1] circumradius over (X, Y)
    radius2d: torch.Tensor       # f[K+1] circumradius over motor coords
    aspect: torch.Tensor         # f[K+1] min-rect long/short side ratio
    block_overflow: torch.Tensor  # i32[] points dropped by block capacity
    noise_overflow: torch.Tensor  # i32[]


@spanned
def cluster_scan(xyz, motor, valid, cfg: EngineConfig = EngineConfig(), *,
                 mode: str = "reference", max_blocks: int = 256,
                 quirks: bool = True, noise_capacity: int = 2048,
                 max_clusters: int = 1024, cluster_capacity: int = 1024,
                 max_hull: int = 64, centroid_merge: bool = False,
                 halo_merge: bool = False, halo_cap: int = 64,
                 backend: str = "auto"):
    """Cluster one scan. Returns ClusterResult.

    mode "reference" = the reference grid partition, "balanced" = Morton
    equal-count blocks. All capacities are fixed; the overflow counters
    report any truncation. ``halo_merge=True`` runs the cross-block halo
    union-find (cluster/halo_fusion.py, ``halo_cap`` boundary points per
    block) after the reference-style fusion: a beyond-reference merge of
    clusters split across blocks.

    Records a span ``cluster_scan`` with the children ``partition``,
    ``dbscan``, ``fusion`` (the halo union included), ``stats`` (the
    centroid merge included), ``bucket`` and ``shapes``.
    """
    n = xyz.shape[0]
    cc = cfg.cluster
    with span("partition"):
        coords = coords_for_metric(xyz, motor, cc.metric)
        if mode == "reference":
            part = assign_blocks_reference(motor, valid, cc.pts_in_cell)
            block_coords, block_valid, point_index, overflow = gather_blocks(
                coords, part["block"], valid, max_blocks, cc.block_capacity)
        elif mode == "balanced":
            block_coords, block_valid, point_index, overflow = (
                partition_gather_sorted(motor, valid, cc.block_capacity,
                                        max_blocks, coords=coords))
        else:
            raise ValueError(f"unknown mode {mode!r}")

    with span("dbscan"):
        db = dbscan_blocks_dispatch(
            block_coords.contiguous(), block_valid, cc.eps, cc.min_pts,
            cc.metric, max_iters=cc.propagate_max_iters, backend=backend)

    with span("fusion"):
        noise_capacity = min(noise_capacity, max_blocks * cc.block_capacity)
        fused = merge_blocks(
            db["label"], block_valid, block_coords, point_index, n, cc.eps,
            cc.min_pts, cc.metric, min_cluster_size=cc.min_cluster_size,
            quirks=quirks, noise_capacity=noise_capacity)
        label = fused["label"]
        n_clusters = fused["n_total"]

        if halo_merge:
            block_glabels = torch.where(
                point_index >= 0, label[point_index.clamp(0, n - 1).long()],
                0)
            hm = halo_merge_labels(block_coords, block_valid, block_glabels,
                                   db["core"], n_clusters, cc.eps, cc.metric,
                                   halo_cap=halo_cap, max_ids=max_clusters)
            label = apply_halo_merge(label, hm["remap"])
            n_clusters = hm["n_after"]

    with span("stats"):
        stats = cluster_stats(xyz, motor, label, valid, max_clusters)
        if centroid_merge:
            mg = merge_centroid_clusters(stats["center3d"][:, :2],
                                         stats["count"] > 0,
                                         cc.merge_threshold,
                                         cc.merge_min_pts)
            label = mg["remap"][label.clamp(0, max_clusters - 1).long()]
            n_clusters = mg["n_after"]
            stats = cluster_stats(xyz, motor, label, valid, max_clusters)

    # circumcircles in (X, Y) and in motor coordinates: one payload table,
    # one batched [2K] shapes call
    with span("bucket"):
        pay = (xyz[:, 0], xyz[:, 1], motor[:, 0], motor[:, 1])
        tabs, tval, runs, _ = bucket_payload_by_cluster(
            label, valid, pay, max_clusters, cluster_capacity)
        both = torch.cat([tabs[..., 0:2], tabs[..., 2:4]], dim=0).contiguous()
    with span("shapes"):
        sh = cluster_shapes(both, torch.cat([tval, tval]),
                            torch.cat([runs, runs]), max_hull=max_hull,
                            min_points=cfg.filters.circle_min_points,
                            backend=backend)
    return ClusterResult(
        label=label,
        n_clusters=n_clusters,
        count=stats["count"],
        center3d=stats["center3d"],
        center2d=stats["center2d"],
        radius3d=sh["radius"][:max_clusters],
        radius2d=sh["radius"][max_clusters:],
        aspect=sh["aspect"][:max_clusters],
        block_overflow=overflow.sum(dtype=torch.int32),
        noise_overflow=fused["noise_overflow"],
    )


def reject_clusters(result: ClusterResult, valid, radius_threshold: float,
                    aspect_threshold: float = 1e30):
    """Radius/aspect cluster rejection (Q10): rejected clusters' points drop
    out of the valid mask; ids are NOT renumbered. Returns (new_valid,
    rejected [K+1])."""
    rejected = (result.radius3d > radius_threshold) | (
        result.aspect > aspect_threshold)
    rejected = rejected & (result.count > 0)
    point_rejected = rejected[result.label.clamp(
        0, rejected.shape[0] - 1).long()]
    return valid & ~point_rejected, rejected


def single_block_dbscan(xyz, motor, valid, cfg: EngineConfig = EngineConfig()):
    """Tier-1 path: the whole scan as one block == plain reference DBSCAN."""
    coords = coords_for_metric(xyz, motor, cfg.cluster.metric)
    return dbscan_padded(coords, valid, cfg.cluster.eps, cfg.cluster.min_pts,
                         cfg.cluster.metric)
