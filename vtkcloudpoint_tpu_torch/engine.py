"""High-level engine facade (port of vtkcloudpoint_tpu.engine).

One object that carries the config and a device and walks the workflow:
import -> filter -> cluster -> reject -> coarse align -> ICP -> match ->
export. Every step delegates to the port's modules; exports go through the
port's copies of the numpy-only loaders, vtkio and snapshot.

    eng = Engine(EngineConfig())          # on the card; device="cpu" too
    batch, names = eng.import_folder("scans/")
    batch = eng.filter_by_distance(batch, 2.0, 300.0)
    result = eng.cluster(batch)
    batch, rejected = eng.reject_by_radius(batch, result, radius=0.5)
    reg = eng.register_to_truth(result, truth_xyz)
    matches = eng.match(result, truth_xyz, reg)
    eng.export_scene("out/scene", batch, result, matches)

``cfg.backend``: "auto" runs the hand-written kernels on a CUDA device and
the plain PyTorch versions on the CPU; "torch" runs the plain versions on
any device; the JAX values "pallas" and "jnp" raise.
"""
from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np
import torch

from .cluster.grid import dbscan_grid, grid_metric
from .cluster.pipeline import ClusterResult, cluster_scan, reject_clusters
from .data.convert import distance_window
from .config import EngineConfig
from .data.pointbatch import PointBatch, _host
from .device import DEFAULT_DEVICE, resolve_backend, resolve_device
from .io import loaders
from .io.ingest import import_scan_arrays, import_scan_folder
from .ops.metrics import coords_for_metric
from .ops.segment import cluster_stats
from .register.coarse import auto_rescale_centers, rescale_region_truth
from .register.icp import ICPResult, icp, icp_multistart, icp_ransac
from .register.matching import assign_matches, registration_rmse
from .viz import vtkio


def _live_clusters(result: ClusterResult):
    """Valid centroid rows: nonempty and not the noise row 0."""
    k = result.count.shape[0]
    return (result.count > 0) & (torch.arange(
        k, device=result.count.device) > 0)


class Engine:
    def __init__(self, cfg: EngineConfig = EngineConfig(), *,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = resolve_backend(cfg.backend, self.device)
        self.export_bit = 4  # decimal places for exports; import sniffs it

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(_host(x)).to(device=self.device, dtype=dtype)

    # ---- ingestion (C2-C5) ----

    def import_folder(self, folder: str, pattern: str = "*.txt"):
        batch, names = import_scan_folder(folder, self.cfg.imports, pattern,
                                          device=self.device)
        # the first file's decimal precision drives export formatting
        # (FrmMain.cs:984 "bit")
        files = sorted(glob.glob(os.path.join(folder, pattern)))
        if files:
            self.export_bit = loaders.sniff_decimals(files[0])
        return batch, names

    def import_arrays(self, motor, rng, capacity: Optional[int] = None):
        return import_scan_arrays(motor, rng, self.cfg.imports, capacity,
                                  device=self.device)

    def filter_by_distance(self, batch: PointBatch, dis_min: float,
                           dis_max: float, path_id: Optional[int] = None
                           ) -> PointBatch:
        """Distance-window filter (Tools.FilterByDistance_*); path_id limits
        it to one source file (FrmMain.cs:1116-1130)."""
        keep = distance_window(batch.rng, dis_min, dis_max)
        if path_id is not None:
            keep = keep | (batch.path_id != path_id)
        return batch.with_valid(batch.valid & keep)

    def set_file_visibility(self, batch: PointBatch, visible) -> PointBatch:
        """Per-file show/hide (treeView1_AfterCheck, FrmMain.cs:2497-2609);
        ``visible`` is a bool array indexed by path_id."""
        visible = self._tensor(visible, torch.bool)
        show = visible[batch.path_id.clamp(0, visible.shape[0] - 1).long()]
        return batch.with_valid(batch.valid & show)

    # ---- clustering (C6-C15) ----

    def cluster(self, batch: PointBatch, mode: str = "reference",
                centroid_merge: bool = False, quirks: bool = False,
                **caps) -> ClusterResult:
        """cluster_scan with the Engine's capacities; quirks=True
        reproduces the reference's merge quirks."""
        n = batch.capacity
        defaults = dict(
            max_blocks=max(64, n // max(self.cfg.cluster.pts_in_cell, 1)),
            max_clusters=1024,
            cluster_capacity=1024,
            noise_capacity=4096,
        )
        defaults.update(caps)
        return cluster_scan(batch.xyz, batch.motor, batch.valid, self.cfg,
                            mode=mode, quirks=quirks,
                            centroid_merge=centroid_merge,
                            backend=self.backend, **defaults)

    def cluster_grid(self, batch: PointBatch, cell_cap: int = 64,
                     max_clusters: int = 4096):
        """Tier-3 global path: grid-hash DBSCAN over the whole scan (no
        blocks) + centroids. Equal to plain reference DBSCAN while the
        returned overflow is 0. signed_sum_xy has no grid form: motor L1
        serves it, as in the JAX package. Returns (dbscan_grid's dict,
        cluster_stats' dict)."""
        metric = self.cfg.cluster.metric
        coords = coords_for_metric(batch.xyz, batch.motor, metric)
        gm = grid_metric(metric, coords.shape[-1])
        if gm is None:
            coords, gm = batch.motor, "l1_motor"
        out = dbscan_grid(coords.contiguous(), batch.valid,
                          self.cfg.cluster.eps, self.cfg.cluster.min_pts, gm,
                          cell_cap=cell_cap)
        stats = cluster_stats(batch.xyz, batch.motor, out["label"],
                              batch.valid, max_clusters)
        return out, stats

    def cluster_sharded(self, batch: PointBatch, mesh=None,
                        halo_mode: str = "hier", block_capacity: int = None,
                        density: float = None, **kw):
        """Multi-device clustering (tier 5), this rank's part: every rank
        holds the whole batch, cuts the same Morton blocks and clusters its
        shard of them (parallel.sharded.sharded_blocked_dbscan: per-rank
        DBSCAN, noise re-cluster, hierarchical halo union). ``mesh``
        defaults to the mesh of every rank on the Engine's device (an
        initialised process group is needed, parallel.distributed).

        ``density`` (points per unit metric area), when given, sizes every
        capacity through ParallelConfig.size_caps so a sized run cannot
        silently drop points; otherwise pass explicit caps in **kw.
        Returns the sharded result dict: this rank's labels in BLOCK layout
        [B/n, cap] and "point_index" [B/n, cap] mapping its slots to batch
        rows (-1 padding), with the replicated n_total and overflows.
        """
        from .config import ParallelConfig
        from .cluster.blocks import (assign_blocks_balanced,
                                     gather_blocks_ordered)
        from .parallel.mesh import make_mesh, shard_blocks
        from .parallel.sharded import sharded_blocked_dbscan

        mesh = mesh if mesh is not None else make_mesh(device=self.device)
        ndev = mesh.size
        cap = block_capacity or self.cfg.cluster.block_capacity
        coords = coords_for_metric(batch.xyz, batch.motor,
                                   self.cfg.cluster.metric)
        b = -(-batch.capacity // cap)
        b += (-b) % ndev                      # blocks divisible by the mesh
        part = assign_blocks_balanced(batch.motor, batch.valid, cap)
        bc, bv, pidx, _ = gather_blocks_ordered(
            coords, part["order"], batch.valid, b, cap)
        if density is not None:
            caps = ParallelConfig.size_caps(
                self.cfg.cluster.eps, density, cap,
                blocks_per_device=b // ndev, noise_frac=0.01)
            kw.setdefault("halo_cap", caps["halo_cap"])
            kw.setdefault("halo_cell_cap", caps["cell_cap"])
            kw.setdefault("noise_cell_cap", caps["cell_cap"])
            kw.setdefault("dev_halo_cap", caps["dev_halo_cap"])
            kw.setdefault("noise_capacity_per_device",
                          caps["noise_capacity"])
            kw.setdefault("noise_skin_cap", caps["noise_skin_cap"])
            kw.setdefault("noise_root_cap", caps["noise_root_cap"])
        out = sharded_blocked_dbscan(
            mesh, shard_blocks(mesh, bc), shard_blocks(mesh, bv),
            eps=self.cfg.cluster.eps, min_pts=self.cfg.cluster.min_pts,
            metric=self.cfg.cluster.metric,
            min_cluster_size=self.cfg.cluster.min_cluster_size,
            halo_merge=True, halo_mode=halo_mode, backend=self.backend,
            **kw)
        out["point_index"] = shard_blocks(mesh, pidx)
        return out

    def reject_by_radius(self, batch: PointBatch, result: ClusterResult,
                         radius: Optional[float] = None,
                         aspect: Optional[float] = None):
        new_valid, rejected = reject_clusters(
            result, batch.valid,
            self.cfg.filters.radius_threshold if radius is None else radius,
            self.cfg.filters.aspect_threshold if aspect is None else aspect,
        )
        return batch.with_valid(new_valid), rejected

    # ---- registration (C18-C22) ----

    def coarse_align(self, result: ClusterResult, truth_xyz,
                     region_mask=None):
        """Extent auto-rescale of the centroids onto the truth, optionally
        with a region-subset truth rescale. Returns (centers_tmp [K, 3],
        truth_tmp [M, 3]), z = 0."""
        cvalid = _live_clusters(result)
        truth_xyz = self._tensor(truth_xyz)
        tvalid = torch.ones(truth_xyz.shape[0], dtype=torch.bool,
                            device=self.device)
        tmp_xy, _, bounds = auto_rescale_centers(
            result.center3d[:, :2], cvalid, truth_xyz[:, :2], tvalid)
        centers_tmp = torch.cat([tmp_xy, torch.zeros_like(tmp_xy[:, :1])],
                                dim=-1)
        if region_mask is not None:
            t_xy = rescale_region_truth(
                truth_xyz[:, :2], self._tensor(region_mask, torch.bool),
                bounds)
        else:
            t_xy = truth_xyz[:, :2]
        truth_tmp = torch.cat([t_xy, torch.zeros_like(t_xy[:, :1])], dim=-1)
        return centers_tmp, truth_tmp

    def register_to_truth(self, result: ClusterResult, truth_xyz,
                          coarse: bool = True, region_mask=None,
                          generator: Optional[torch.Generator] = None
                          ) -> ICPResult:
        """ICP of the live centroids onto the truth; RANSAC init when
        cfg.icp.ransac_iters > 0, multi-start when cfg.icp.num_starts > 1,
        both drawing from ``generator`` (seeded 0 when None)."""
        cvalid = _live_clusters(result)
        truth_xyz = self._tensor(truth_xyz)
        ones = torch.ones(truth_xyz.shape[0], dtype=torch.bool,
                          device=self.device)
        if coarse:
            src, tgt = self.coarse_align(result, truth_xyz, region_mask)
            tvalid = (ones if region_mask is None
                      else self._tensor(region_mask, torch.bool))
        else:
            src, tgt, tvalid = result.center3d, truth_xyz, ones
        icfg = self.cfg.icp
        if icfg.ransac_iters > 0:
            return icp_ransac(src, cvalid, tgt, tvalid, icfg, generator,
                              backend=self.backend)
        if icfg.num_starts > 1:
            return icp_multistart(src, cvalid, tgt, tvalid, icfg, generator,
                                  backend=self.backend)
        return icp(src, cvalid, tgt, tvalid, icfg, backend=self.backend)

    def match(self, result: ClusterResult, truth_xyz, reg: ICPResult,
              coarse: bool = True, match_distance: Optional[float] = None):
        truth_xyz = self._tensor(truth_xyz)
        cvalid = _live_clusters(result)
        if coarse:
            src, tgt = self.coarse_align(result, truth_xyz)
        else:
            src, tgt = result.center3d, truth_xyz
        out = assign_matches(
            src, cvalid, tgt,
            torch.ones(truth_xyz.shape[0], dtype=torch.bool,
                       device=self.device),
            reg.r, reg.t,
            self.cfg.icp.match_distance if match_distance is None
            else match_distance, backend=self.backend)
        out["rmse"] = registration_rmse(out, tgt)
        return out

    # ---- export / viz (C25, Tools export) ----

    def export_scene(self, prefix: str, batch: PointBatch,
                     result: ClusterResult, matches=None, truth_tmp=None):
        data = batch.to_numpy()
        lab = _host(result.label)[_host(batch.valid)]
        vtkio.write_points_vtk(prefix + "_points.vtk", data["xyz"], lab)
        vtkio.write_circles_vtk(prefix + "_circles.vtk",
                                _host(result.center3d)[:, :2],
                                _host(result.radius3d))
        if matches is not None and truth_tmp is not None:
            m = _host(matches["is_matched"])
            starts = _host(matches["matched_xyz"])[m]
            ends = _host(truth_tmp)[_host(matches["match_idx"])[m]]
            vtkio.write_lines_vtk(prefix + "_matches.vtk", starts, ends)

    def screenshot(self, path: str, batch: PointBatch,
                   result: Optional[ClusterResult] = None,
                   view: str = "xy", width: int = 800, height: int = 600,
                   point_size: int = 1):
        """Headless scene snapshot to PNG + legend sidecar (Tools.Screen,
        Show2DPoints, legend panel). view: "xy" or "motor"."""
        from .viz.snapshot import snapshot_clusters

        labels = (_host(result.label) if result is not None
                  else np.zeros(batch.capacity, np.int32))
        counts = _host(result.count) if result is not None else None
        return snapshot_clusters(
            path, xyz=_host(batch.xyz), motor=_host(batch.motor),
            labels=labels, valid=_host(batch.valid), view=view,
            width=width, height=height, point_size=point_size,
            counts=counts)

    def export_centroids(self, path: str, result: ClusterResult,
                         bit: Optional[int] = None):
        live = _host(_live_clusters(result))
        loaders.export_centroids(path, _host(result.center3d)[live],
                                 bit if bit is not None else self.export_bit)

    def export_cluster_points(self, path: str, batch: PointBatch,
                              result: ClusterResult,
                              bit: Optional[int] = None,
                              path_id: Optional[int] = None):
        """Cluster-point export; path_id restricts it to one source file."""
        v = _host(batch.valid)
        if path_id is not None:
            v = v & (_host(batch.path_id) == path_id)
        loaders.export_cluster_points(
            path, _host(result.label)[v], _host(batch.motor)[v],
            _host(batch.rng)[v],
            bit if bit is not None else self.export_bit)
