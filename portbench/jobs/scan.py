"""The scan job: ``cluster_scan(..., mode="balanced")`` of one 500k-point
scan and, where the traffic asks for it, ``icp`` of its cluster centres
onto the truth points, as the repository's tier-2 benchmark chains them.

The traffic's pool of ``distinct`` clouds (gen/seeds.py: pool) is staged on
the device at set-up; job i takes them in the order the seed sets. A cloud
drawn from the run's seed follows the pool: the set-up's last warm job runs
it, and the comparison reads that output too.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..gen.cloud import synthetic_cloud
from ..gen.seeds import pool
from ..lib import check
from ..lib.roofline import k1_work, k2_work, k3_work


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from vtkcloudpoint_tpu_torch.config import (ClusterConfig,
                                                    EngineConfig, ICPConfig)

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.with_icp = bool(traffic["icp"])
        self.ecfg = EngineConfig(cluster=ClusterConfig(
            eps=cfg["eps"], min_pts=cfg["min_pts"],
            block_capacity=cfg["block_capacity"], metric=cfg["metric"]))
        self.icfg = ICPConfig(max_iterations=cfg["icp_max_iterations"])
        self.scans = []
        rngs, self.order, own = pool(traffic, seed)
        # the pool, then the run's own scan (index ``distinct``)
        for rng in rngs + [own]:
            motor, xyz, truth, _ = synthetic_cloud(
                rng, cfg["n_points"], cfg["blobs"], cfg["blob_sigma"],
                cfg["noise_frac"], cfg["n_truth"])
            self.scans.append(SimpleNamespace(
                motor=torch.from_numpy(motor).to(device),
                xyz=torch.from_numpy(xyz).to(device),
                valid=torch.ones(len(motor), dtype=torch.bool,
                                 device=device),
                truth=torch.from_numpy(truth).to(device),
                truth_valid=torch.ones(len(truth), dtype=torch.bool,
                                       device=device)))

    # ---- the timed path ------------------------------------------------

    def __call__(self, i: int, mark=None):
        """Job i: the program's result, synchronised (its counters read).
        ``mark(name)``, where given, is a context for each top-level call
        (the traced pass names the device's idle gaps by them)."""
        return self.run(self.order[i % len(self.order)], mark)

    def run(self, k: int, mark=None):
        """The timed path on scan k."""
        import contextlib

        from vtkcloudpoint_tpu_torch.cluster import pipeline
        from vtkcloudpoint_tpu_torch.register import icp as icp_mod

        mark = mark or (lambda name: contextlib.nullcontext())
        s, c = self.scans[k], self.cfg
        with mark("cluster_scan"):
            res = pipeline.cluster_scan(
                s.xyz, s.motor, s.valid, self.ecfg, mode=c["mode"],
                max_blocks=c["max_blocks"], quirks=c["quirks"],
                noise_capacity=c["noise_capacity"],
                max_clusters=c["max_clusters"],
                cluster_capacity=c["cluster_capacity"],
                max_hull=c["max_hull"])
        reg = None
        if self.with_icp:
            with mark("icp"):
                reg = icp_mod.icp(res.center3d, res.count > 0, s.truth,
                                  s.truth_valid, self.icfg,
                                  chunk=c["icp_chunk"])
        counters = torch.stack([res.block_overflow.int(),
                                res.noise_overflow.int(),
                                res.n_clusters.int()]).tolist()
        return SimpleNamespace(scan=k, res=res, reg=reg, overflow=counters)

    def traced(self, i: int, mark):
        return self(i, mark)

    def warm(self):
        """One job on every scan of the pool (the window's shapes), then on
        the run's own scan: its output, which the comparison reads."""
        for k in range(len(self.order)):
            self.run(k)
        return self.run(len(self.order))

    def failed(self, out):
        """Why job's output does not count, or None: a capacity overflow
        (points dropped by a block or by the noise re-cluster, or more
        clusters than the tables hold)."""
        block, noise, n = out.overflow
        if block or noise or n > self.cfg["max_clusters"] - 1:
            return f"overflow: block {block}, noise {noise}, clusters {n}"
        return None

    def units(self, out):
        return {"points": self.cfg["n_points"], "scans": 1}

    # ---- the staged pass (spans) -------------------------------------------

    def staged(self, timer):
        """Every scan of the pool once through the stages of cluster_scan
        (and the ICP), each stage under ``timer``. Returns the last scan's
        label (the test compares it with cluster_scan's)."""
        from vtkcloudpoint_tpu_torch.cluster.blocks import \
            partition_gather_sorted
        from vtkcloudpoint_tpu_torch.cluster.dbscan import \
            dbscan_blocks_dispatch
        from vtkcloudpoint_tpu_torch.cluster.fusion import merge_blocks
        from vtkcloudpoint_tpu_torch.ops.geometry import cluster_shapes
        from vtkcloudpoint_tpu_torch.ops.metrics import coords_for_metric
        from vtkcloudpoint_tpu_torch.ops.segment import (
            bucket_payload_by_cluster, cluster_stats)
        from vtkcloudpoint_tpu_torch.register.icp import icp

        c, cc = self.cfg, self.ecfg.cluster
        label = None
        for s in self.scans[:len(self.order)]:
            n = s.xyz.shape[0]
            with timer("partition"):
                coords = coords_for_metric(s.xyz, s.motor, cc.metric)
                bc, bv, pidx, _ = partition_gather_sorted(
                    s.motor, s.valid, cc.block_capacity, c["max_blocks"],
                    coords=coords)
            with timer("dbscan"):
                db = dbscan_blocks_dispatch(
                    bc.contiguous(), bv, cc.eps, cc.min_pts, cc.metric,
                    max_iters=cc.propagate_max_iters)
            with timer("fusion"):
                fused = merge_blocks(
                    db["label"], bv, bc, pidx, n, cc.eps, cc.min_pts,
                    cc.metric, min_cluster_size=cc.min_cluster_size,
                    quirks=c["quirks"],
                    noise_capacity=min(c["noise_capacity"],
                                       c["max_blocks"] * cc.block_capacity))
                label = fused["label"]
            with timer("stats"):
                stats = cluster_stats(s.xyz, s.motor, label, s.valid,
                                      c["max_clusters"])
            with timer("bucket"):
                pay = (s.xyz[:, 0], s.xyz[:, 1], s.motor[:, 0],
                       s.motor[:, 1])
                tabs, tval, runs, _ = bucket_payload_by_cluster(
                    label, s.valid, pay, c["max_clusters"],
                    c["cluster_capacity"])
                both = torch.cat([tabs[..., 0:2], tabs[..., 2:4]],
                                 dim=0).contiguous()
                bval, bcnt = torch.cat([tval, tval]), torch.cat([runs, runs])
            with timer("shapes"):
                cluster_shapes(both, bval, bcnt, max_hull=c["max_hull"],
                               min_points=self.ecfg.filters.circle_min_points)
            if self.with_icp:
                with timer("icp"):
                    icp(stats["center3d"], stats["count"] > 0, s.truth,
                        s.truth_valid, self.icfg, chunk=c["icp_chunk"])
        return label

    # ---- the reference -------------------------------------------------

    def reference(self, k: int):
        from ..plainref import chains

        s = self.scans[k]
        return chains.scan(s.xyz, s.motor, s.valid, s.truth, self.cfg,
                           self.with_icp)

    def lowered(self, k: int, ref):
        from ..plainref import chains

        s = self.scans[k]
        return chains.scan_lowered(ref, s.xyz, s.motor, s.valid, s.truth,
                                   self.cfg, self.with_icp)

    def witness(self, k: int, ref):
        from ..plainref import chains

        s = self.scans[k]
        return chains.scan_witness(ref, s.xyz, s.motor, s.valid, s.truth,
                                   self.cfg, self.with_icp)

    def as_compared(self, out):
        """The program's output in the reference's terms."""
        r = out.res
        got = SimpleNamespace(label=r.label, n_clusters=int(r.n_clusters),
                              count=r.count, center3d=r.center3d,
                              center2d=r.center2d, radius3d=r.radius3d,
                              radius2d=r.radius2d, aspect=r.aspect)
        if out.reg is not None:
            got.r, got.t = out.reg.r, out.reg.t
            got.iterations = int(out.reg.iterations)
        return got

    def readings(self, got, ref):
        """The numbers compared, by name."""
        live = ref.count > 0
        out = {
            # points labelled otherwise, and the gap in the cluster count
            "label_mismatch": (check.mismatches(got.label, ref.label)
                               + abs(got.n_clusters - ref.n_clusters)),
            "center_gap": max(check.gap(got.center3d, ref.center3d, live),
                              check.gap(got.center2d, ref.center2d, live)),
            "radius_gap": max(check.gap(got.radius3d, ref.radius3d, live),
                              check.gap(got.radius2d, ref.radius2d, live)),
            # the min-area rectangle of a round blob is ill-conditioned:
            # near-equal areas at other angles give other aspects
            "aspect_gap": check.gap(got.aspect, ref.aspect, live),
        }
        if self.with_icp:
            out["icp_r_gap"] = check.gap(got.r, ref.r)
            out["icp_t_gap"] = check.abs_gap(got.t, ref.t)
        return out

    # ---- roofline counts ---------------------------------------------------

    def work(self, k: int, ref):
        """{kernel: (operations, bytes)} of one job on scan k, from the
        reference's partition, tables and hulls."""
        from ..plainref import chains

        c = self.cfg
        nv = ref.block_valid.sum(dim=1).tolist()
        both, bval, bcnt = ref.tables
        h = chains.hull_sizes(both, bval, c["max_hull"]).tolist()
        out = {"K1": k1_work(nv, 2, c["block_capacity"]),
               "K2": k2_work(bval.sum(dim=1).tolist(), h,
                             c["cluster_capacity"])}
        if self.with_icp:
            n_valid = int((ref.count > 0).sum())
            m = self.scans[k].truth.shape[0]
            ops, nbytes = k3_work(n_valid, m, ref.count.shape[0], m)
            out["K3"] = (ops * ref.iterations, nbytes * ref.iterations)
        return out
