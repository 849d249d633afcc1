"""The Engine session: the desktop workflow from an imported scan to the
exported target coordinates, through ``vtkcloudpoint_tpu_torch.engine.
Engine`` as the repository's chip smoke script drives it.

Steps: ``import_arrays``, ``filter_by_distance``, ``cluster`` (balanced
blocks), ``reject_by_radius``, ``register_to_truth`` three times (coarse;
multi-start; RANSAC, the last two drawing from CPU generators seeded with
the scan), ``match`` and ``export_centroids`` into the run's TMPDIR. The
cluster-point export is left out (about 17 MB of text a session). The
traffic's pool of ``distinct`` scans (gen/seeds.py: pool) is made at
set-up; session i takes them in the order the seed sets. A scan drawn from
the run's seed follows the pool: the set-up's last warm session runs it,
and the comparison reads that output too.
"""
from __future__ import annotations

import os
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from ..gen.seeds import pool, streams
from ..gen.session import session_scan
from ..lib import check


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.scans = []
        rngs, self.order, own = pool(traffic, seed)
        # the pool, then the run's own scan (index ``distinct``)
        for rng in rngs + [own]:
            rc, rr, rg = streams(int(rng.integers(0, 2**62)), 3)
            motor, dist, truth = session_scan(rc, rr, cfg, traffic)
            # the seed of the multi-start and RANSAC generators
            self.scans.append(SimpleNamespace(
                motor=motor, dist=dist, truth=truth,
                gen_seed=int(rg.integers(0, 2**62))))
        self.outdir = os.path.join(tempfile.gettempdir(), "portbench")
        os.makedirs(self.outdir, exist_ok=True)
        self.centroid_path = os.path.join(self.outdir, "centroids.txt")

    def _engine(self, **icp):
        from vtkcloudpoint_tpu_torch.config import (ClusterConfig,
                                                    EngineConfig, ICPConfig)
        from vtkcloudpoint_tpu_torch.engine import Engine

        c = self.cfg
        return Engine(EngineConfig(
            cluster=ClusterConfig(eps=c["eps"], min_pts=c["min_pts"],
                                  block_capacity=c["block_capacity"],
                                  metric=c["metric"]),
            icp=ICPConfig(**icp)), device=self.device)

    def run(self, k: int, timer=None):
        """One session on scan k of the pool, each step under ``timer`` if
        given."""
        import contextlib

        t, c, sc = self.traffic, self.cfg, self.scans[k]
        step = timer or (lambda name: contextlib.nullcontext())
        eng = self._engine()
        with step("import"):
            batch = eng.import_arrays(sc.motor, sc.dist,
                                      capacity=t["capacity"])
        with step("filter"):
            batch = eng.filter_by_distance(batch, t["dis_min"],
                                           t["dis_max"])
        with step("cluster"):
            res = eng.cluster(batch, mode=c["mode"],
                              max_blocks=c["max_blocks"],
                              max_clusters=c["max_clusters"],
                              cluster_capacity=c["cluster_capacity"],
                              noise_capacity=c["noise_capacity"],
                              max_hull=t["max_hull"], quirks=c["quirks"])
        with step("reject"):
            kept, rejected = eng.reject_by_radius(
                batch, res, radius=t["reject_radius"])
        with step("register"):
            reg = eng.register_to_truth(res, sc.truth, coarse=True)
        with step("register_multistart"):
            reg_ms = self._engine(num_starts=t["num_starts"]) \
                .register_to_truth(res, sc.truth, generator=torch.Generator()
                                   .manual_seed(sc.gen_seed))
        with step("register_ransac"):
            reg_rs = self._engine(ransac_iters=t["ransac_iters"]) \
                .register_to_truth(res, sc.truth, generator=torch.Generator()
                                   .manual_seed(sc.gen_seed))
        with step("match"):
            m = eng.match(res, sc.truth, reg)
        with step("export"):
            eng.export_centroids(self.centroid_path, res)
        counters = torch.stack([res.block_overflow.int(),
                                res.noise_overflow.int(),
                                res.n_clusters.int()]).tolist()
        return SimpleNamespace(scan=k, res=res, rejected=rejected,
                               regs={"coarse": reg, "multistart": reg_ms,
                                     "ransac": reg_rs},
                               match=m, overflow=counters)

    # ---- the timed path ------------------------------------------------

    def __call__(self, i: int):
        return self.run(self.order[i % len(self.order)])

    def traced(self, i: int, mark):
        return self.run(self.order[i % len(self.order)], mark)

    def warm(self):
        """A session on every scan of the pool, then on the run's own scan:
        its output, which the comparison reads."""
        for k in range(len(self.order)):
            self.run(k)
        return self.keep(self.run(len(self.order)))

    def keep(self, out):
        """Called, right after its session, for an output the comparison
        will read: the exported file as this session left it."""
        with open(self.centroid_path) as f:
            out.centroid_text = f.read()
        return out

    def failed(self, out):
        block, noise, n = out.overflow
        if block or noise or n > self.cfg["max_clusters"] - 1:
            return f"overflow: block {block}, noise {noise}, clusters {n}"
        return None

    def units(self, out):
        return {"sessions": 1}

    # ---- the staged pass -------------------------------------------------

    def staged(self, timer):
        for k in range(len(self.order)):
            self.run(k, timer)

    # ---- the reference ---------------------------------------------------

    def reference(self, k: int):
        from ..plainref import chains

        sc = self.scans[k]
        return chains.session(sc.motor, sc.dist, sc.truth, self.cfg,
                              self.traffic, sc.gen_seed, self.device)

    def lowered(self, k: int, ref):
        from ..plainref import chains

        sc = self.scans[k]
        return chains.session_lowered(ref, sc.motor, sc.dist, sc.truth,
                                      self.cfg, self.traffic, sc.gen_seed,
                                      self.device)

    def witness(self, k: int, ref):
        from ..plainref import chains

        sc = self.scans[k]
        return chains.session_witness(ref, sc.truth, self.cfg, self.traffic,
                                      sc.gen_seed)

    def as_compared(self, out):
        rows = [line.split("\t") for line in
                out.centroid_text.splitlines() if line.strip()]
        cents = torch.tensor(np.array(rows, dtype=np.float64).reshape(-1, 3))
        m = out.match
        return SimpleNamespace(label=out.res.label, rejected=out.rejected,
                               regs=out.regs, match=m, centroids=cents)

    def readings(self, got, ref):
        out = {
            "label_mismatch": check.mismatches(got.label, ref.label),
            "rejected_mismatch": check.mismatches(got.rejected,
                                                  ref.rejected),
            "match_mismatch": (
                check.mismatches(got.match["is_matched"],
                                 ref.match["is_matched"])
                + check.mismatches(
                    torch.where(ref.match["is_matched"].cpu(),
                                got.match["match_idx"].cpu(), 0),
                    torch.where(ref.match["is_matched"].cpu(),
                                ref.match["match_idx"].cpu(), 0))),
        }
        # each registration by its worse part: the largest gap of R's
        # entries, or of t in metres (the loose ICP stop makes either swing
        # alone in sound runs)
        for name in ("coarse", "multistart", "ransac"):
            out[f"{name}_gap"] = max(
                check.gap(got.regs[name].r, ref.regs[name].r),
                check.abs_gap(got.regs[name].t, ref.regs[name].t))
        # the file should hold the centroids at the traffic's
        # ``export_decimals`` places: what is read is the gap beyond that
        # rounding, in metres
        want = ref.centroids.detach().double().cpu()
        have = got.centroids.detach().double().cpu()
        decimals = self.traffic["export_decimals"]
        if tuple(have.shape) != tuple(want.shape):
            out["centroid_file_gap"] = float("inf")
        else:
            g = (have - want).abs().max() if want.numel() else 0.0
            out["centroid_file_gap"] = max(
                0.0, float(g) - 0.5 * 10.0 ** -decimals)
        return out

    def work(self, k: int, ref):
        return {}
