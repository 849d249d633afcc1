"""The SLAM job: ``slam_pipeline_ba`` over the survey's scans, as the
repository's tier-4 benchmark runs it: ICP odometry, loop closures,
pose-graph Gauss-Newton, landmark observations and bundle adjustment.

The traffic's pool of ``distinct`` surveys (gen/seeds.py: pool) is staged
on the device at set-up; job i takes them in the order the seed sets.
Set-up runs one whole job, on a survey drawn from the run's seed outside
the pool: that pays the process's first ``torch.func`` call and the first
calls of the solvers at the job's own sizes (a warm job on a short prefix
of a survey left the window's first job 1-3 s slower than the rest), and
the comparison reads its output too.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch

from ..gen.seeds import pool
from ..gen.slam import survey
from ..lib import check
from ..lib.roofline import k3_work


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.surveys = []
        rngs, self.order, own = pool(traffic, seed)
        # the pool, then the run's own survey (index ``distinct``)
        for rng in rngs + [own]:
            scans, valid, _, _ = survey(
                rng, cfg["scans"], cfg["points_per_scan"], cfg["landmarks"],
                cfg["blob_sigma"], cfg["step_m"], cfg["scan_noise"])
            self.surveys.append((torch.from_numpy(scans).to(device),
                                 torch.from_numpy(valid).to(device)))

    def run(self, scans, valid, timer=None):
        from vtkcloudpoint_tpu_torch.config import ICPConfig
        from vtkcloudpoint_tpu_torch.slam import trajectory

        c = self.cfg
        icfg = ICPConfig(max_iterations=c["icp_max_iterations"],
                         tol=c["icp_tol"])
        ba, pg, odo, stats = trajectory.slam_pipeline_ba(
            scans, valid, icfg, loop_radius=c["loop_radius"],
            gn_iterations=c["gn_iterations"],
            landmark_eps=c["landmark_eps"],
            landmark_min_pts=c["landmark_min_pts"],
            max_clusters_per_scan=c["max_clusters_per_scan"],
            ba_iterations=c["ba_iterations"], timer=timer)
        finite = torch.stack([torch.isfinite(x).all() for x in
                              (ba.r, ba.t, pg.r, pg.t, odo.r, odo.t)])
        return SimpleNamespace(scan=None, ba=ba, posegraph=pg, odometry=odo,
                               finite=bool(finite.all()),
                               n_landmarks=int(stats["n_landmarks"]))

    # ---- the timed path ------------------------------------------------

    def job(self, i: int, timer=None):
        return self.survey(self.order[i % len(self.order)], timer)

    def survey(self, k: int, timer=None):
        out = self.run(*self.surveys[k], timer=timer)
        out.scan = k
        return out

    def __call__(self, i: int):
        return self.job(i)

    def traced(self, i: int, mark):
        return self.job(i, mark)

    def warm(self):
        """One whole job, on the run's own survey: its output, which the
        comparison reads."""
        return self.survey(len(self.order))

    def keep(self, out):
        return out

    def failed(self, out):
        return None if out.finite else "a pose is not finite"

    def units(self, out):
        return {"scans": self.cfg["scans"]}

    # ---- the staged pass -------------------------------------------------

    def staged(self, timer):
        return self.job(0, timer)

    # ---- the reference ---------------------------------------------------

    def reference(self, k: int):
        from ..plainref import chains

        return chains.slam(*self.surveys[k], self.cfg)

    def lowered(self, k: int, ref):
        from ..plainref import chains

        return chains.slam_lowered(ref, *self.surveys[k], self.cfg)

    def witness(self, k: int, ref):
        from ..plainref import chains

        return chains.slam_witness(ref, *self.surveys[k], self.cfg)

    def as_compared(self, out):
        from vtkcloudpoint_tpu_torch.slam.trajectory import \
            detect_loop_closures

        li, lj = detect_loop_closures(out.odometry, self.cfg["loop_radius"])
        return SimpleNamespace(odometry=out.odometry,
                               posegraph=out.posegraph, ba=out.ba,
                               pairs=(li.tolist(), lj.tolist()))

    def readings(self, got, ref):
        gp = set(zip(*got.pairs))
        rp = set(zip(*ref.pairs))
        out = {"pairs_mismatch": len(gp ^ rp)}
        for name in ("odometry", "posegraph", "ba"):
            g, r = getattr(got, name), getattr(ref, name)
            out[f"{name}_r_gap"] = check.gap(g.r, r.r)
            out[f"{name}_t_gap"] = check.abs_gap(g.t, r.t)
        return out

    def work(self, k: int, ref):
        """K3 per launch at this survey's sizes (every point valid)."""
        n = self.cfg["points_per_scan"]
        return {"K3_call": k3_work(n, n, n, n)}
