"""Reference answers of the tier-4 SLAM phase of chip_smoke.py, from the JAX
package on the CPU, in float32 (x64 off, as benchmarks/tier4_slam.py runs)
and in float64 (x64 on, the same float32 scans widened).

For each precision it runs, on the scans of tools/tier4_inputs.py:
  slam  slam_pipeline_ba at TIER4's settings: the ATE of odometry, pose
        graph and BA against the truth, the loop-closure pairs (count and
        SHA-256 of the int32 (i, j) list), n_landmarks, graph_cost, ba_cost,
        and every pose of the three stages;
  s2m   scan_to_map at SCAN2MAP's settings: the ATE against the truth, the
        map size (valid map slots) and every pose.

Prints one JSON line per precision and phase without the poses, then the
float32-vs-float64 gap of each ATE. With ``--out PATH`` it also writes all
of it, poses included, as one JSON file (chip_smoke.py reads
tools/tier4_reference.json).

    JAX_PLATFORMS=cpu python3 tools/jax_reference_tier4.py \
        [--out tools/tier4_reference.json] [f32] [f64]
"""
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def pair_digest(li, lj) -> str:
    """SHA-256 of the closure pairs as int32 (i0, j0, i1, j1, ...)."""
    pairs = np.stack([np.asarray(li), np.asarray(lj)], 1).astype(np.int32)
    return hashlib.sha256(pairs.tobytes()).hexdigest()


def run(precision: str):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", precision == "f64")
    from tools.tier4_inputs import SCAN2MAP, TIER4 as T, tier4_scans
    from vtkcloudpoint_tpu.config import ICPConfig
    from vtkcloudpoint_tpu.slam.posegraph import absolute_trajectory_error
    from vtkcloudpoint_tpu.slam.scan2map import scan_to_map
    from vtkcloudpoint_tpu.slam.trajectory import (detect_loop_closures,
                                                   slam_pipeline_ba)

    dt = np.float32 if precision == "f32" else np.float64
    scans, valid, r_true, t_true = tier4_scans()
    scans_j = jnp.asarray(scans.astype(dt))
    valid_j = jnp.asarray(valid)
    rt, tt = jnp.asarray(r_true.astype(dt)), jnp.asarray(t_true.astype(dt))
    cfg = ICPConfig(max_iterations=T["icp_max_iterations"], tol=T["icp_tol"])

    def ate(tr):
        return float(absolute_trajectory_error(tr.r, tr.t, rt, tt))

    def poses(tr):
        return {"r": np.asarray(tr.r, np.float64).tolist(),
                "t": np.asarray(tr.t, np.float64).tolist()}

    t0 = time.perf_counter()
    ba, pg, odo, stats = slam_pipeline_ba(
        scans_j, valid_j, cfg, loop_radius=T["loop_radius"],
        gn_iterations=T["gn_iterations"], landmark_eps=T["landmark_eps"],
        landmark_min_pts=T["landmark_min_pts"],
        max_clusters_per_scan=T["max_clusters_per_scan"],
        ba_iterations=T["ba_iterations"])
    jax.block_until_ready(ba)
    slam_s = time.perf_counter() - t0
    li, lj = detect_loop_closures(odo, T["loop_radius"])
    slam = {"ate_odometry": ate(odo), "ate_posegraph": ate(pg),
            "ate_ba": ate(ba), "n_pairs": int(len(li)),
            "pairs_sha256": pair_digest(li, lj),
            "n_landmarks": int(stats["n_landmarks"]),
            "graph_cost": float(stats["graph_cost"]),
            "ba_cost": float(stats["ba_cost"]), "seconds": slam_s}
    slam_poses = {"odometry": poses(odo), "posegraph": poses(pg),
                  "ba": poses(ba), "pairs": [np.asarray(li).tolist(),
                                             np.asarray(lj).tolist()]}

    t0 = time.perf_counter()
    traj, mp, _ = scan_to_map(scans_j, valid_j, cfg, **SCAN2MAP)
    jax.block_until_ready(traj)
    s2m = {"ate": ate(traj), "map_size": int(np.asarray(mp.mask).sum()),
           "seconds": time.perf_counter() - t0}
    return {"slam": slam, "s2m": s2m,
            "poses": {**slam_poses, "s2m": poses(traj)}}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    args = sys.argv[1:]
    out_path = None
    if "--out" in args:
        k = args.index("--out")
        out_path = args[k + 1]
        del args[k:k + 2]
    out = {"jax": jax.__version__}
    for precision in args or ["f32", "f64"]:
        res = run(precision)
        out[precision] = res
        for phase in ("slam", "s2m"):
            print(json.dumps({"precision": precision, "phase": phase,
                              **res[phase]}), flush=True)
    if "f32" in out and "f64" in out:
        gap = {key: abs(out["f32"]["slam"][key] - out["f64"]["slam"][key])
               for key in ("ate_odometry", "ate_posegraph", "ate_ba")}
        gap["s2m_ate"] = abs(out["f32"]["s2m"]["ate"]
                             - out["f64"]["s2m"]["ate"])
        out["f32_f64_ate_gap"] = gap
        print(json.dumps({"f32_f64_ate_gap": gap}), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
