"""Reference constants of the tier-3 phases of chip_smoke.py, from the JAX
package on the CPU in float32 (x64 off, jnp backend).

Prints one JSON line per phase:
  a  the 5M-point tier-3 job of benchmarks/tier3_scale.py (parity mode, full
     stage): n_clusters, label SHA-256, overflow counters (bucket without
     row 0, as tier3_scale.py does), ICP R, t, error and iterations on the
     jnp path, and the iterations of the same ICP on the Pallas NN
     (interpret mode here: direct differences, the port's semantics);
  b  Engine.cluster_grid on the session of tools/engine_session.py at
     cell_cap 2048: n_clusters, label SHA-256, overflow, the SHA-256 of the
     per-cluster counts;
  c  icp_grid on the crossover case of tools/tier3_inputs.py: R, t, error,
     iterations, unresolved overflow;
  d  cluster_scan(halo_merge=True, halo_cap=64) on the tier-2 cloud with the
     settings of tools/jax_reference.py: n_clusters, label SHA-256.

    JAX_PLATFORMS=cpu python3 tools/jax_reference_tier3.py [a b c d]
"""
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def sha(a, dtype=np.int32) -> str:
    return hashlib.sha256(np.asarray(a).astype(dtype).tobytes()).hexdigest()


def phase_a():
    import jax.numpy as jnp

    from tools.tier3_inputs import TIER3 as T, tier3_cloud
    from vtkcloudpoint_tpu.cluster.blocks import partition_gather_sorted
    from vtkcloudpoint_tpu.cluster.dbscan import dbscan_blocks_dispatch
    from vtkcloudpoint_tpu.cluster.fusion import merge_blocks
    from vtkcloudpoint_tpu.config import ICPConfig
    from vtkcloudpoint_tpu.ops.geometry import cluster_shapes
    from vtkcloudpoint_tpu.ops.segment import (bucket_payload_by_cluster,
                                               cluster_stats)
    from vtkcloudpoint_tpu.register.icp import icp

    motor, xyz, truth, k_true = tier3_cloud()
    n = len(motor)
    motor, xyz, truth = map(jnp.asarray, (motor, xyz, truth))
    valid = jnp.ones(n, bool)
    tvalid = jnp.ones(truth.shape[0], bool)
    bc, bv, pidx, gath_ovf = partition_gather_sorted(
        motor, valid, T["block_cap"], T["max_blocks"])
    db = dbscan_blocks_dispatch(bc, bv, T["eps"], T["min_pts"], T["metric"],
                                chunk=16, backend="jnp")
    fused = merge_blocks(db["label"], bv, bc, pidx, n, T["eps"],
                         T["min_pts"], T["metric"], quirks=False,
                         noise_capacity=T["noise_cap"], noise_engine="auto",
                         noise_cell_cap=T["noise_cell_cap"])
    label = fused["label"]
    stats = cluster_stats(xyz, motor, label, valid, T["max_clusters"])
    pay = (xyz[:, 0], xyz[:, 1], motor[:, 0], motor[:, 1])
    tabs, tval, runs, bovf = bucket_payload_by_cluster(
        label, valid, pay, T["max_clusters"], T["cluster_cap"])
    both = jnp.concatenate([tabs[..., 0:2], tabs[..., 2:4]], axis=0)
    sh = cluster_shapes(both, jnp.concatenate([tval, tval]),
                        jnp.concatenate([runs, runs]),
                        max_hull=T["max_hull"], chunk_k=T["shape_chunk_k"],
                        backend="jnp")
    cvalid = stats["count"] > 0
    icfg = ICPConfig(max_iterations=T["icp_iterations"])
    reg = icp(stats["center3d"], cvalid, truth, tvalid, icfg,
              chunk=T["icp_chunk"], backend="jnp")
    reg_p = icp(stats["center3d"], cvalid, truth, tvalid, icfg,
                chunk=T["icp_chunk"], backend="pallas")
    radius = np.asarray(sh["radius"][:T["max_clusters"]])
    return {
        "n_clusters": int(fused["n_total"]), "k_true": int(k_true),
        "label_sha256": sha(label),
        "noise_overflow": int(fused["noise_overflow"]),
        "gather_overflow": int(np.asarray(gath_ovf).sum()),
        "bucket_overflow": int(np.asarray(bovf)[1:].sum()),
        "radius_sum": float(radius.astype(np.float64).sum()),
        "icp_r": np.asarray(reg.r).tolist(),
        "icp_t": np.asarray(reg.t).tolist(),
        "icp_error": float(reg.error),
        "icp_iterations": int(reg.iterations),
        "icp_pallas_iterations": int(reg_p.iterations),
        "icp_pallas_r": np.asarray(reg_p.r).tolist(),
        "icp_pallas_t": np.asarray(reg_p.t).tolist(),
    }


def phase_b():
    from tools.engine_session import SESSION, engine_config, engine_session
    from tools.tier3_inputs import GRID_ENGINE
    from vtkcloudpoint_tpu import config
    from vtkcloudpoint_tpu.engine import Engine

    motor, rng, _ = engine_session()
    eng = Engine(engine_config(config))
    batch = eng.import_arrays(motor, rng, capacity=SESSION["capacity"])
    batch = eng.filter_by_distance(batch, SESSION["dis_min"],
                                   SESSION["dis_max"])
    out, stats = eng.cluster_grid(batch, **GRID_ENGINE)
    count = np.asarray(stats["count"])
    return {"n_clusters": int(out["n_clusters"]),
            "label_sha256": sha(out["label"]),
            "overflow": int(out["overflow"]),
            "n_core": int(np.asarray(out["core"]).sum()),
            "count_sha256": sha(count),
            "n_nonempty": int((count[1:] > 0).sum()),
            "n_filtered": int(batch.count)}


def phase_c():
    import jax.numpy as jnp

    from tools.tier3_inputs import NN, nn_cell, nn_inputs
    from vtkcloudpoint_tpu.config import ICPConfig
    from vtkcloudpoint_tpu.register.nn_grid import icp_grid

    src, tgt = nn_inputs()
    cfg = ICPConfig(max_iterations=NN["max_iterations"], tol=NN["tol"])
    res, ovf = icp_grid(jnp.asarray(src), jnp.ones(len(src), bool),
                        jnp.asarray(tgt), jnp.ones(len(tgt), bool), cfg,
                        cell_size=nn_cell(NN["m"]), cell_cap=NN["cell_cap"],
                        fallback_cap=NN["fallback_cap"])
    return {"cell": nn_cell(NN["m"]), "icp_r": np.asarray(res.r).tolist(),
            "icp_t": np.asarray(res.t).tolist(),
            "icp_error": float(res.error),
            "icp_iterations": int(res.iterations), "overflow": int(ovf)}


def phase_d():
    import jax.numpy as jnp

    import bench
    from tools.tier3_inputs import HALO
    from vtkcloudpoint_tpu.cluster.pipeline import cluster_scan
    from vtkcloudpoint_tpu.config import ClusterConfig, EngineConfig

    n = bench.N_POINTS
    motor, xyz, _ = bench.synthetic_cloud(n)
    cfg = EngineConfig(cluster=ClusterConfig(eps=bench.EPS,
                                             min_pts=bench.MIN_PTS,
                                             block_capacity=1024))
    res = cluster_scan(jnp.asarray(xyz), jnp.asarray(motor),
                       jnp.ones(n, bool), cfg, mode="balanced",
                       max_blocks=489, quirks=False, noise_capacity=4096,
                       max_clusters=1024, cluster_capacity=1024,
                       max_hull=32, halo_merge=True,
                       halo_cap=HALO["halo_cap"], backend="jnp")
    return {"n_clusters": int(res.n_clusters),
            "label_sha256": sha(res.label),
            "block_overflow": int(res.block_overflow),
            "noise_overflow": int(res.noise_overflow)}


PHASES = {"a": phase_a, "b": phase_b, "c": phase_c, "d": phase_d}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    for name in sys.argv[1:] or sorted(PHASES):
        t0 = time.perf_counter()
        out = PHASES[name]()
        print(json.dumps({"phase": name, **out,
                          "seconds": time.perf_counter() - t0,
                          "jax": jax.__version__}), flush=True)


if __name__ == "__main__":
    main()
