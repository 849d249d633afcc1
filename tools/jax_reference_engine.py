"""Reference constants of the Engine session for chip_smoke.py, from the JAX
package on the CPU in float32 (x64 off, jnp backend).

Runs the session of tools/engine_session.py through vtkcloudpoint_tpu's
Engine -- import_arrays, filter_by_distance, cluster, reject_by_radius,
register_to_truth (single start, coarse), match -- and prints one JSON line:
n_clusters, the SHA-256 of the int32 label array, n_rejected, n_matched,
the ICP R and t, and, to choose the rejection threshold, the least relative
gap between a live cluster's radius and that threshold.

    JAX_PLATFORMS=cpu python3 tools/jax_reference_engine.py
"""
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    from tools.engine_session import SESSION, engine_config, engine_session
    from vtkcloudpoint_tpu import config
    from vtkcloudpoint_tpu.engine import Engine

    t0 = time.perf_counter()
    motor, rng, truth = engine_session()
    eng = Engine(engine_config(config))
    batch = eng.import_arrays(motor, rng, capacity=SESSION["capacity"])
    n_imported = int(batch.count)
    batch = eng.filter_by_distance(batch, SESSION["dis_min"],
                                   SESSION["dis_max"])
    res = eng.cluster(batch, **SESSION["cluster"])
    batch2, rejected = eng.reject_by_radius(batch, res,
                                            radius=SESSION["reject_radius"])
    reg = eng.register_to_truth(res, truth, coarse=True)
    m = eng.match(res, truth, reg)
    label = np.asarray(res.label, np.int32)
    live = (np.asarray(res.count) > 0) & (np.arange(len(res.count)) > 0)
    radii = np.asarray(res.radius3d)[live]
    print(json.dumps({
        "n_imported": n_imported,
        "n_filtered": int(batch.count),
        "n_clusters": int(res.n_clusters),
        "label_sha256": hashlib.sha256(label.tobytes()).hexdigest(),
        "block_overflow": int(res.block_overflow),
        "noise_overflow": int(res.noise_overflow),
        "n_rejected": int(np.asarray(rejected).sum()),
        "n_after_reject": int(batch2.count),
        "reject_radius_min_rel_gap": float(
            np.abs(radii / SESSION["reject_radius"] - 1.0).min()),
        "icp_r": np.asarray(reg.r).tolist(),
        "icp_t": np.asarray(reg.t).tolist(),
        "icp_iterations": int(reg.iterations),
        "n_matched": int(m["n_matched"]),
        "rmse": float(m["rmse"]),
        "seconds": time.perf_counter() - t0,
        "jax": jax.__version__,
    }))


if __name__ == "__main__":
    main()
