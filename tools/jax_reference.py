"""Reference constants for chip_smoke.py from the JAX package on the CPU.

Runs the 500k-point tier-2 job of bench.py through
vtkcloudpoint_tpu.cluster.pipeline.cluster_scan with the plain jnp backend in
float32 (x64 off), then ICP of the cluster centres onto the truth points, and
prints one JSON line: n_clusters, the SHA-256 of the int32 label array, the
overflow counters and the ICP result. chip_smoke.py stores n_clusters and the
label digest as constants and holds the PyTorch port to them.

    JAX_PLATFORMS=cpu python3 tools/jax_reference.py
"""
import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import jax.numpy as jnp

    import bench
    from vtkcloudpoint_tpu.cluster.pipeline import cluster_scan
    from vtkcloudpoint_tpu.config import ClusterConfig, EngineConfig, ICPConfig
    from vtkcloudpoint_tpu.register.icp import icp

    n = bench.N_POINTS
    motor, xyz, truth = bench.synthetic_cloud(n)
    cfg = EngineConfig(cluster=ClusterConfig(eps=bench.EPS,
                                             min_pts=bench.MIN_PTS,
                                             block_capacity=1024))
    res = cluster_scan(jnp.asarray(xyz), jnp.asarray(motor),
                       jnp.ones(n, bool), cfg, mode="balanced",
                       max_blocks=489, quirks=False, noise_capacity=4096,
                       max_clusters=1024, cluster_capacity=1024,
                       max_hull=32, backend="jnp")
    label = np.asarray(res.label, np.int32)
    reg = icp(res.center3d, res.count > 0, jnp.asarray(truth),
              jnp.ones(len(truth), bool), ICPConfig(max_iterations=50),
              chunk=1024, backend="jnp")
    print(json.dumps({
        "n_clusters": int(res.n_clusters),
        "label_sha256": hashlib.sha256(label.tobytes()).hexdigest(),
        "label_sum": int(label.astype(np.int64).sum()),
        "block_overflow": int(res.block_overflow),
        "noise_overflow": int(res.noise_overflow),
        "icp_error": float(reg.error),
        "icp_iterations": int(reg.iterations),
        "icp_r": np.asarray(reg.r).tolist(),
        "icp_t": np.asarray(reg.t).tolist(),
        "jax": jax.__version__,
    }))


if __name__ == "__main__":
    main()
