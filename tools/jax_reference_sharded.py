"""Reference constants of the sharded Engine run for chip_smoke.py, from the
JAX package on the CPU in float32 (x64 off, jnp backend).

Runs the Engine session of tools/engine_session.py (import, distance
filter) through vtkcloudpoint_tpu's Engine.cluster_sharded on a one-device
mesh with the settings of tools/sharded_session.py, once per mode of
sharded_session.MODES, and prints one JSON line per mode: n_total, the
overflow counters and the SHA-256 of the int32 label array in block layout
[B, cap], with the mode's wall time.

    JAX_PLATFORMS=cpu python3 tools/jax_reference_sharded.py [mode ...]
"""
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(modes):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    from tools.engine_session import SESSION, engine_config, engine_session
    from tools.sharded_session import MODES, SHARDED
    from vtkcloudpoint_tpu import config
    from vtkcloudpoint_tpu.engine import Engine
    from vtkcloudpoint_tpu.parallel.mesh import make_mesh

    motor, rng, truth = engine_session()
    eng = Engine(engine_config(config))
    batch = eng.import_arrays(motor, rng, capacity=SESSION["capacity"])
    batch = eng.filter_by_distance(batch, SESSION["dis_min"],
                                   SESSION["dis_max"])
    mesh = make_mesh(1)
    for mode in modes or list(MODES):
        t0 = time.perf_counter()
        out = eng.cluster_sharded(batch, mesh=mesh, **SHARDED, **MODES[mode])
        label = np.asarray(out["label"], np.int32)
        print(json.dumps({
            "mode": mode, "blocks": list(label.shape),
            "n_total": int(out["n_total"]),
            "label_sha256": hashlib.sha256(label.tobytes()).hexdigest(),
            "noise_overflow": int(out["noise_overflow"]),
            "halo_overflow": int(out["halo_overflow"]),
            "seconds": round(time.perf_counter() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
