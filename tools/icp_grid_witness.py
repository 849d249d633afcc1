"""Where grid ICP's float32 gap between the JAX package and the port comes
from: both packages on the CPU, in float32 and in float64, on the grid-ICP
case of tools/tier3_inputs.py (m = 100,000), cut after k iterations.

In float64 both compute the same transform to ~1e-12 if the port's loop,
weights and composition are JAX's; their float32 results then differ only by
rounding (summation order of the 100,000-term centroid and covariance sums).
Prints one JSON line per dtype and k with R, t and the iterations of each
package, then one line of the gaps: port32 - jax32, port64 - jax64, and
each package's float32 result against its float64 one.

    JAX_PLATFORMS=cpu python3 tools/icp_grid_witness.py [--ks 1,2,3,5,10,20]

Each dtype runs in a child process of its own (JAX's x64 switch is set
before the first array); the float32 child runs with x64 off, as
tools/jax_reference_tier3.py does.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_child(dtype: str, ks):
    """Both packages at ``dtype`` for each k: JSON lines on stdout."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    import jax.numpy as jnp
    import torch

    from tools.tier3_inputs import NN, nn_cell, nn_inputs
    from vtkcloudpoint_tpu.config import ICPConfig
    from vtkcloudpoint_tpu.register.nn_grid import icp_grid as icp_grid_jax
    from vtkcloudpoint_tpu_torch.register.nn_grid import icp_grid

    src, tgt = (a.astype(dtype) for a in nn_inputs())
    kw = dict(cell_size=nn_cell(NN["m"]), cell_cap=NN["cell_cap"],
              fallback_cap=NN["fallback_cap"])
    for k in ks:
        cfg = ICPConfig(max_iterations=k, tol=NN["tol"])
        t0 = time.perf_counter()
        jres, jovf = icp_grid_jax(jnp.asarray(src), jnp.ones(len(src), bool),
                                  jnp.asarray(tgt), jnp.ones(len(tgt), bool),
                                  cfg, **kw)
        jr, jt = np.asarray(jres.r), np.asarray(jres.t)
        t1 = time.perf_counter()
        pres, povf = icp_grid(torch.from_numpy(src),
                              torch.ones(len(src), dtype=torch.bool),
                              torch.from_numpy(tgt),
                              torch.ones(len(tgt), dtype=torch.bool), cfg,
                              **kw)
        print(json.dumps({
            "dtype": dtype, "k": k,
            "jax": {"r": jr.tolist(), "t": jt.tolist(),
                    "iterations": int(jres.iterations),
                    "overflow": int(jovf), "seconds": t1 - t0},
            "port": {"r": pres.r.numpy().tolist(),
                     "t": pres.t.numpy().tolist(),
                     "iterations": int(pres.iterations),
                     "overflow": int(povf),
                     "seconds": time.perf_counter() - t1}}), flush=True)


def gap(a, b, key):
    return float(np.abs(np.asarray(a[key]) - np.asarray(b[key])).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ks", default="1,2,3,5,10,20")
    ap.add_argument("--child", choices=("float32", "float64"))
    args = ap.parse_args()
    ks = [int(k) for k in args.ks.split(",")]
    if args.child:
        run_child(args.child, ks)
        return 0
    rows = {}
    for dtype in ("float32", "float64"):
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--ks", args.ks, "--child", dtype],
                             capture_output=True, text=True, check=True)
        for line in out.stdout.splitlines():
            print(line, flush=True)
            row = json.loads(line)
            rows[dtype, row["k"]] = row
    for k in ks:
        a, b = rows["float32", k], rows["float64", k]
        print(json.dumps({
            "k": k,
            "t_port32_jax32": gap(a["port"], a["jax"], "t"),
            "r_port32_jax32": gap(a["port"], a["jax"], "r"),
            "t_port64_jax64": gap(b["port"], b["jax"], "t"),
            "r_port64_jax64": gap(b["port"], b["jax"], "r"),
            "t_jax32_jax64": gap(a["jax"], b["jax"], "t"),
            "t_port32_jax64": gap(a["port"], b["jax"], "t"),
            "iterations_equal": len({a["jax"]["iterations"],
                                     a["port"]["iterations"],
                                     b["jax"]["iterations"],
                                     b["port"]["iterations"]}) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
