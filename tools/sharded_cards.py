"""The sharded cases of tests/test_torch_sharded.py across N cards: one
process a card on NCCL, against the same N ranks on gloo on the CPU (which
the CPU tests hold to the JAX package's shard_map).

    # where JAX is installed: write the cases' numpy inputs
    python3 tools/sharded_cards.py write DIR [N]
    # on a machine with N cards:
    python3 tools/sharded_cards.py run DIR [N]

``run`` launches the N workers of tests/test_torch_sharded.py on gloo/CPU,
then on NCCL with rank r on cuda:r (float32 cases through K1 and K3,
float64 ones through the plain nearest neighbour), and compares every
output of every case: integer outputs (labels, n_total, overflow counters,
iterations) equal, float outputs (R, t, poses, landmarks, costs, halo
coordinates) within FLOAT_TOL. It prints one JSON line per case and a
summary, and exits non-zero on any difference.
"""
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FLOAT_TOL = 1e-6      # float64 sums in another order on the card


def _cases_module():
    """tests/test_torch_sharded.py, loaded by path (an installed package
    named "tests" would shadow the repo's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "test_torch_sharded", os.path.join(ROOT, "tests",
                                           "test_torch_sharded.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write(workdir, world):
    import tests.conftest  # noqa: F401  (the blob scenes; JAX on the CPU)

    t = _cases_module()
    inputs, cases = t._build_cases()
    t._write(workdir, inputs, [c for c in cases if world in c["worlds"]])


def run(workdir, world):
    t = _cases_module()
    _join, _outputs, _start = t._join, t._outputs, t._start

    outs, secs = {}, {}
    for device in ("cpu", "cuda"):
        d = os.path.join(workdir, device)
        os.makedirs(d, exist_ok=True)
        for name in ("spec.json", "inputs.npz"):
            shutil.copy(os.path.join(workdir, name), d)
        t0 = time.perf_counter()
        _join(_start(world, d, device=device))
        secs[device] = time.perf_counter() - t0
        outs[device] = _outputs(d, world)
    bad = []
    for cid, ref in outs["cpu"].items():
        card = outs["cuda"][cid]
        gaps = {}
        for k, v in ref.items():
            w = card[k]
            if np.issubdtype(v.dtype, np.floating):
                gaps[k] = float(np.abs(w - v).max()) if v.size else 0.0
                ok = gaps[k] <= FLOAT_TOL
            else:
                ok = np.array_equal(w, v)
            if not ok:
                bad.append(f"{cid}/{k}")
        print(json.dumps({"case": cid, "equal": not any(
            b.startswith(cid + "/") for b in bad), "float_gaps": gaps}))
    print(json.dumps({"world": world, "cases": len(outs["cpu"]),
                      "differ": bad, "seconds": secs}))
    return 1 if bad else 0


if __name__ == "__main__":
    cmd, workdir = sys.argv[1], sys.argv[2]
    n = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    if cmd == "write":
        write(workdir, n)
    else:
        sys.exit(run(workdir, n))
