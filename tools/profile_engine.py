"""Where the time of the port's Engine session goes, on one GPU.

    python3 tools/profile_engine.py [--reps 3] [--trace engine_trace.json]

The session of tools/engine_session.py (500k points) through the Engine with
the kernels. Each step of chip_smoke.ENGINE_STEPS runs alone on fixed inputs
(the previous steps' results, computed once) after a warm-up, over --reps
calls (export: one), and the whole session once more under the profiler:
  wall_ms    host clock per call, ending in torch.cuda.synchronize();
  device_ms  summed device time of every kernel, copy and set per call, from
             torch.profiler (CUPTI);
  idle       1 - device_ms / wall_ms (one stream: activities do not
             overlap).
Also prints the iterations and final error of each multi-start run.
Prints JSON lines; with --trace, writes a Chrome trace of the whole session.
"""
import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tools.profile_tier2 import profile  # noqa: E402


def engine_steps(sess, run, dev, outdir):
    """ENGINE_STEPS -> zero-argument callables on fixed inputs: ``run``,
    the results of chip_smoke.engine_run."""
    import torch

    from tools.engine_session import SESSION, engine_config
    from vtkcloudpoint_tpu_torch.engine import Engine

    eng = Engine(engine_config(), device=dev)
    eng_ms = Engine(engine_config(num_starts=SESSION["num_starts"]),
                    device=dev)
    eng_rs = Engine(engine_config(ransac_iters=SESSION["ransac_iters"]),
                    device=dev)

    def gen():
        return torch.Generator().manual_seed(0)

    return {
        "import": lambda: eng.import_arrays(sess.motor, sess.rng,
                                            capacity=SESSION["capacity"]),
        "filter": lambda: eng.filter_by_distance(
            run.batch, SESSION["dis_min"], SESSION["dis_max"]),
        "cluster": lambda: eng.cluster(run.batch, **SESSION["cluster"]),
        "reject": lambda: eng.reject_by_radius(
            run.batch, run.res, radius=SESSION["reject_radius"]),
        "register": lambda: eng.register_to_truth(run.res, sess.truth),
        "register_multistart": lambda: eng_ms.register_to_truth(
            run.res, sess.truth, generator=gen()),
        "register_ransac": lambda: eng_rs.register_to_truth(
            run.res, sess.truth, generator=gen()),
        "match": lambda: eng.match(run.res, sess.truth, run.reg),
        "export": lambda: (
            eng.export_centroids(os.path.join(outdir, "c.txt"), run.res),
            eng.export_cluster_points(os.path.join(outdir, "p.txt"),
                                      run.kept, run.res)),
    }


def multistart_runs(sess, run, dev):
    """Iterations and final error of each start of register_multistart."""
    import torch

    from tools.engine_session import SESSION, engine_config
    from vtkcloudpoint_tpu_torch.engine import Engine, _live_clusters
    from vtkcloudpoint_tpu_torch.register.icp import icp, \
        multistart_rotations

    eng = Engine(engine_config(), device=dev)
    src, tgt = eng.coarse_align(run.res, sess.truth)
    r0s = multistart_rotations(SESSION["num_starts"],
                               torch.Generator().manual_seed(0),
                               device=dev)
    ones = torch.ones(tgt.shape[0], dtype=torch.bool, device=dev)
    out = []
    for r0 in r0s:
        res = icp(src, _live_clusters(run.res), tgt, ones, eng.cfg.icp,
                  r0=r0)
        out.append({"iterations": int(res.iterations),
                    "error": float(res.error)})
    return out


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    dev = torch.device("cuda", 0)
    sess = chip_smoke.engine_session_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        run = chip_smoke.engine_run(sess, dev, "auto", tmp)
        total = {"wall_ms": 0.0, "device_ms": 0.0}
        for name, fn in engine_steps(sess, run, dev, tmp).items():
            reps = 1 if name == "export" else args.reps
            row, table, _ = profile(fn, reps)
            total["wall_ms"] += row["wall_ms"]
            total["device_ms"] += row["device_ms"]
            top = [{"kernel": k[:90], "us_per_call": us / reps,
                    "launches_per_call": c / reps}
                   for us, c, k in table[:4]]
            print(json.dumps({"step": name, "card": card, **row,
                              "top": top}))
        total["idle"] = 1.0 - total["device_ms"] / total["wall_ms"]
        print(json.dumps({"step": "sum_of_steps", "card": card, **total}))
        print(json.dumps({"step": "multistart_runs", "card": card,
                          "runs": multistart_runs(sess, run, dev)}))
        row, table, prof = profile(
            lambda: chip_smoke.engine_run(sess, dev, "auto", tmp), 1)
    top = [{"kernel": k[:90], "us": us, "launches": c}
           for us, c, k in table[:10]]
    print(json.dumps({"step": "session", "card": card, **row,
                      "device_activities": sum(c for _, c, _ in table),
                      "top": top}))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
