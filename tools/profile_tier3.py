"""Where the time of the port's 5M-point tier-3 job goes, on one GPU.

    python3 tools/profile_tier3.py [--reps 2] [--trace FILE.json]

For each stage of the job (chip_smoke.job_stages at TIER3: partition_gather,
dbscan, fusion with the grid-engine noise re-cluster, stats, bucket,
shapes_x2, icp), each alone on fixed inputs after one pass of the whole job,
and for the whole job (chip_smoke.staged_job), over --reps calls:
  wall_ms    host clock per call, ending in torch.cuda.synchronize();
  device_ms  summed device time of every kernel, copy and set per call, from
             torch.profiler (CUPTI);
  idle       1 - device_ms / wall_ms;
and the top device kernels. The whole job also runs with the plain PyTorch
versions (backend "torch") in turns with the kernels (plain, kernel, kernel,
plain). Prints JSON lines; with --trace, writes a Chrome trace of one
kernel-path job there. The same measurements for the tier-2 job:
tools/profile_tier2.py.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tools.profile_tier2 import profile  # noqa: E402


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_tier3: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    inp = chip_smoke.tier3_inputs(torch.device("cuda", 0))

    stages, _ = chip_smoke.job_stages(inp)
    for fn in stages.values():        # one pass fills the namespace
        fn()
    for name, fn in stages.items():
        row, table, _ = profile(fn, args.reps)
        top = [{"kernel": k[:90], "us_per_call": us / args.reps,
                "launches_per_call": c / args.reps}
               for us, c, k in table[:4]]
        print(json.dumps({"stage": name, "card": card, **row, "top": top}))

    row, table, prof = profile(lambda: chip_smoke.staged_job(inp), args.reps)
    top = [{"kernel": k[:90], "us_per_job": us / args.reps,
            "launches_per_job": c / args.reps} for us, c, k in table[:12]]
    print(json.dumps({"stage": "job", "card": card, **row,
                      "device_activities_per_job":
                          sum(c for _, c, _ in table) / args.reps,
                      "top": top}))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)

    walls = {"torch": [], "auto": []}
    for backend in ("torch", "auto", "auto", "torch"):
        chip_smoke.staged_job(inp, backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chip_smoke.staged_job(inp, backend)
        torch.cuda.synchronize()
        walls[backend].append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"stage": "job_plain_vs_kernels", "card": card,
                      "order": "plain, kernel, kernel, plain",
                      "plain_wall_ms": walls["torch"],
                      "kernel_wall_ms": walls["auto"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
