"""Where the time of the port's tier-2 job goes, on one GPU.

    python3 tools/profile_tier2.py [--reps 5] [--trace chiprun_out/tier2.json]

For each bench stage (chip_smoke.tier2_stages) and for the whole job
(chip_smoke.tier2_job), after a warm-up, over --reps calls:
  wall_ms    host clock per call, ending in torch.cuda.synchronize();
  device_ms  summed device time of every kernel, copy and set per call, from
             torch.profiler (CUPTI);
  idle       1 - device_ms / wall_ms: the share of the call the card waits
             for the host (one stream, so device activities do not overlap);
and the top device kernels of the whole job. The whole job also runs with
the plain PyTorch versions (backend "torch") in turns with the kernels
(plain, kernel, kernel, plain) for an end-to-end comparison. Prints JSON
lines; writes a Chrome trace of one kernel-path job to --trace.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _device_us(prof):
    """Total device time (us) and the per-kernel table of a profile."""
    total, table = 0.0, []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        dev_type = str(getattr(ev, "device_type", ""))
        if us > 0 and "CUDA" in dev_type:
            total += us
            table.append((us, ev.count, ev.key))
    return total, sorted(table, reverse=True)


def profile(fn, reps):
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us, table = _device_us(prof)
    device = dev_us / 1e3 / reps
    return {"wall_ms": wall, "device_ms": device,
            "idle": 1.0 - device / wall if wall > 0 else None}, table, prof


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default="chiprun_out/tier2_trace.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_tier2: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    inp = chip_smoke.tier2_inputs(torch.device("cuda", 0))

    stages, _ = chip_smoke.tier2_stages(inp)
    for name, fn in stages.items():
        row, table, _ = profile(fn, args.reps)
        top = [{"kernel": k[:90], "us_per_call": us / args.reps,
                "launches_per_call": c / args.reps}
               for us, c, k in table[:4]]
        print(json.dumps({"stage": name, "card": card, **row, "top": top}))

    row, table, prof = profile(lambda: chip_smoke.tier2_job(inp),
                               args.reps)
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
        chip_smoke.tier2_job(inp, backend)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            chip_smoke.tier2_job(inp, backend)
        torch.cuda.synchronize()
        walls[backend].append((time.perf_counter() - t0) * 1e3 / args.reps)
    print(json.dumps({"stage": "job_plain_vs_kernels", "card": card,
                      "order": "plain, kernel, kernel, plain",
                      "plain_wall_ms": walls["torch"],
                      "kernel_wall_ms": walls["auto"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
