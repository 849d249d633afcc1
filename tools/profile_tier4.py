"""Where the time of the port's tier-4 SLAM job goes, on one GPU.

    python3 tools/profile_tier4.py [--trace FILE.json] [--no-turns]

The job is chip_smoke.tier4_job: slam_pipeline_ba at
tools/tier4_inputs.TIER4 (100 scans of 2,048 points) in float32 through the
kernels. After one warm-up job, for each stage (odometry, closures,
posegraph, observations, ba) and for scan_to_map at
tools/tier4_inputs.SCAN2MAP:
  wall_ms     host clock of the stage in an unprofiled job, ending in
              torch.cuda.synchronize();
  device_ms   summed device time of every kernel, copy and set of the stage
              in a second job profiled stage by stage (torch.profiler);
  idle        1 - device_ms / wall_ms;
  k3          K3 launches in the stage (one per brute-force ICP iteration);
and each stage's top device kernels. Unless --no-turns, the whole job then
runs with the plain versions (backend "torch") in turns with the kernels
(plain, kernel, kernel, plain). Prints JSON lines; with --trace, writes a
Chrome trace of the profiled closures stage there.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tools.profile_tier2 import _device_us  # noqa: E402


class StageProfile:
    """A timer for slam_pipeline_ba: profiles each stage on its own."""

    def __init__(self):
        self.rows, self.profs = {}, {}

    @contextlib.contextmanager
    def __call__(self, name):
        import torch
        from torch.profiler import ProfilerActivity

        k_nn = chip_smoke.kernel_modules()["nn_argmin"]
        torch.cuda.synchronize()
        before = k_nn.launches
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
            torch.cuda.synchronize()
        us, table = _device_us(prof)
        self.rows[name] = {
            "device_ms": us / 1e3, "k3": k_nn.launches - before,
            "device_activities": sum(c for _, c, _ in table),
            "top": [{"kernel": k[:80], "ms": u / 1e3, "count": c}
                    for u, c, k in table[:5]]}
        self.profs[name] = prof


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None)
    ap.add_argument("--no-turns", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_tier4: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    inp = chip_smoke.tier4_inputs(torch.device("cuda", 0))
    f32 = torch.float32

    chip_smoke.tier4_job(inp, f32)                 # warm-up
    timer = chip_smoke.StepTimer()
    chip_smoke.tier4_job(inp, f32, timer=timer)
    prof = StageProfile()
    chip_smoke.tier4_job(inp, f32, timer=prof)
    stage = chip_smoke.StepTimer()
    with stage("scan2map"):
        chip_smoke.tier4_s2m(inp, f32)
    with prof("scan2map"):
        chip_smoke.tier4_s2m(inp, f32)
    walls = {**timer.wall, **stage.wall}
    for name, row in prof.rows.items():
        wall = walls[name]
        print(json.dumps({"stage": name, "card": card, "wall_ms": wall,
                          "idle": 1.0 - row["device_ms"] / wall, **row}))
    wall = sum(timer.wall.values())
    dev = sum(prof.rows[k]["device_ms"] for k in timer.wall)
    print(json.dumps({"stage": "job", "card": card, "wall_ms": wall,
                      "device_ms": dev, "idle": 1.0 - dev / wall}))
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.profs["closures"].export_chrome_trace(args.trace)

    if not args.no_turns:
        turns = {"torch": [], "auto": []}
        for backend in ("torch", "auto", "auto", "torch"):
            t0 = time.perf_counter()
            chip_smoke.tier4_job(inp, f32, backend)
            turns[backend].append(time.perf_counter() - t0)
        print(json.dumps({"stage": "job_plain_vs_kernels", "card": card,
                          "order": "plain, kernel, kernel, plain",
                          "plain_wall_s": turns["torch"],
                          "kernel_wall_s": turns["auto"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
