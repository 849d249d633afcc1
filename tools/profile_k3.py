"""K3, the nearest-neighbour argmin, at the shapes the port's paths give it,
on one GPU, for several minimum split lengths.

    python3 tools/profile_k3.py [--rounds 7] [--reps 50]
                                [--min-splits 4 32 128 512]

Shapes (N queries, M references): the tier-2 ICP (1,024 x 450), the
tier-3 ICP (12,288 x 5,120) and the grid-ICP fallback (4,096 x 100,000).
The points are random from a seed (uniform in a 50 m box, 10% of the
references invalid): K3 does the same work wherever the points lie. For each
shape and each minimum split length (kernels.neighbor.NN_MIN_SPLIT; the
kernel's own value is marked) it prints, as JSON lines, the grid (query
tiles x reference splits), the host wall per call over --reps calls back to back
ending in a synchronise -- --rounds times, the settings taken in turn in
every round, so that the host's slow spells fall on all of them; median and
least -- and the device time per call from torch.profiler
(tools/profile_tier2.profile). Every answer is held to nn_plain bit for
bit.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke  # noqa: E402
import profile_tier2  # noqa: E402

SHAPES = {"tier2_icp": (1024, 450), "tier3_icp": (12_288, 5_120),
          "icp_grid_fallback": (4_096, 100_000)}


def main():
    import torch

    from vtkcloudpoint_tpu_torch.kernels import build
    from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--min-splits", type=int, nargs="+",
                    default=[4, 32, 128, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_k3: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    dev = torch.device("cuda", 0)
    qpb = build.load().vtkcp_nn_queries_per_block()
    target = k_nn.NN_BLOCKS_PER_SM * k_nn.sm_count(0)
    kernel_min = k_nn.NN_MIN_SPLIT
    settings = sorted(set(args.min_splits) | {kernel_min})
    rng = np.random.default_rng(5)

    def with_min_split(min_split, fn):
        k_nn.NN_MIN_SPLIT = min_split
        try:
            return fn()
        finally:
            k_nn.NN_MIN_SPLIT = kernel_min

    for name, (n, m) in SHAPES.items():
        ref = torch.from_numpy(rng.uniform(0, 50, (m, 3)).astype(
            np.float32)).to(dev)
        query = torch.from_numpy(rng.uniform(0, 50, (n, 3)).astype(
            np.float32)).to(dev)
        valid = torch.from_numpy(rng.random(m) < 0.9).to(dev)
        pidx, pd2 = k_nn.nn_plain(query, ref, valid, 1024)

        def call():
            return k_nn.nn_cuda(query, ref, valid)

        rows = {}
        for ms in settings:
            kidx, kd2 = with_min_split(ms, call)
            chip_smoke.require(
                torch.equal(kidx, pidx) and torch.equal(kd2, pd2),
                f"K3 differs from nn_plain at {name}, min split {ms}")
            prof, _, _ = with_min_split(
                ms, lambda: profile_tier2.profile(call, args.reps))
            splits = with_min_split(ms, lambda: k_nn.nn_splits(
                n, m, qpb, target))
            rows[ms] = {"grid": "%d x %d blocks" % (-(-n // qpb), splits[0]),
                        "device_ms": prof["device_ms"], "walls": []}
        for _ in range(args.rounds):
            for ms in settings:
                def timed():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(args.reps):
                        call()
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) * 1e3 / args.reps
                rows[ms]["walls"].append(with_min_split(ms, timed))
        for ms, row in rows.items():
            walls = sorted(row.pop("walls"))
            print(json.dumps({
                "shape": name, "card": card, "n": n, "m": m,
                "min_split": ms, "kernel": ms == kernel_min, **row,
                "wall_ms_median": walls[len(walls) // 2],
                "wall_ms_least": walls[0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
