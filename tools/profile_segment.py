"""Segment sums on the GPU: time and run-to-run repeatability of the ways to
sum float32 rows by segment id, at the shapes the port's callers give them.

    python3 tools/profile_segment.py

Ways (each sums [N, C] float32 values of rows with ``ok`` by id into
[num_segments, C] and rounds once to float32):
  index_add   float64 index_add_ (atomics) of the rows a boolean mask keeps
  put_drop    float64 index_put_(accumulate=True), the other rows sent to
              one extra segment (sorted ids, each segment added in order)
  put_mask    the same after a boolean mask dropped the other rows
  fixed       ops.segment._segment_sum: int64 fixed point, index_add_
Shapes: tier 3's cluster_stats (5M points, 12,289 segments, ~0.4% of the
points in the noise row 0), tier 2's (500k, 1,025), scan-to-map's voxel map
(18,432 rows into 16,384 slots, ~14k of them invalid), and BA's landmark
moments (6,400 observations, 6,401 landmarks, a quarter invalid in
landmark 0), and the same tier-3 rows with values spread over 60 binary
orders of magnitude (where a float64 sum rounds). For each: CUDA-event ms
(mean of 20 calls after one), whether 10 calls give the same bits, and the
largest difference from the fixed-point sums. Prints JSON lines.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def ways():
    import torch

    from vtkcloudpoint_tpu_torch.ops.segment import _segment_sum

    def index_add(v, ok, seg, n):
        out = torch.zeros((n,) + v.shape[1:], dtype=torch.float64,
                          device=v.device)
        return out.index_add_(0, seg[ok], v[ok].double()).float()

    def put_drop(v, ok, seg, n):
        out = torch.zeros((n + 1,) + v.shape[1:], dtype=torch.float64,
                          device=v.device)
        return out.index_put_((torch.where(ok, seg, n),), v.double(),
                              accumulate=True)[:n].float()

    def put_mask(v, ok, seg, n):
        out = torch.zeros((n,) + v.shape[1:], dtype=torch.float64,
                          device=v.device)
        return out.index_put_((seg[ok],), v[ok].double(),
                              accumulate=True).float()

    def fixed(v, ok, seg, n):
        return _segment_sum(v, ok, seg, n).float()

    return {"index_add": index_add, "put_drop": put_drop,
            "put_mask": put_mask, "fixed": fixed}


def cases(dev):
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    out = {}
    for name, n, k, noise, scale in (("tier3_stats", 5_000_000, 12_288,
                                      0.004, 1.0),
                                     ("tier2_stats", 500_000, 1_024, 0.006,
                                      1.0)):
        lab = rng.integers(1, k + 1, n)
        lab[rng.random(n) < noise] = 0
        vals = rng.uniform(-scale, scale, (n, 6)).astype(np.float32)
        out[name] = (vals, np.ones(n, bool), lab, k + 1)
    m = 18_432
    vals = rng.uniform(-30, 30, (m, 4)).astype(np.float32)
    ok = rng.random(m) < 0.24
    out["voxel_map"] = (vals, ok, rng.integers(0, 16_384, m), 16_384)
    o = 6_400
    lab = rng.integers(1, o + 1, o)
    lab[rng.random(o) < 0.25] = 0
    vals = rng.standard_normal((o, 18)).astype(np.float32) * 30
    out["ba_landmarks"] = (vals, np.ones(o, bool), lab, o + 1)
    vals, ok, lab, k = out["tier3_stats"]
    spread = (vals * np.exp2(rng.integers(-40, 20, vals.shape))).astype(
        np.float32)
    out["tier3_wide_range"] = (spread, ok, lab, k)
    return {name: (torch.from_numpy(v).to(dev), torch.from_numpy(ok).to(dev),
                   torch.from_numpy(lab).to(dev), n)
            for name, (v, ok, lab, n) in out.items()}


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_segment: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    dev = torch.device("cuda", 0)
    for name, (v, ok, seg, n) in cases(dev).items():
        row = {"case": name, "card": card, "rows": v.shape[0],
               "segments": n}
        ref = None
        for way, fn in reversed(list(ways().items())):
            first = fn(v, ok, seg, n)
            ref = first if ref is None else ref
            same = all(torch.equal(first, fn(v, ok, seg, n))
                       for _ in range(10))
            row[way] = {"ms": chip_smoke.cuda_ms(lambda: fn(v, ok, seg, n),
                                                 20),
                        "repeats_bit_for_bit": same,
                        "max_abs_diff_from_fixed": float(
                            (first - ref).abs().max())}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
