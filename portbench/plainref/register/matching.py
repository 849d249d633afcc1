"""Post-ICP nearest-neighbour match assignment (port of
vtkcloudpoint_tpu.register.matching).

RecorrectMatchingPtsByDistance (FrmMain.cs:3588-3618): each transformed
centroid takes its nearest truth point (3D Euclidean) and is accepted iff
the distance is strictly below match_distance. The nearest neighbour comes
from ``nn_correspond``, so K3 runs on CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import se3
from .icp import nn_correspond


def assign_matches(centers, centers_valid, truth, truth_valid, r, t,
                   match_distance: float, chunk: int = 2048,
                   backend: str = "auto"):
    """Transform centers by (r, t) and match them to truth. Returns dict:
    matched_xyz f[N, 3], match_idx i32[N], match_dist f[N], is_matched
    bool[N] (dist < match_distance, strict), n_matched i32[]."""
    moved = se3.apply_rigid(r, t, centers)
    idx, d2 = nn_correspond(moved, truth, truth_valid, chunk, backend)
    dist = torch.sqrt(d2)
    # the threshold in float32, the precision JAX compares in
    is_matched = centers_valid & (dist < float(np.float32(match_distance)))
    return {
        "matched_xyz": moved,
        "match_idx": idx,
        "match_dist": dist,
        "is_matched": is_matched,
        "n_matched": is_matched.sum(dtype=torch.int32),
    }


def registration_rmse(result_matches, truth):
    """RMSE over the accepted matches (the BASELINE.md registration
    metric)."""
    m = result_matches["is_matched"]
    moved = result_matches["matched_xyz"]
    tgt = truth[result_matches["match_idx"].long()]
    se = ((moved - tgt) ** 2).sum(dim=-1)
    n = torch.clamp_min(m.to(se.dtype).sum(), 1.0)
    return torch.sqrt(torch.where(m, se, 0.0).sum() / n)
