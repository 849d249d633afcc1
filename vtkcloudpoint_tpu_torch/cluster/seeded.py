"""Truth-seeded clustering: every raw point joins the nearest truth marker
within ``cluster_radius`` (port of vtkcloudpoint_tpu.cluster.seeded).

The reference's "source-file clustering" alternative to DBSCAN
(refreshClusList, FrmMain.cs:3437-3467). The distance is the
|a|^2 - 2ab + |b|^2 expansion of ops.metrics.pairwise_sqdist, as in the JAX
function, so that labels agree with it on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.metrics import pairwise_sqdist


def seeded_labels(motor, valid, truth_tmp_xy, truth_valid, truth_ids,
                  cluster_radius: float, chunk: int = 2048):
    """Returns (label i32[N] -- the nearest truth id, or 0 --, n_assigned,
    n_noise). Acceptance is strict (< cluster_radius); the nearest truth
    point wins, the lowest index on ties."""
    bad = torch.where(truth_valid, 0.0, torch.inf).to(truth_tmp_xy.dtype)
    radius = float(np.float32(cluster_radius))
    labels = []
    for s in range(0, motor.shape[0], max(chunk, 1)):
        d2 = pairwise_sqdist(motor[s:s + chunk], truth_tmp_xy) + bad[None, :]
        idx = torch.argmin(d2, dim=1, keepdim=True)
        dmin = torch.sqrt(torch.gather(d2, 1, idx)[:, 0])
        ok = valid[s:s + chunk] & (dmin < radius)
        labels.append(torch.where(ok, truth_ids[idx[:, 0]], 0).to(
            torch.int32))
    label = (torch.cat(labels) if labels
             else torch.empty(0, dtype=torch.int32, device=motor.device))
    n_assigned = (label > 0).sum(dtype=torch.int32)
    n_noise = (valid & (label == 0)).sum(dtype=torch.int32)
    return label, n_assigned, n_noise
