"""K1: per-block DBSCAN, hand-written for Hopper (csrc/dbscan_block.cu).

Replaces the Pallas kernels dbscan_blocks_pallas and
dbscan_blocks_pallas_batched (vtkcloudpoint_tpu/ops/pallas/
dbscan_kernel.py:165, :215). Its plain PyTorch version is
``cluster.dbscan.dbscan_blocks`` (re-exported here as ``dbscan_blocks``),
which is bit-equal: same labels, core flags and cluster counts.
"""
from __future__ import annotations

import numpy as np
import torch

from ..cluster.dbscan import dbscan_blocks  # noqa: F401  (plain version)
from . import build

SOURCE = "vtkcloudpoint_tpu_torch/kernels/csrc/dbscan_block.cu"
REPLACES = "vtkcloudpoint_tpu/ops/pallas/dbscan_kernel.py:165"
METRICS = {"l1_motor": 0, "signed_sum_xy": 1, "l2_xyz": 2, "l2_xy": 2}
MAX_SMEM = 232448          # H100: opt-in shared memory per block

launches = 0


def dbscan_blocks_cuda(coords, valid, eps: float, min_pts: int,
                       metric: str = "l1_motor"):
    """Launch K1 on CUDA tensors coords f32 [B, cap, D] (D = 2 or 3) and
    valid bool [B, cap]. Returns dict: label i32[B, cap], n_clusters
    i32[B], core bool[B, cap]. Every block runs to its fixpoint. Launches
    on the current stream and does not synchronise."""
    global launches
    out = launch(coords, valid, eps, min_pts, metric)
    launches += 1
    return out


def launch(coords, valid, eps: float, min_pts: int,
           metric: str = "l1_motor", lib=None):
    """Check the arguments and launch ``vtkcp_dbscan_blocks`` of ``lib``:
    the kernel library (None), or the diagnostic build of
    tools/profile_k1.py."""
    build.require_cuda("dbscan_blocks_cuda", coords=coords, valid=valid)
    if coords.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("dbscan_blocks_cuda: coords must be float32 and "
                         "valid bool")
    if coords.dim() != 3 or coords.shape[2] not in (2, 3):
        raise ValueError(f"dbscan_blocks_cuda: coords must be [B, cap, 2|3]"
                         f", got {tuple(coords.shape)}")
    B, cap, d = coords.shape
    if tuple(valid.shape) != (B, cap):
        raise ValueError("dbscan_blocks_cuda: valid must be [B, cap]")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    lib = lib if lib is not None else build.load()
    smem = lib.vtkcp_dbscan_smem_bytes(cap, d, METRICS[metric])
    if smem > MAX_SMEM:
        raise ValueError(f"dbscan_blocks_cuda: cap {cap} needs {smem} bytes "
                         f"of shared memory, more than {MAX_SMEM}")
    # the threshold in float32, as the reference compares: eps, or eps^2
    # for the squared L2 distance
    thr = float(np.float32(eps * eps if METRICS[metric] == 2 else eps))
    label = torch.empty((B, cap), dtype=torch.int32, device=coords.device)
    n_clusters = torch.empty(B, dtype=torch.int32, device=coords.device)
    core = torch.empty((B, cap), dtype=torch.bool, device=coords.device)
    with torch.cuda.device(coords.device):
        err = lib.vtkcp_dbscan_blocks(
            coords.data_ptr(), valid.data_ptr(), B, cap, d, METRICS[metric],
            thr, int(min_pts), label.data_ptr(), n_clusters.data_ptr(),
            core.data_ptr(), build.stream_handle(coords.device))
    build.check(err, "vtkcp_dbscan_blocks")
    return {"label": label, "n_clusters": n_clusters, "core": core}
