"""K2: fused per-cluster hull + MEC + min-area rectangle, hand-written for
Hopper (csrc/shapes.cu).

Replaces the Pallas kernel cluster_shapes_pallas
(vtkcloudpoint_tpu/ops/pallas/shapes_kernel.py:273). Its plain PyTorch
version is ``ops.geometry.shapes_plain`` (re-exported here), the batched
gift wrap + pair/triple MEC scan + edge projections with the same
arithmetic. The kernel enumerates the MEC candidates of each cluster's own
hull size inside the kernel, in the order of the plain version's tables.
"""
from __future__ import annotations

import torch

from ..ops.geometry import shapes_plain  # noqa: F401  (plain version)
from . import build

SOURCE = "vtkcloudpoint_tpu_torch/kernels/csrc/shapes.cu"
REPLACES = "vtkcloudpoint_tpu/ops/pallas/shapes_kernel.py:273"
MAX_HULL = 1024            # a candidate key holds 10 bits an index
MAX_SMEM = 232448          # H100: opt-in shared memory per block

launches = 0


def shapes_cuda(points, valid, max_hull: int = 64):
    """Launch K2 on CUDA tensors points f32 [K, cap, 2] and valid bool
    [K, cap]. Returns (center_x, center_y, radius, len_long, len_short,
    area), each f32[K], before cluster_shapes' small-cluster zeroing. The
    kernel takes the warps a cluster from K and the card's SM count.
    Launches on the current stream and does not synchronise."""
    global launches
    build.require_cuda("shapes_cuda", points=points, valid=valid)
    if points.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("shapes_cuda: points must be float32 and valid "
                         "bool")
    if points.dim() != 3 or points.shape[2] != 2:
        raise ValueError(f"shapes_cuda: points must be [K, cap, 2], got "
                         f"{tuple(points.shape)}")
    K, cap, _ = points.shape
    if tuple(valid.shape) != (K, cap):
        raise ValueError("shapes_cuda: valid must be [K, cap]")
    if not 1 <= max_hull <= MAX_HULL:
        raise ValueError(f"shapes_cuda: max_hull must be in 1 .. {MAX_HULL}")
    lib = build.load()
    smem = lib.vtkcp_shapes_smem_bytes(max(cap, 1), max_hull)
    if smem > MAX_SMEM:
        raise ValueError(f"shapes_cuda: cap {cap} needs {smem} bytes of "
                         f"shared memory, more than {MAX_SMEM}")
    out = torch.empty((K, 6), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        err = lib.vtkcp_cluster_shapes(
            points.data_ptr(), valid.data_ptr(), K, cap, max_hull,
            out.data_ptr(), build.stream_handle(points.device))
    build.check(err, "vtkcp_cluster_shapes")
    launches += 1
    return tuple(out.unbind(dim=1))
