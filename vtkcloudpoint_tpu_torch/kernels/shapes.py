"""K2: fused per-cluster hull + MEC + min-area rectangle, hand-written for
Hopper (csrc/shapes.cu).

Replaces the Pallas kernel cluster_shapes_pallas
(vtkcloudpoint_tpu/ops/pallas/shapes_kernel.py:273). Its plain PyTorch
version is ``ops.geometry.shapes_plain`` (re-exported here), the batched
gift wrap + pair/triple MEC scan + edge projections with the same
arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.geometry import _triple_table, shapes_plain  # noqa: F401
from . import build

SOURCE = "vtkcloudpoint_tpu_torch/kernels/csrc/shapes.cu"
REPLACES = "vtkcloudpoint_tpu/ops/pallas/shapes_kernel.py:273"

launches = 0


@functools.lru_cache(maxsize=8)
def _candidate_tables(h: int, device):
    """Pair (i < j, row-major) and triple (lexicographic) index tables on
    ``device``, built once per (h, device): a host build and copy per call
    cost more than the kernel itself at the bench shape."""
    pi, pj = np.triu_indices(h, k=1)
    pairs = np.stack([pi, pj], axis=-1).astype(np.int32).reshape(-1, 2)
    return (torch.from_numpy(pairs).to(device),
            torch.from_numpy(_triple_table(h)).to(device))


def shapes_cuda(points, valid, max_hull: int = 64):
    """Launch K2 on CUDA tensors points f32 [K, cap, 2] and valid bool
    [K, cap]. Returns (center_x, center_y, radius, len_long, len_short,
    area), each f32[K], before cluster_shapes' small-cluster zeroing.
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
    if max_hull < 1:
        raise ValueError("shapes_cuda: max_hull must be >= 1")
    lib = build.load()
    pairs, triples = _candidate_tables(max_hull, points.device)
    out = torch.empty((K, 6), dtype=torch.float32, device=points.device)
    with torch.cuda.device(points.device):
        err = lib.vtkcp_cluster_shapes(
            points.data_ptr(), valid.data_ptr(), K, cap, max_hull,
            pairs.data_ptr(), pairs.shape[0], triples.data_ptr(),
            triples.shape[0], out.data_ptr(),
            build.stream_handle(points.device))
    build.check(err, "vtkcp_cluster_shapes")
    launches += 1
    return tuple(out.unbind(dim=1))
