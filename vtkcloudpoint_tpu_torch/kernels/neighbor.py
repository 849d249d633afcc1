"""K3: nearest-neighbour argmin, hand-written for Hopper (csrc/nn.cu).

Replaces the Pallas kernel nn_pallas (vtkcloudpoint_tpu/ops/pallas/
neighbor.py:183). ``nn_plain`` beside it is the plain PyTorch version with
the same semantics: squared distance from direct differences summed in
coordinate order, invalid references at BIG, ties to the lowest index.
"""
from __future__ import annotations

import torch

from . import build

SOURCE = "vtkcloudpoint_tpu_torch/kernels/csrc/nn.cu"
REPLACES = "vtkcloudpoint_tpu/ops/pallas/neighbor.py:183"
BIG = 1e30

launches = 0


def nn_plain(query, ref, ref_valid, chunk: int = 2048):
    """Nearest valid reference per query, query-tiled: (idx i32[N],
    d2 f32[N]); with no valid reference (0, BIG)."""
    idx, d2 = [], []
    for s in range(0, query.shape[0], max(chunk, 1)):
        q = query[s:s + chunk]
        e = q[:, None, 0] - ref[None, :, 0]
        d = e * e
        for k in range(1, q.shape[1]):
            e = q[:, None, k] - ref[None, :, k]
            d = d + e * e
        d = torch.where(ref_valid[None, :], d, BIG)
        i = torch.argmin(d, dim=1, keepdim=True)
        idx.append(i[:, 0].to(torch.int32))
        d2.append(torch.gather(d, 1, i)[:, 0])
    if not idx:
        return (torch.empty(0, dtype=torch.int32, device=query.device),
                torch.empty(0, dtype=query.dtype, device=query.device))
    return torch.cat(idx), torch.cat(d2)


def nn_cuda(query, ref, ref_valid):
    """Launch K3 on CUDA tensors query f32 [N, 3], ref f32 [M, 3] and
    ref_valid bool [M]: (idx i32[N], d2 f32[N]). Launches on the current
    stream and does not synchronise."""
    global launches
    build.require_cuda("nn_cuda", query=query, ref=ref, ref_valid=ref_valid)
    if (query.dtype != torch.float32 or ref.dtype != torch.float32
            or ref_valid.dtype != torch.bool):
        raise ValueError("nn_cuda: query and ref must be float32, ref_valid "
                         "bool")
    if query.dim() != 2 or query.shape[1] != 3 or ref.dim() != 2 \
            or ref.shape[1] != 3:
        raise ValueError("nn_cuda: query and ref must be [N, 3] and [M, 3]")
    n, m = query.shape[0], ref.shape[0]
    if tuple(ref_valid.shape) != (m,):
        raise ValueError("nn_cuda: ref_valid must be [M]")
    if n >= 2**31 or m >= 2**31:
        raise ValueError("nn_cuda: N and M must fit in int32")
    lib = build.load()
    idx = torch.empty(n, dtype=torch.int32, device=query.device)
    d2 = torch.empty(n, dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = lib.vtkcp_nn_argmin(
            query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(), n, m,
            idx.data_ptr(), d2.data_ptr(),
            build.stream_handle(query.device))
    build.check(err, "vtkcp_nn_argmin")
    launches += 1
    return idx, d2
