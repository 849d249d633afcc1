"""Neighbour-search kernels, hand-written for Hopper.

K3, nearest-neighbour argmin (csrc/nn.cu), replaces the Pallas kernel
nn_pallas (vtkcloudpoint_tpu/ops/pallas/neighbor.py:183). ``nn_plain``
beside it is the plain PyTorch version with the same semantics: squared
distance from direct differences summed in coordinate order, invalid
references at BIG, ties to the lowest index.

K4, radius neighbour count (csrc/radius.cu), replaces radius_count_pallas
(neighbor.py:86). ``radius_count_plain`` is its plain PyTorch version, the
counterpart of radius_count_jnp; ``radius_count`` dispatches between them.

Each kernel keeps its own launch counter (``launches``, ``radius_launches``):
one a wrapper call (a K3 call launches three CUDA kernels: fill, search,
unpack; a K4 call a memset and the count, or the count and a sum of its
partial counts).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_backend
from . import build

SOURCE = "vtkcloudpoint_tpu_torch/kernels/csrc/nn.cu"
REPLACES = "vtkcloudpoint_tpu/ops/pallas/neighbor.py:183"
RADIUS_SOURCE = "vtkcloudpoint_tpu_torch/kernels/csrc/radius.cu"
RADIUS_REPLACES = "vtkcloudpoint_tpu/ops/pallas/neighbor.py:86"
BIG = 1e30
NN_BLOCKS_PER_SM = 4
# references a K3 split holds at least: one full shared-memory tile of the
# search kernel (tools/profile_k3.py times others)
NN_MIN_SPLIT = 128
RADIUS_METRICS = {"l1_motor": 0, "signed_sum_xy": 1, "l2_xyz": 2,
                  "l2_xy": 2}

launches = 0
radius_launches = 0


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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def nn_splits(n: int, m: int, queries_per_block: int, target_blocks: int):
    """K3's grid: (reference splits, split length) for ``n`` queries in
    tiles of ``queries_per_block`` and ``m`` references, so that the grid
    holds at least ``target_blocks`` blocks where splits of NN_MIN_SPLIT
    references allow (and at most 65,535 splits)."""
    tiles = max(1, -(-n // queries_per_block))
    want = max(1, -(-target_blocks // tiles))
    split_len = max(NN_MIN_SPLIT, m // want, -(-m // 65535), 1)
    return max(1, -(-m // split_len)), split_len


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
    splits, split_len = nn_splits(
        n, m, lib.vtkcp_nn_queries_per_block(),
        NN_BLOCKS_PER_SM * sm_count(query.device.index))
    # merge keys (float bits of d2) << 32 | idx, filled and unpacked on the
    # card
    keys = torch.empty(n, dtype=torch.int64, device=query.device)
    idx = torch.empty(n, dtype=torch.int32, device=query.device)
    d2 = torch.empty(n, dtype=torch.float32, device=query.device)
    with torch.cuda.device(query.device):
        err = lib.vtkcp_nn_argmin(
            query.data_ptr(), ref.data_ptr(), ref_valid.data_ptr(), n, m,
            splits, split_len, keys.data_ptr(), idx.data_ptr(),
            d2.data_ptr(), build.stream_handle(query.device))
    build.check(err, "vtkcp_nn_argmin")
    launches += 1
    return idx, d2


def _radius_threshold(eps: float, metric: str) -> float:
    """The float32 threshold a K4 decision compares against: eps, or for
    L2 eps * eps squared in double and rounded once (what the Pallas kernel
    compares with, neighbor.py:76). An unknown metric raises."""
    if metric not in RADIUS_METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    return float(np.float32(eps * eps if RADIUS_METRICS[metric] == 2
                            else eps))


def radius_count_plain(coords, valid, eps: float, metric: str = "l1_motor",
                       chunk: int = 2048, rows=None):
    """Count of valid points within eps of every point, self included; 0 on
    invalid rows. Query-tiled: i32[N], or i32[len(rows)] for the query
    rows ``rows`` (an index tensor) alone."""
    thr = _radius_threshold(eps, metric)
    code = RADIUS_METRICS[metric]
    queries, qvalid = ((coords, valid) if rows is None
                       else (coords[rows], valid[rows]))
    out = []
    for s in range(0, queries.shape[0], max(chunk, 1)):
        q = queries[s:s + chunk]
        d = None
        for k in range(coords.shape[1]):
            e = q[:, None, k] - coords[None, :, k]
            term = e.abs() if code == 0 else (e if code == 1 else e * e)
            d = term if d is None else d + term
        ok = (d <= thr) & valid[None, :]
        cnt = ok.sum(dim=1, dtype=torch.int32)
        out.append(torch.where(qvalid[s:s + chunk], cnt, 0))
    if not out:
        return torch.empty(0, dtype=torch.int32, device=coords.device)
    return torch.cat(out)


def radius_count_cuda(coords, valid, eps: float, metric: str = "l1_motor"):
    """Launch K4 on CUDA tensors coords f32 [N, D] (D <= 3) and valid bool
    [N]: count i32[N], equal to radius_count_plain for any coordinates (a
    NaN distance is never within). Each unordered pair is tested once, in
    super-tiles of 2,048 points a side; their counts leave by global
    atomics. Launches on the current stream and does not synchronise."""
    global radius_launches
    build.require_cuda("radius_count_cuda", coords=coords, valid=valid)
    if coords.dtype != torch.float32 or valid.dtype != torch.bool:
        raise ValueError("radius_count_cuda: coords must be float32 and "
                         "valid bool")
    if coords.dim() != 2 or not 1 <= coords.shape[1] <= 3:
        raise ValueError(f"radius_count_cuda: coords must be [N, D] with "
                         f"D <= 3, got {tuple(coords.shape)}")
    n, d = coords.shape
    if tuple(valid.shape) != (n,):
        raise ValueError("radius_count_cuda: valid must be [N]")
    if n >= 2**31:
        raise ValueError("radius_count_cuda: N must fit in int32")
    thr = _radius_threshold(eps, metric)
    lib = build.load()
    out = torch.empty(n, dtype=torch.int32, device=coords.device)
    with torch.cuda.device(coords.device):
        err = lib.vtkcp_radius_count(
            coords.data_ptr(), valid.data_ptr(), n, d,
            RADIUS_METRICS[metric], thr, out.data_ptr(),
            build.stream_handle(coords.device))
    build.check(err, "vtkcp_radius_count")
    radius_launches += 1
    return out


def radius_count(coords, valid, eps: float, metric: str = "l1_motor",
                 chunk: int = 2048, backend: str = "auto"):
    """Radius neighbour count: CUDA tensors go to K4, CPU tensors to the
    plain version (the rule of register.icp.nn_correspond)."""
    if resolve_backend(backend, coords.device) == "cuda":
        return radius_count_cuda(coords, valid, eps, metric)
    return radius_count_plain(coords, valid, eps, metric, chunk)
