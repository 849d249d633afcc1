"""Grid-hash nearest-neighbour correspondence for large ICP targets (port of
vtkcloudpoint_tpu.register.nn_grid).

The target bins once into ``cell_size`` cells (dense ids over the padded
box); each query inspects its 27-cell stencil. Exactness contract:

- if the best stencil candidate lies within cell_size and no stencil cell
  overflowed ``cell_cap``, it is the global nearest neighbour;
- every other query is unresolved and falls back to exact brute force, the
  first ``fallback_cap`` of them in query order, through
  ``register.icp.nn_correspond`` (K3 on a CUDA tensor, its plain version on
  the CPU: direct differences, first index on ties). Unresolved queries
  beyond that keep their stencil result with resolved False.

The stencil argmin runs over stencil-offset x slot order (offsets nested
dx, dy, dz), not over original indices, so ``idx`` equals JAX's at exact
ties. As in the compiled JAX program, the division by the cell size is a
multiplication by its reciprocal in the points' precision
(``cluster.grid.reciprocal``). Plain PyTorch: the JAX package
runs this as XLA, with no Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cluster.grid import reciprocal
from ..config import ICPConfig
from ..utils import profiling as prof
from .icp import icp_loop, nn_correspond

_INT_MAX = 2**31 - 1
# 27-cell stencil offsets in (dx, dy, dz) cell units
_OFFS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
         for dz in (-1, 0, 1)]


class NNGrid(NamedTuple):
    pts: torch.Tensor       # [M, 3] target points sorted by cell id
    valid: torch.Tensor     # [M] sorted validity
    sc: torch.Tensor        # [M] i64 sorted cell ids (invalid -> INT_MAX)
    order: torch.Tensor     # [M] sorted position -> original index
    origin: torch.Tensor    # [3] grid origin (min corner)
    dims: torch.Tensor      # [3] i64 cell counts per axis (interior)
    strides: torch.Tensor   # [2] i64 (stride_x, stride_y); stride_z == 1


def _cell_ids(pts, origin, dims, strides, cell_size: float):
    """Cell id per point; coordinates clamp to one ghost layer around the
    grid, so ids stay unique on [-1, dims + 1] per axis."""
    c = torch.floor((pts - origin) * reciprocal(cell_size, pts.dtype)).long()
    c = torch.maximum(torch.minimum(c, dims + 1), torch.full_like(c, -1))
    return (c[:, 0] + 1) * strides[0] + (c[:, 1] + 1) * strides[1] \
        + (c[:, 2] + 1)


def build_nn_grid(ref, ref_valid, cell_size: float) -> NNGrid:
    """Sort the target by cell (one O(M log M) build)."""
    lo = torch.where(ref_valid[:, None], ref, 1e30).amin(dim=0)
    hi = torch.where(ref_valid[:, None], ref, -1e30).amax(dim=0)
    dims = torch.floor((hi - lo) * reciprocal(cell_size, ref.dtype)).long()
    dims = dims + 1
    dims = dims.clamp_min(1)
    # strides over the padded box (+3 per axis: two ghost layers and the
    # clamp slot)
    sy = dims[2] + 3
    strides = torch.stack([(dims[1] + 3) * sy, sy])
    cell = torch.where(ref_valid,
                       _cell_ids(ref, lo, dims, strides, cell_size), _INT_MAX)
    sc, order = torch.sort(cell, stable=True)
    return NNGrid(pts=ref[order], valid=ref_valid[order], sc=sc, order=order,
                  origin=lo, dims=dims, strides=strides)


def _stencil_query(grid: NNGrid, query, cell_size: float, cell_cap: int,
                   chunk: int):
    """Best candidate within the 27-cell stencil per query: (idx original
    i64[N], d2 f[N], resolved bool[N]); resolved means provably the exact
    global nearest neighbour."""
    m = grid.pts.shape[0]
    dev = query.device
    qc = torch.floor((query - grid.origin) * reciprocal(cell_size,
                                                       query.dtype)).long()
    qc = torch.maximum(torch.minimum(qc, grid.dims + 1),
                       torch.full_like(qc, -1))
    sx, sy = grid.strides[0], grid.strides[1]
    base = (qc[:, 0] + 1) * sx + (qc[:, 1] + 1) * sy + (qc[:, 2] + 1)
    offs = prof.sync(torch.tensor, _OFFS, device=dev)
    want = base[:, None] + (offs[:, 0] * sx + offs[:, 1] * sy + offs[:, 2])
    k_idx = torch.arange(cell_cap, device=dev)
    thr = float(np.float32(cell_size * cell_size))
    out = []
    for s in range(0, query.shape[0], chunk):
        q, w = query[s:s + chunk], want[s:s + chunk].contiguous()
        st = torch.searchsorted(grid.sc, w)
        en = torch.searchsorted(grid.sc, w + 1)
        overflow = ((en - st) > cell_cap).any(dim=1)
        raw = st[:, :, None] + k_idx                         # [c, 27, cap]
        in_cell = raw < en[:, :, None]
        cand = raw.clamp_max(m - 1).reshape(q.shape[0], -1)
        ok = in_cell.reshape(q.shape[0], -1) & grid.valid[cand]
        e = q[:, None, 0] - grid.pts[cand, 0]
        d2 = e * e
        for k in (1, 2):
            e = q[:, None, k] - grid.pts[cand, k]
            d2 = d2 + e * e
        d2 = torch.where(ok, d2, torch.inf)
        best = torch.argmin(d2, dim=1, keepdim=True)
        bd2 = torch.gather(d2, 1, best)[:, 0]
        bidx = torch.gather(cand, 1, best)[:, 0]
        out.append((grid.order[bidx], bd2, (bd2 <= thr) & ~overflow))
    return tuple(torch.cat(col) for col in zip(*out))


def nn_grid(grid: NNGrid, query, ref, ref_valid, cell_size: float,
            cell_cap: int = 16, fallback_cap: int = 1024, chunk: int = 4096,
            bf_chunk: int = 1024, backend: str = "auto"):
    """Exact NN against a pre-built grid, with brute-force fallback.

    ref/ref_valid are the original (unsorted) target the grid was built
    from. Returns (idx i32[N], d2 f[N], resolved bool[N],
    n_unresolved_overflow i32[]); resolved[i] means idx[i], d2[i] are the
    exact global nearest neighbour.
    """
    n = query.shape[0]
    idx, d2, resolved = _stencil_query(grid, query, cell_size, cell_cap,
                                       min(chunk, max(n, 1)))
    if fallback_cap > 0:
        fb = min(fallback_cap, n)
        sel = torch.sort(torch.where(resolved, 1, 0), stable=True)[1][:fb]
        sel_unres = ~resolved[sel]
        fidx, fd2 = nn_correspond(query[sel].contiguous(), ref, ref_valid,
                                  min(bf_chunk, fb), backend)
        idx[sel] = torch.where(sel_unres, fidx.long(), idx[sel])
        d2[sel] = torch.where(sel_unres, fd2.to(d2.dtype), d2[sel])
        resolved[sel] = True
    overflow = (~resolved).sum(dtype=torch.int32)
    return idx.to(torch.int32), d2, resolved, overflow


def icp_grid(source, source_valid, target, target_valid,
             cfg: ICPConfig = ICPConfig(), cell_size: float = 1.0,
             cell_cap: int = 16, fallback_cap: int = 1024, chunk: int = 4096,
             r0=None, t0=None, backend: str = "auto"):
    """ICP with grid-hash correspondence: the loop of register.icp.icp, but
    the target grid builds once and each iteration queries it. Sources
    still unresolved after the fallback drop out of that iteration's solve
    (trimmed ICP). Returns (ICPResult, the last iteration's unresolved
    overflow i32[])."""
    grid = build_nn_grid(target, target_valid, cell_size)
    last = {"overflow": torch.zeros((), dtype=torch.int32,
                                    device=source.device)}

    def correspond(p):
        idx, d2, resolved, overflow = nn_grid(
            grid, p, target, target_valid, cell_size, cell_cap=cell_cap,
            fallback_cap=fallback_cap, chunk=chunk, backend=backend)
        last["overflow"] = overflow
        return idx, d2, source_valid & resolved

    res = icp_loop(source, source_valid, target, target_valid, cfg, r0, t0,
                   correspond)
    return res, last["overflow"]
