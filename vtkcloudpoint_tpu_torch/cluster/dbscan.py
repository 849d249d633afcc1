"""DBSCAN as label propagation (port of vtkcloudpoint_tpu.cluster.dbscan).

Reference-ID-compatibility contract (DBImproved.cs semantics):

1. A point is core iff its eps-neighbourhood count INCLUDING itself is
   >= minPts (Q1).
2. Core points within eps of each other are one cluster.
3. Cluster ids follow the scan order of each component's first core point,
   starting at cf + 1 (Q3).
4. A non-core point within eps of cores of several clusters takes the
   LARGEST such id (Q2).
5. Points in no core's neighbourhood keep label 0 (noise).

The plain path here serves CPU tensors and ``backend="torch"``;
``dbscan_blocks_dispatch`` sends CUDA tensors to the hand-written per-block
kernel (kernels/dbscan.py), which is bit-equal to ``dbscan_blocks``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_backend
from ..ops.metrics import pairwise
from ..utils import profiling as prof


def _threshold(eps: float) -> float:
    """eps rounded to float32, the precision of the comparison."""
    return float(np.float32(eps))


def _adjacency(coords, valid, eps: float, metric: str):
    """[..., n, n] bool eps-adjacency (row i -> column j), valid rows and
    columns only."""
    dist = pairwise(coords, coords, metric)
    return (dist <= _threshold(eps)) & valid[..., None, :] & valid[..., :, None]


def _gather_last(x, idx):
    return torch.gather(x, -1, idx.long())


def fixpoint(step, x, max_iters: int):
    """Apply ``step`` until a step changes nothing, at least once and at most
    ``max_iters`` times (the JAX package's first step outside its while loop,
    then ``while changed and it < max_iters``). Reads one flag from the
    device per step and counts each step in ``sweeps``; returns the last
    value."""
    new = step(x)
    prof.count("sweeps")
    it = 1
    while it < max_iters and prof.sync(bool, (new != x).any()):
        x, new = new, step(new)
        prof.count("sweeps")
        it += 1
    return new


def relabel(lab, nbr, core, inf):
    """One propagation sweep's update over the last axis: a core point takes
    the least of its label and its core neighbours' least label ``nbr``,
    then one pointer jump ``min(new, new[new])``; others hold ``inf``."""
    new = torch.where(core, torch.minimum(lab, nbr), inf)
    jumped = _gather_last(new, new.clamp(0, max(new.shape[-1] - 1, 0)))
    return torch.where(new < inf, torch.minimum(new, jumped), inf)


def _min_label_fixpoint(core_adj, core, max_iters: int):
    """Min-index label propagation with pointer jumping over the core graph.

    core_adj: [..., n, n] bool core-core adjacency. Returns root[..., i] = the
    least index reachable from i through core edges (n for non-core). At
    most ``max_iters`` sweeps, as in the reference.
    """
    n = core.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=core.device)
    inf = prof.sync(torch.tensor, n, dtype=torch.int32, device=core.device)

    def sweep(lab):
        nbr = torch.where(core_adj, lab[..., None, :], inf).amin(dim=-1)
        return relabel(lab, nbr, core, inf)

    return fixpoint(sweep, torch.where(core, idx, inf), max_iters)


def _finish(adj, core, valid, root, cf):
    """Root ranks -> core ids cf+1.., border = max adjacent core id."""
    n = core.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=core.device)
    is_root = core & (root == idx)
    rank = torch.cumsum(is_root.to(torch.int32), dim=-1, dtype=torch.int32)
    core_id = torch.where(core, cf + _gather_last(rank, root.clamp(0, n - 1)),
                          0).to(torch.int32)
    border_src = torch.where(adj & core[..., None, :], core_id[..., None, :],
                             0)
    border_id = border_src.amax(dim=-1)
    label = torch.where(core, core_id,
                        torch.where(valid, border_id, 0)).to(torch.int32)
    return label, is_root.sum(dim=-1, dtype=torch.int32)


def _dbscan_batched(coords, valid, eps, min_pts, metric, cf, max_iters):
    adj = _adjacency(coords, valid, eps, metric)
    counts = adj.sum(dim=-1, dtype=torch.int32)
    core = (counts >= min_pts) & valid
    core_adj = adj & core[..., None, :] & core[..., :, None]
    root = _min_label_fixpoint(core_adj, core, max_iters)
    label, n_clusters = _finish(adj, core, valid, root, cf)
    return label, n_clusters, core


def dbscan_padded(coords, valid, eps: float, min_pts: int,
                  metric: str = "l1_motor", cf=0, max_iters: int = 64):
    """DBSCAN over one padded point block.

    coords [cap, D] metric coordinates, valid [cap] bool, cf the starting
    cluster-id seed (int or 0-d tensor). Returns dict: label i32[cap]
    (cf+1..cf+k, 0 noise/invalid), n_clusters i32[], core bool[cap].
    """
    label, n_clusters, core = _dbscan_batched(
        coords, valid, eps, min_pts, metric, cf, max_iters)
    return {"label": label, "n_clusters": n_clusters, "core": core}


def dbscan_dense_chunked(coords, valid, eps: float, min_pts: int,
                         metric: str = "l1_motor", cf=0, chunk: int = 2048,
                         max_iters: int = 64):
    """dbscan_padded semantics without storing the [n, n] adjacency: every
    pass recomputes the distances in [chunk, n] row tiles. Bit-identical to
    dbscan_padded."""
    n = coords.shape[0]
    chunk = max(min(chunk, n), 1)
    inf = prof.sync(torch.tensor, n, dtype=torch.int32, device=coords.device)
    idx = torch.arange(n, dtype=torch.int32, device=coords.device)
    thr = _threshold(eps)

    def row_reduce(fn):
        out = []
        for s in range(0, n, chunk):
            d = pairwise(coords[s:s + chunk], coords, metric)
            adj = (d <= thr) & valid[s:s + chunk, None] & valid[None, :]
            out.append(fn(adj))
        return torch.cat(out) if out else idx[:0]

    counts = row_reduce(lambda adj: adj.sum(dim=1, dtype=torch.int32))
    core = (counts >= min_pts) & valid

    def sweep(lab):
        nbr = row_reduce(lambda adj: torch.where(
            adj & core[None, :], lab[None, :], inf).amin(dim=1))
        return relabel(lab, nbr, core, inf)

    lab = fixpoint(sweep, torch.where(core, idx, inf), max_iters)

    is_root = core & (lab == idx)
    rank = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32)
    core_id = torch.where(core, cf + rank[lab.clamp(0, max(n - 1, 0)).long()],
                          0).to(torch.int32)
    border = row_reduce(lambda adj: torch.where(
        adj & core[None, :], core_id[None, :], 0).amax(dim=1))
    label = torch.where(core, core_id,
                        torch.where(valid, border, 0)).to(torch.int32)
    return {"label": label, "n_clusters": is_root.sum(dtype=torch.int32),
            "core": core}


def dbscan_matlab_convention(data, min_pts: int, eps: float):
    """External-clusterer API shim (Q13): [N, 2] rows, (minPts, eps) in that
    order, Euclidean metric; labels -1 = noise, ids 1..K."""
    data = torch.as_tensor(data)
    out = dbscan_padded(data, torch.ones(data.shape[0], dtype=torch.bool,
                                         device=data.device),
                        eps, min_pts, "l2_xyz")
    lab = out["label"]
    return torch.where(lab == 0, -1, lab), out["n_clusters"]


def dbscan_blocks(coords, valid, eps: float, min_pts: int,
                  metric: str = "l1_motor", max_iters: int = 64,
                  chunk: int = 64):
    """DBSCAN independently over B padded blocks, local ids 1..k_b.

    coords [B, cap, D]; valid [B, cap]. Processed ``chunk`` blocks at a time
    to bound the [chunk, cap, cap] working set. Returns dict: label
    i32[B, cap], n_clusters i32[B], core bool[B, cap].
    """
    labels, counts, cores = [], [], []
    for s in range(0, coords.shape[0], max(chunk, 1)):
        lab, n, core = _dbscan_batched(coords[s:s + chunk],
                                       valid[s:s + chunk], eps, min_pts,
                                       metric, 0, max_iters)
        labels.append(lab)
        counts.append(n)
        cores.append(core)
    return {"label": torch.cat(labels), "n_clusters": torch.cat(counts),
            "core": torch.cat(cores)}


def dbscan_blocks_dispatch(coords, valid, eps: float, min_pts: int,
                           metric: str = "l1_motor", max_iters: int = 64,
                           chunk: int = 64, backend: str = "auto"):
    """Per-block DBSCAN: CUDA tensors go to the per-block kernel (which runs
    every block to its fixpoint, so ``max_iters`` and ``chunk`` do not
    apply), CPU tensors to ``dbscan_blocks``."""
    if resolve_backend(backend, coords.device) == "cuda":
        from ..kernels.dbscan import dbscan_blocks_cuda

        return dbscan_blocks_cuda(coords, valid, eps, min_pts, metric)
    return dbscan_blocks(coords, valid, eps, min_pts, metric, max_iters,
                         chunk)
