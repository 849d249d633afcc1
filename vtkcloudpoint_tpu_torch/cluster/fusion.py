"""Cross-block cluster fusion: global renumbering, small-cluster cull, noise
re-cluster, centroid-distance merge (port of
vtkcloudpoint_tpu.cluster.fusion).

Quirks under ``quirks=True`` (PARITY Q4-Q6): the first run of a cell with no
noise is overcounted by one, the last run of a cell escapes the cull, and
the noise re-cluster seeds at n_kept - 1. ``quirks=False`` is the clean
mode. The JAX TPU branches (compare-and-reduce counts, one-hot matmul id
application) are not ported; the flat scatter/gather branches are.
"""
from __future__ import annotations

import torch

from ..utils import profiling as prof
from .dbscan import dbscan_dense_chunked, dbscan_padded
from .grid import dbscan_grid, grid_metric

DENSE_MAX = 8192   # stored-adjacency noise engine up to this capacity


def _block_label_counts(block_labels, block_valid, kmax: int):
    """[B, kmax] occurrence counts of local label c in block b."""
    B = block_labels.shape[0]
    flat = (torch.arange(B, device=block_labels.device)[:, None] * kmax
            + block_labels.long()).reshape(-1)
    sel = prof.sync(lambda: flat[block_valid.reshape(-1)])
    return prof.sync(torch.bincount, sel, minlength=B * kmax).reshape(B,
                                                                    kmax)


def block_keep_rules(counts, min_cluster_size: int, quirks: bool):
    """CompleteWork3 cull rules from per-block label counts [B, kmax]
    (column 0 = noise run) -> keep [B, kmax - 1] bool. Per-block-local."""
    B, kmax = counts.shape
    present = counts[:, 1:] > 0
    n_run = counts[:, 1:]
    if quirks:
        ids = torch.arange(1, kmax, device=counts.device)[None, :]
        has_noise = counts[:, 0] > 0
        max_id = torch.where(present, ids, 0).amax(dim=1)
        is_last = ids == max_id[:, None]
        eff_len = torch.where((ids == 1) & ~has_noise[:, None], n_run + 1,
                              n_run)
        return present & (is_last | (eff_len > min_cluster_size))
    return present & (n_run > min_cluster_size)


def block_keep_renumber(counts, min_cluster_size: int, quirks: bool):
    """Cull + global renumber: (keep [B, kmax - 1], gid i32 [B, kmax - 1]
    -- the global id at each kept (block, local id) --, n_kept i32[])."""
    B, kmax = counts.shape
    keep = block_keep_rules(counts, min_cluster_size, quirks)
    gid = torch.cumsum(keep.reshape(-1).to(torch.int32), 0,
                       dtype=torch.int32).reshape(B, kmax - 1)
    return keep, gid, gid.reshape(-1)[-1]


def gid_bound(n_blocks: int, cap: int, min_cluster_size: int,
              quirks: bool) -> int:
    """Upper bound on the largest global id the cull can keep."""
    per_run = max(min_cluster_size + 1, 1)
    bound = n_blocks * cap // per_run
    return bound + n_blocks if quirks else bound


def apply_block_gid(block_labels, block_valid, keep, gid):
    """Point-level global ids [Bl, cap] from the keep/renumber tables
    (culled and noise points -> 0), by a flat gather."""
    Bl, cap = block_labels.shape
    kmax = cap + 1
    zero = torch.zeros((Bl, 1), dtype=torch.int32, device=gid.device)
    keep_full = torch.cat([zero.bool(), keep], dim=1).reshape(-1)
    gid_full = torch.cat([zero, gid], dim=1).reshape(-1)
    flat = (torch.arange(Bl, device=block_labels.device)[:, None] * kmax
            + block_labels.long()).reshape(-1)
    point_keep = keep_full[flat].reshape(Bl, cap)
    return torch.where(block_valid & point_keep,
                       gid_full[flat].reshape(Bl, cap), 0)


def noise_pack_order(block_labels, noise_mask, capacity: int):
    """(order [capacity], sel bool[capacity]): noise points in reference
    zeroList order -- per block ascending local id, then slot order (a
    stable sort on (block, local id))."""
    B, cap = block_labels.shape
    kmax = cap + 1
    sentinel = 2**31 - 1
    okey = (torch.arange(B, device=block_labels.device)[:, None] * kmax
            + block_labels.long())
    okey = torch.where(noise_mask, okey, sentinel).reshape(-1)
    skey, order = torch.sort(okey, stable=True)
    return order[:capacity], skey[:capacity] < sentinel


def merge_blocks(block_labels, block_valid, block_coords, point_index,
                 n_points: int, eps: float, min_pts: int,
                 metric: str = "l1_motor", min_cluster_size: int = 3,
                 quirks: bool = True, noise_capacity: int = 4096,
                 noise_engine: str = "auto", noise_cell_cap: int = 32):
    """Fuse per-block local labels into global cluster ids.

    block_labels [B, cap] i32 local ids, block_valid [B, cap],
    block_coords [B, cap, D], point_index [B, cap] i32 (-1 pad).
    ``noise_engine``: auto | dense | dense_chunked | grid; "auto" takes
    dense up to DENSE_MAX slots, above it the grid engine (cell window
    ``noise_cell_cap``) where the metric has a grid form, else
    dense_chunked -- the JAX package's rule on every host but a TPU.

    Returns dict: label i32[n_points] (0 noise), n_kept, n_total (reference
    dbb.clusterAmount semantics), noise_overflow (noise beyond capacity,
    plus the grid engine's cell overflow). The noise re-cluster records a
    span ``noise``.
    """
    B, cap = block_labels.shape
    counts = _block_label_counts(block_labels, block_valid, cap + 1)
    keep, gid, n_kept = block_keep_renumber(counts, min_cluster_size,
                                            quirks)
    point_gid = apply_block_gid(block_labels, block_valid, keep, gid)

    # noise re-cluster (FrmMain.cs:1507-1520)
    with prof.span("noise"):
        noise_mask = block_valid & (point_gid == 0)
        order, sel_valid = noise_pack_order(block_labels, noise_mask,
                                            noise_capacity)
        coords_flat = block_coords.reshape(B * cap, -1)
        noise_coords = torch.where(sel_valid[:, None], coords_flat[order],
                                   0.0)

        cf_seed = (n_kept - 1) if quirks else n_kept
        gmetric = grid_metric(metric, noise_coords.shape[-1])
        if noise_engine == "auto":
            # the JAX package takes dense_chunked above DENSE_MAX only on a
            # TPU, where the grid's stencil gathers are slow; the grid engine
            # equals it only while its cell overflow is 0
            if noise_capacity <= DENSE_MAX:
                noise_engine = "dense"
            else:
                noise_engine = ("grid" if gmetric is not None
                                else "dense_chunked")
        grid_overflow = 0
        if noise_engine == "grid":
            if gmetric is None:
                raise ValueError(f"metric {metric!r} has no grid form; use "
                                 "noise_engine='dense'")
            re = dbscan_grid(noise_coords, sel_valid, eps, min_pts, gmetric,
                             cf=cf_seed, cell_cap=noise_cell_cap)
            grid_overflow = re["overflow"]
        elif noise_engine == "dense_chunked":
            re = dbscan_dense_chunked(noise_coords, sel_valid, eps, min_pts,
                                      metric, cf=cf_seed)
        elif noise_engine == "dense":
            re = dbscan_padded(noise_coords, sel_valid, eps, min_pts, metric,
                               cf=cf_seed)
        else:
            raise ValueError(f"unknown noise_engine {noise_engine!r}")
    n_total = cf_seed + re["n_clusters"]

    # scatter re-cluster labels back into the block grid, then to the
    # original flat point order (padding slots have point index -1)
    point_gid_flat = point_gid.reshape(-1).clone()
    point_gid_flat[order] = torch.where(sel_valid, re["label"],
                                        point_gid_flat[order])
    pi = point_index.reshape(-1)
    has = pi >= 0
    label = torch.zeros(n_points, dtype=torch.int32,
                        device=block_labels.device)
    label[prof.sync(lambda: pi[has]).long()] = prof.sync(
        lambda: point_gid_flat[has])
    n_noise = noise_mask.sum(dtype=torch.int32)
    return {
        "label": label,
        "n_kept": n_kept,
        "n_total": n_total,
        "noise_overflow": torch.clamp_min(n_noise - noise_capacity, 0)
        + grid_overflow,
    }


def merge_centroid_clusters(centers_xy, center_valid, merge_eps: float,
                            merge_min_pts: int = 2):
    """Centroid-distance cluster fusion mapping (Q7).

    centers_xy [K+1, 2] indexed by cluster id (row 0 unused). DBSCAN over
    the valid centroids with L1 on (X, Y); each group collapses into its
    lowest id, survivors renumber densely by ascending old id. Returns dict:
    remap i32[K+1] (old id -> new id, 0 stays 0), n_after i32[].
    """
    kp1 = centers_xy.shape[0]
    ids = torch.arange(kp1, dtype=torch.int32, device=centers_xy.device)
    valid = center_valid & (ids > 0)
    engine = dbscan_dense_chunked if kp1 > DENSE_MAX else dbscan_padded
    glab = engine(centers_xy, valid, merge_eps, merge_min_pts,
                  "l1_motor")["label"]
    member = valid & (glab > 0)
    group_min = torch.full((kp1,), kp1, dtype=torch.int32,
                           device=ids.device).scatter_reduce(
        0, glab.long(), torch.where(member, ids, kp1), reduce="amin")
    target = torch.where(member, group_min[glab.long()], ids)
    survivor = valid & (target == ids)
    new_id = torch.cumsum(survivor.to(torch.int32), 0, dtype=torch.int32)
    remap = torch.where(valid, new_id[target.long()], 0).to(torch.int32)
    remap[0] = 0
    return {"remap": remap, "n_after": survivor.sum(dtype=torch.int32)}
