"""Halo union-find: cross-block cluster merging (port of
vtkcloudpoint_tpu.cluster.halo_fusion).

1. per block, collect the core points that lie near a point of another
   block into fixed-capacity halo buffers (``halo_buffers``);
2. any two core points of different clusters within eps in the gathered
   set imply that their global ids denote one cluster;
3. a scatter-min union-find over the id table resolves the merges to a
   fixpoint, then ids densify to 1..K' (``union_ids``, or
   ``grid_union_ids`` with grid-hash adjacency).

The boundary test hashes global ``shell_eps`` cells twice (the primes of
cluster/grid.py, int32 wrap done explicitly) into 2^cell_table_bits
scatter-min/max block-id tables; a point is near another block when both
hashes of some stencil cell say so. With ``axis`` (a parallel.mesh.Mesh)
each rank also all_gathers every rank's distinct occupied cells
(``pack_cells``), so the test sees the other ranks' blocks. Plain PyTorch:
the JAX package runs this as XLA, with no Pallas kernel.
"""
from __future__ import annotations

import torch

from ..ops.metrics import pairwise
from .dbscan import _threshold, fixpoint
from .grid import (_PRIMES, _PRIMES2, cell_hash, dbscan_grid, reciprocal,
                   stencil_deltas, wrap32)

_IMAX = 2**31 - 1
PAIR_BUDGET = 1 << 27      # [rows, H] elements per chunk of union_ids


def _safe_id(r):
    """Reserve INT_MAX as the invalid sentinel: a real hash landing there
    becomes INT_MAX - 1 (a collision, false positives only)."""
    return torch.where(r == _IMAX, _IMAX - 1, r)


def pack_cells(raw1, raw2, use, cap: int):
    """Distinct (raw1, raw2) cell-hash pairs of the ``use`` points,
    lexicographic: (cells [cap, 2], sel bool[cap], dropped i32) -- dropped
    counts distinct pairs beyond ``cap``. Fewer than ``cap`` points give
    that many rows, as in JAX."""
    n = raw1.shape[0]
    key = torch.where(use, _safe_id(raw1), _IMAX)
    o2 = torch.sort(raw2, stable=True)[1]
    order0 = o2[torch.sort(key[o2], stable=True)[1]]
    s1, s2 = key[order0], raw2[order0]
    first = torch.cat([s1[:1] < _IMAX,
                       ((s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1]))
                       & (s1[1:] < _IMAX)])
    slot = torch.where(first, torch.arange(n, device=raw1.device), n)
    order = torch.sort(slot, stable=True)[1][:cap]
    sel = slot[order] < n
    cells = torch.stack([torch.where(sel, s1[order], _IMAX),
                         torch.where(sel, s2[order], 0)], dim=-1)
    dropped = first.sum(dtype=torch.int32) - sel.sum(dtype=torch.int32)
    return cells, sel, dropped


def foreign_cell_filter(raw1, raw2, deltas1, deltas2, cells, cells_sel,
                        bits: int):
    """bool[n]: some 3^D stencil cell of each point appears in the foreign
    cell list (two-hash AND lookup; false positives only)."""
    H = 1 << bits
    idx1 = (_safe_id(cells[..., 0]) & (H - 1))[cells_sel].reshape(-1)
    idx2 = (cells[..., 1] & (H - 1))[cells_sel].reshape(-1)
    t1 = torch.zeros(H, dtype=torch.bool, device=raw1.device)
    t2 = torch.zeros_like(t1)
    t1[idx1] = True
    t2[idx2] = True
    near = torch.zeros(raw1.shape, dtype=torch.bool, device=raw1.device)
    for d1, d2 in zip(deltas1, deltas2):
        q1 = _safe_id(wrap32(raw1 + d1)) & (H - 1)
        q2 = (raw2 + d2) & (H - 1)
        near = near | (t1[q1] & t2[q2])
    return near


def cell_hashes(coords, shell_eps: float, primes):
    """(raw hash [...], stencil deltas) of D-dim coords at shell_eps cells,
    with no origin: cells are global. The division by the static shell size
    is XLA's multiply by its reciprocal in the coordinates' precision."""
    cidx = torch.floor(coords * reciprocal(shell_eps, coords.dtype)).long()
    return cell_hash(cidx, primes), stencil_deltas(coords.shape[-1], primes)


def halo_buffers(block_coords, block_valid, block_labels, block_core,
                 eps: float, halo_cap: int, shell_eps: float = None,
                 block_id_offset: int = 0, axis=None,
                 cell_table_bits: int = 24):
    """Pack the core boundary points of [B, cap] blocks into B * halo_cap
    buffers.

    A point is in the halo iff it is a valid core point of a cluster and
    some cell of its 3^D stencil (global ``shell_eps`` cells, default eps)
    holds a point of another block. Returns (hx [B*halo_cap, D], hlab
    i32[...], hvalid bool[...], halo_overflow i32[]): the overflow counts
    halo points beyond halo_cap per block.

    With ``axis`` (this rank's parallel.mesh.Mesh, where JAX names the
    mesh axis inside shard_map) the blocks are this
    rank's, ``block_id_offset`` makes their ids global, and a gathered list
    of every rank's distinct occupied cells flags points near another
    rank's blocks; distinct cells beyond the list's capacity add to the
    overflow (they could hide boundary points).
    """
    if shell_eps is None:
        shell_eps = eps
    B, cap, d = block_coords.shape
    dev = block_coords.device
    halo_cap = min(halo_cap, cap)
    H = 1 << cell_table_bits
    bid = (torch.arange(B, dtype=torch.int32, device=dev)[:, None]
           + block_id_offset)                                    # [B, 1]
    bid_full = bid.expand(B, cap).reshape(-1)
    occupied = block_valid.reshape(-1)

    raw1, deltas1 = cell_hashes(block_coords, shell_eps, _PRIMES)
    raw2, deltas2 = cell_hashes(block_coords, shell_eps, _PRIMES2)

    def block_tables(raw):
        own = (raw & (H - 1)).reshape(-1)
        bmin = torch.full((H,), _IMAX, dtype=torch.int32, device=dev)
        bmax = torch.full((H,), -1, dtype=torch.int32, device=dev)
        bmin.scatter_reduce_(0, own, torch.where(occupied, bid_full, _IMAX),
                             "amin")
        bmax.scatter_reduce_(0, own, torch.where(occupied, bid_full, -1),
                             "amax")
        return bmin, bmax

    bmin1, bmax1 = block_tables(raw1)
    bmin2, bmax2 = block_tables(raw2)
    near_other = torch.zeros((B, cap), dtype=torch.bool, device=dev)
    for d1, d2 in zip(deltas1, deltas2):
        i1 = (raw1 + d1) & (H - 1)
        i2 = (raw2 + d2) & (H - 1)
        hit1 = (bmin1[i1] < bid) | (bmax1[i1] > bid)
        hit2 = (bmin2[i2] < bid) | (bmax2[i2] > bid)
        near_other = near_other | (hit1 & hit2)

    cell_dropped = 0
    if axis is not None:
        cells, sel, cell_dropped = pack_cells(
            raw1.reshape(-1), raw2.reshape(-1), occupied,
            max(4096, B * cap // 4))
        gcells = axis.all_gather(cells)                 # [ndev, cap, 2]
        gsel = axis.all_gather(sel)
        other = torch.arange(axis.size, device=dev) != axis.axis_index()
        near_other = near_other | foreign_cell_filter(
            raw1.reshape(-1), raw2.reshape(-1), deltas1, deltas2,
            gcells.reshape(-1, 2), (gsel & other[:, None]).reshape(-1),
            cell_table_bits).reshape(B, cap)
    is_halo = block_valid & near_other & block_core & (block_labels > 0)

    slot_key = torch.where(is_halo, torch.arange(cap, device=dev), cap)
    order = torch.sort(slot_key, dim=1, stable=True)[1][:, :halo_cap]
    sel = torch.gather(is_halo, 1, order)
    pts = torch.gather(block_coords, 1, order[..., None].expand(-1, -1, d))
    hx = torch.where(sel[..., None], pts, 1e30).reshape(B * halo_cap, d)
    hlab = torch.where(sel, torch.gather(block_labels, 1, order),
                       0).reshape(-1).to(torch.int32)
    overflow = torch.clamp_min(is_halo.sum(dim=1, dtype=torch.int32)
                               - halo_cap, 0).sum(dtype=torch.int32)
    return hx, hlab, sel.reshape(-1), overflow + cell_dropped


def _finish(idm, n_used, max_ids: int):
    """Dense remap of a converged id table: survivors (ids 1..n_used that
    map to themselves) renumber by ascending id."""
    ids = torch.arange(max_ids, device=idm.device)
    used = (ids >= 1) & (ids <= n_used)
    survivor = used & (idm == ids)
    new_id = torch.cumsum(survivor.to(torch.int32), 0, dtype=torch.int32)
    remap = torch.where(used, new_id[idm.long()], 0).to(torch.int32)
    remap[0] = 0
    return remap, survivor.sum(dtype=torch.int32)


def union_ids(hx, hlab, hvalid, n_used, eps: float, metric: str,
              max_ids: int):
    """Scatter-min union-find over the cluster ids that halo adjacency
    implies (core points of different ids within eps, by ``pairwise``).
    The [H, H] adjacency is built and reduced in row chunks. Returns dict:
    remap i32[max_ids], n_after, idmap."""
    hn = hx.shape[0]
    dev = hx.device
    thr = _threshold(eps)
    rows = max(1, PAIR_BUDGET // max(hn, 1))
    chunks = [(s, min(s + rows, hn)) for s in range(0, hn, rows)]
    adj = torch.cat([
        (pairwise(hx[s:e], hx, metric) <= thr) & hvalid[s:e, None]
        & hvalid[None, :] & (hlab[s:e, None] != hlab[None, :])
        for s, e in chunks]) if hn else torch.zeros(
            (0, 0), dtype=torch.bool, device=dev)
    lab_idx = hlab.clamp(0, max_ids - 1).long()

    def body(idm):
        cur = idm[lab_idx]
        nbr_min = torch.cat([
            torch.where(adj[s:e], cur[None, :], max_ids).amin(dim=1)
            for s, e in chunks]) if hn else cur
        new_val = torch.minimum(cur, nbr_min)
        idm_new = idm.scatter_reduce(
            0, lab_idx, torch.where(hvalid, new_val, max_ids), "amin")
        idm_new[0] = 0
        return torch.minimum(idm_new, idm_new[idm_new.long()])

    idm = fixpoint(body, torch.arange(max_ids, dtype=torch.int32,
                                      device=dev), 32)
    remap, n_after = _finish(idm, n_used, max_ids)
    return {"remap": remap, "n_after": n_after, "idmap": idm}


def grid_union_ids(hx, hlab, hvalid, n_used, eps: float, metric: str,
                   max_ids: int, cell_cap: int = 64, idm_init=None,
                   max_rounds: int = 32):
    """union_ids with grid-hash adjacency: eps-connected components of the
    halo points (dbscan_grid at min_pts 1) subsume pairwise adjacency. Per
    round: component -> min current id, id -> min over its points'
    components, path compression. Returns dict: remap, n_after, idmap,
    overflow (grid cell truncation; exact iff 0)."""
    hn = hx.shape[0]
    inf = max_ids
    use = hvalid & (hlab > 0)
    lab_idx = hlab.clamp(0, max_ids - 1).long()
    comp = dbscan_grid(hx, use, eps, 1, metric, cell_cap=cell_cap)
    clab = comp["label"].long()

    def body(idm):
        cur = torch.where(use, idm[lab_idx], inf)
        cmin = torch.full((hn + 1,), inf, dtype=torch.int32,
                          device=hx.device).scatter_reduce(0, clab, cur,
                                                           "amin")
        idm_new = idm.scatter_reduce(
            0, lab_idx, torch.where(use, cmin[clab], inf), "amin")
        idm_new = torch.clamp_max(idm_new, inf - 1)
        idm_new[0] = 0
        return torch.minimum(idm_new, idm_new[idm_new.long()])

    idm0 = (torch.arange(max_ids, dtype=torch.int32, device=hx.device)
            if idm_init is None else idm_init.to(torch.int32))
    idm = fixpoint(body, idm0, max_rounds)
    remap, n_after = _finish(idm, n_used, max_ids)
    return {"remap": remap, "n_after": n_after, "idmap": idm,
            "overflow": comp["overflow"]}


def halo_merge_labels(block_coords, block_valid, block_labels, block_core,
                      n_used, eps: float, metric: str = "l1_motor",
                      halo_cap: int = 64, max_ids: int = 4096):
    """Single-device halo merge over [B, cap] blocks carrying GLOBAL ids.
    Returns dict: remap, n_after, idmap, halo_overflow."""
    hx, hlab, hvalid, overflow = halo_buffers(
        block_coords, block_valid, block_labels, block_core, eps, halo_cap)
    out = union_ids(hx, hlab, hvalid, n_used, eps, metric, max_ids)
    out["halo_overflow"] = overflow
    return out


def apply_halo_merge(labels, remap):
    """Apply the dense remap to a flat or per-block label array."""
    return remap[labels.clamp(0, remap.shape[0] - 1).long()]
