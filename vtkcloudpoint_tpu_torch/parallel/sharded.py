"""Multi-device clustering and registration over torch.distributed (port of
vtkcloudpoint_tpu.parallel.sharded).

JAX's shard_map programs become one process per rank: every entry point
takes this rank's shard (blocks, points) and the replicated arguments, and
returns this rank's shard of the output with the replicated scalars. The
collectives are the mesh's methods (parallel/mesh.py), named after
jax.lax.

- per-block DBSCAN: each rank clusters its own blocks
  (``cluster.dbscan.dbscan_blocks_dispatch``: K1 on the card);
- fusion: the cull rules are per-block-local, so each rank keeps and
  renumbers its own count rows; one all_gather of the per-rank kept counts
  gives the prefix offsets;
- noise re-cluster: each rank packs its noise into a fixed-capacity buffer
  (device-major = block-major order) and either all_gathers them for a
  replicated re-cluster (``dense``, ``dense_chunked``, ``grid``) or runs the
  owner-sharded one (``distributed``, parallel/noise_shard.py);
- halo union: ``gather`` (all_gather + replicated union), ``ring`` (the
  shells circulate the ring, one hop per rank) or ``hier`` (local grid
  components, then the device-boundary skin, exchanged by all_gather or
  routed to cell owners by all_to_all);
- centroid merge: the exact int64 fixed-point centroid sums
  (``ops.segment.fixed_point_sums``) reduce across ranks, so the merge sees the
  single-device centroids bit for bit;
- ICP: source (and for the grid form, target) sharded; one all_reduce of
  the 17 Horn moments per iteration, the 4x4 solve replicated.

Every loop whose trip count gates a collective ends on a flag every rank
reads alike (an all_reduced value, ``Mesh.any``): a rank that left a
fixpoint early would hang the others. Where JAX picks a TPU branch only on
a TPU (``noise_recluster="auto"``, ``nn="auto"``, the hier and skin
engines), the port takes JAX's off-TPU branch on every device.
"""
from __future__ import annotations

import os
import zlib
from itertools import product

import numpy as np
import torch

from ..cluster.dbscan import (_threshold, dbscan_blocks_dispatch,
                              dbscan_dense_chunked, dbscan_padded)
from ..cluster.grid import (_PRIMES, _PRIMES2, cell_hash, dbscan_grid,
                            grid_metric, reciprocal, wrap32)
from ..config import ICPConfig, ParallelConfig
from ..ops import se3
from ..ops.metrics import pairwise
from .mesh import Mesh

_BIG = 1e30
HALO_CHUNK = 2048       # shell rows a ring-union distance tile holds


def _compress(m):
    """Pointer jumping m <- min(m, m[m]) to its fixpoint (chains only
    shorten); a pure function of m."""
    while True:
        m2 = torch.minimum(m, m[m.long()])
        if torch.equal(m2, m):
            return m2
        m = m2


def _apply_constraints(mesh: Mesh, idm, upd, inf: int):
    """One Jacobi round of the id union: pmin the local constraints, apply,
    path-compress. Returns (new table, changed) -- both identical on every
    rank."""
    upd = mesh.pmin(upd)
    new = torch.minimum(idm, torch.clamp_max(upd, inf - 1))
    new[0] = 0
    new = _compress(new)
    return new, mesh.any((new != idm).any())


def _finish(idm, n_used, max_ids: int):
    from ..cluster.halo_fusion import _finish as finish

    remap, n_after = finish(idm, n_used, max_ids)
    return {"remap": remap, "n_after": n_after, "idmap": idm}


def _ring_union(hx, hlab, hval, n_used, eps: float, metric: str,
                max_ids: int, mesh: Mesh, ndev: int, max_rounds: int):
    """Union-find over the cluster ids that cross-shard halo adjacency
    implies, the halo shells circulating the ring.

    Per outer round every other rank's shell visits once (ndev hops, hop 0
    = self-pairs); each visit scatter-mins "least adjacent current id" into
    a local constraint map, which a pmin unifies before one path
    compression. At most ``max_rounds`` rounds. Returns dict remap,
    n_after, idmap (halo_fusion.union_ids' contract)."""
    dev = hx.device
    inf = max_ids
    thr = _threshold(eps)
    idm = torch.arange(max_ids, dtype=torch.int32, device=dev)
    la_idx = hlab.clamp(0, max_ids - 1).long()
    hn = hx.shape[0]
    chunks = [(s, min(s + HALO_CHUNK, hn)) for s in range(0, hn, HALO_CHUNK)]

    def outer(idm):
        la = idm[la_idx]
        upd = torch.full((max_ids,), inf, dtype=torch.int32, device=dev)
        vx, vlab, vval = hx, hlab, hval
        for step in range(ndev):
            lb = idm[vlab.clamp(0, max_ids - 1).long()]
            nbr_min = torch.cat([torch.where(
                (pairwise(hx[s:e], vx, metric) <= thr) & hval[s:e, None]
                & vval[None, :] & (la[s:e, None] != lb[None, :]),
                lb[None, :], inf).amin(dim=1) for s, e in chunks]) \
                if hn else la
            upd.scatter_reduce_(0, la_idx, torch.where(hval, nbr_min, inf),
                                "amin")
            if step < ndev - 1:
                vx = mesh.ppermute_ring(vx)
                vlab = mesh.ppermute_ring(vlab)
                vval = mesh.ppermute_ring(vval)
        return _apply_constraints(mesh, idm, upd, inf)

    idm, changed = outer(idm)
    rounds = 1
    while changed and rounds < max_rounds:
        idm, changed = outer(idm)
        rounds += 1
    return _finish(idm, n_used, max_ids)


def _half_stencil_offsets(ndim: int):
    """Self + lexicographically-positive stencil offsets: for any two cells
    within one step, one holds the other in its half stencil, so routing a
    point to the owners of these (3^D + 1) / 2 cells makes every eps-pair
    meet at one owner or more."""
    offs = [o for o in product((-1, 0, 1), repeat=ndim) if o > (0,) * ndim]
    return [(0,) * ndim] + offs


def _owner_route(bx, blab, sel, eps: float, mesh: Mesh, ndev: int,
                 dest_cap: int):
    """Send each valid skin point to the hash owners of its half-stencil
    cells (owner = Fibonacci-mixed int32 cell hash mod ndev, deduplicated
    per point), one all_to_all of fixed ``dest_cap`` slots per destination.
    Returns (rx [ndev * dest_cap, D], rlab, rok, dropped): received in
    source-rank order; ``dropped`` counts this rank's copies beyond
    dest_cap."""
    S, D = bx.shape
    dev = bx.device
    offs = _half_stencil_offsets(D)
    R = len(offs)
    cidx = torch.floor(bx * reciprocal(eps, bx.dtype)).long()
    raw = cell_hash(cidx, _PRIMES)
    dest = torch.stack([
        (wrap32(wrap32(raw + wrap32(sum(o[ax] * _PRIMES[ax]
                                        for ax in range(D))))
                * -1640531527) >> 8).abs() % ndev      # 0x9E3779B9
        for o in offs], dim=1)                              # [S, R]
    dup = torch.zeros((S, R), dtype=torch.bool, device=dev)
    for j in range(1, R):
        for i in range(j):
            dup[:, j] |= dest[:, j] == dest[:, i]
    ok = sel[:, None] & ~dup
    flat_dest = torch.where(ok, dest, ndev).reshape(-1)
    skey, sidx = torch.sort(flat_dest, stable=True)
    seg_start = torch.searchsorted(skey, torch.arange(ndev, device=dev))
    rank = torch.arange(S * R, device=dev) - seg_start[skey.clamp(0,
                                                                  ndev - 1)]
    valid = (skey < ndev) & (rank < dest_cap)
    slot = (skey * dest_cap + rank)[valid]
    dropped = ((skey < ndev).sum(dtype=torch.int32)
               - valid.sum(dtype=torch.int32))
    src_pt = (sidx // R)[valid]
    buf_x = torch.full((ndev * dest_cap, D), _BIG, dtype=bx.dtype,
                       device=dev)
    buf_x[slot] = bx[src_pt]
    buf_l = torch.zeros(ndev * dest_cap, dtype=blab.dtype, device=dev)
    buf_l[slot] = blab[src_pt]
    buf_ok = torch.zeros(ndev * dest_cap, dtype=torch.bool, device=dev)
    buf_ok[slot] = True
    rx = mesh.all_to_all(buf_x.reshape(ndev, dest_cap, D)).reshape(-1, D)
    rlab = mesh.all_to_all(buf_l.reshape(ndev, dest_cap)).reshape(-1)
    rok = mesh.all_to_all(buf_ok.reshape(ndev, dest_cap)).reshape(-1)
    return rx, rlab, rok, dropped


def _component_rounds(mesh: Mesh, clab, use, la_idx, idm, max_ids: int,
                      max_rounds: int):
    """Jacobi rounds over the replicated id table given fixed eps-connected
    components ``clab`` of a point set: component -> least current id,
    id -> least over its points' components, pmin, path compression.
    Returns (table, still changing after max_rounds)."""
    inf = max_ids
    hn = clab.shape[0]
    dev = clab.device

    def round_fn(idm):
        cur = torch.where(use, idm[la_idx], inf)
        cmin = torch.full((hn + 1,), inf, dtype=torch.int32,
                          device=dev).scatter_reduce(0, clab, cur, "amin")
        upd = torch.full((max_ids,), inf, dtype=torch.int32,
                         device=dev).scatter_reduce(
            0, la_idx, torch.where(use, cmin[clab], inf), "amin")
        return _apply_constraints(mesh, idm, upd, inf)

    idm, changed = round_fn(idm)
    it = 1
    while changed and it < max_rounds:
        idm, changed = round_fn(idm)
        it += 1
    return idm, changed


def _skin_union_a2a(bx, blab, sel, n_used, eps: float, metric: str,
                    max_ids: int, mesh: Mesh, ndev: int, max_rounds: int,
                    dest_cap: int, cell_cap: int, idm_init):
    """Owner-routed skin union: each owner takes the eps-connected
    components of the points routed to it once (grid engine, min_pts 1),
    then Jacobi rounds over the replicated id table reach the transitive
    least-id closure that grid_union_ids computes over the gathered skins.
    Returns (dict remap/n_after/idmap, overflow): routing drops, grid cell
    truncation and non-convergence at max_rounds, psum'd."""
    rx, rlab, rok, route_drop = _owner_route(bx, blab, sel, eps, mesh, ndev,
                                             dest_cap)
    # the grid's cost follows its rows, and most of the ndev * dest_cap
    # slots are empty: only the routed points enter (the same components,
    # the same cell ranks, so the same overflow)
    keep = (rok & (rlab > 0)).nonzero()[:, 0]
    use = torch.ones(keep.shape[0], dtype=torch.bool, device=rx.device)
    if keep.numel():
        comp = dbscan_grid(rx[keep], use, eps, 1, metric, cell_cap=cell_cap)
        clab, grid_ovf = comp["label"].long(), comp["overflow"]
    else:
        clab, grid_ovf = keep, 0
    idm, still = _component_rounds(
        mesh, clab, use, rlab[keep].clamp(0, max_ids - 1).long(), idm_init,
        max_ids, max_rounds)
    ovf = mesh.psum(route_drop + grid_ovf + int(still))
    return _finish(idm, n_used, max_ids), ovf


def _hier_union(hx, hlab, hval, n_used, eps: float, metric: str,
                max_ids: int, mesh: Mesh, ndev: int, max_rounds: int,
                dev_halo_cap: int, cell_cap: int, cell_table_bits: int = 24,
                skin_exchange: str = "owner", skin_dest_cap: int = None):
    """Two-level halo union: rank-local grid components of the shell (every
    halo point is core, so two within eps are one cluster), then a union
    over only the rank-boundary skin -- halo points whose stencil meets a
    cell in another rank's gathered distinct-cell list -- exchanged by
    owner-routed all_to_all (``skin_exchange="owner"``) or all_gather.

    Exact iff nothing overflows: returns (union dict, overflow) where the
    overflow counts grid cell truncation, skin points beyond
    ``dev_halo_cap``, dropped distinct cells and the stage-3 counters."""
    from ..cluster.halo_fusion import (cell_hashes, foreign_cell_filter,
                                       grid_union_ids, pack_cells)

    dev = hx.device
    hn = hx.shape[0]
    la_idx = hlab.clamp(0, max_ids - 1).long()
    use = hval & (hlab > 0)

    # ---- stage 1: local components of the rank's shell ----
    comp = dbscan_grid(hx, use, eps, 1, metric, cell_cap=cell_cap)
    grid_ovf = mesh.psum(comp["overflow"])
    idm, _ = _component_rounds(
        mesh, comp["label"].long(), use, la_idx,
        torch.arange(max_ids, dtype=torch.int32, device=dev), max_ids,
        max_rounds)

    # ---- stage 2: reduce to the rank-boundary skin ----
    raw1, deltas1 = cell_hashes(hx, eps, _PRIMES)
    raw2, deltas2 = cell_hashes(hx, eps, _PRIMES2)
    cells, cells_sel, cell_dropped = pack_cells(raw1, raw2, use,
                                                max(4096, hn // 4))
    gcells = mesh.all_gather(cells)
    gcsel = mesh.all_gather(cells_sel)
    other = torch.arange(ndev, device=dev) != mesh.axis_index()
    near = use & foreign_cell_filter(
        raw1, raw2, deltas1, deltas2, gcells.reshape(-1, 2),
        (gcsel & other[:, None]).reshape(-1), cell_table_bits)
    slot = torch.where(near, torch.arange(hn, device=dev), hn)
    order = torch.sort(slot, stable=True)[1][:dev_halo_cap]
    sel = slot[order] < hn
    bx = torch.where(sel[:, None], hx[order], _BIG)
    blab = torch.where(sel, idm[la_idx[order]], 0)
    dev_ovf = mesh.psum(near.sum(dtype=torch.int32)
                        - sel.sum(dtype=torch.int32) + cell_dropped)

    # ---- stage 3: cross-rank union over the skins ----
    if skin_exchange == "owner":
        if skin_dest_cap is None:
            # 2x headroom over a perfectly balanced owner load, at least 64
            R = (3 ** hx.shape[1] + 1) // 2
            per = -(-2 * R * dev_halo_cap // max(ndev, 1))
            skin_dest_cap = max(64, (per + 7) // 8 * 8)
        uni, a2a_ovf = _skin_union_a2a(
            bx, blab, sel, n_used, eps, metric, max_ids, mesh, ndev,
            max_rounds, skin_dest_cap, cell_cap, idm_init=idm)
        return uni, grid_ovf + dev_ovf + a2a_ovf
    d = hx.shape[1]
    uni = grid_union_ids(mesh.all_gather(bx).reshape(-1, d),
                         mesh.all_gather(blab).reshape(-1),
                         mesh.all_gather(sel).reshape(-1), n_used, eps,
                         metric, max_ids, cell_cap=cell_cap, idm_init=idm,
                         max_rounds=max_rounds)
    return uni, grid_ovf + dev_ovf + uni["overflow"]


def sharded_blocked_dbscan(
    mesh: Mesh,
    block_coords,
    block_valid,
    eps: float,
    min_pts: int,
    metric: str = "l1_motor",
    min_cluster_size: int = 3,
    quirks: bool = True,
    noise_capacity_per_device: int = 1024,
    halo_merge: bool = False,
    halo_cap: int = 64,
    max_ids: int = 4096,
    axis: str = "blocks",
    backend: str = "auto",
    noise_recluster: str = "auto",   # "grid" | "dense" | "dense_chunked"
                                     # | "distributed" | "auto"
    noise_cell_cap: int = 32,
    noise_skin_cap: int = 1024,      # "distributed": boundary-noise buffer
    noise_root_cap: int = 4096,      # "distributed": per-rank root list
    noise_local_engine: str = "auto",  # "distributed": grid | dense | auto
    centroid_merge: bool = False,    # C11 at scale: merge by centroid dist
    merge_eps: float = 0.0,
    merge_min_pts: int = 2,
    halo_mode: str = "ring",         # "ring" | "gather" | "hier"
    dev_halo_cap: int = 512,         # "hier": rank-boundary skin capacity
    halo_cell_cap: int = 64,         # "hier": grid cells in the local stage
    skin_exchange: str = "owner",    # "hier" stage 3: "owner" | "gather"
    skin_dest_cap: int = None,       # "owner": per-destination slot cap
    fixpoint_max_rounds: int = None,  # None -> ParallelConfig default
    halo_width_eps: float = None,     # shell width multiple of eps
    dbscan_chunk: int = 64,          # blocks in flight (plain path)
    cell_table_bits: int = 24,       # halo/skin occupancy-table size (2^bits)
    split_programs: bool = False,    # DBSCAN and fusion as two steps
    checkpoint_dir: str = None,      # split_programs: persist step-1 output
):
    """Distributed blocked DBSCAN + fusion, this rank's part.

    block_coords [B/n, cap, D], block_valid [B/n, cap]: this rank's blocks
    of the global [B, cap] layout (rank r holds rows r*B/n .. ). Returns
    dict(label i32[B/n, cap] global ids of this rank's blocks, and the
    replicated n_total, noise_overflow, halo_overflow i32[]) -- each
    overflow counter reports points the fixed capacities dropped.
    ``axis`` names the mesh's one axis, as in JAX (``mesh.shape[axis]`` is
    the world size).

    ``split_programs`` runs the collective-free per-rank DBSCAN and then
    the fusion; in torch both modes are these two calls. With
    ``checkpoint_dir`` each rank saves its label/core rows after the DBSCAN
    (``p{rank}/``, the JAX module's file layout) and a rerun with the same
    configuration resumes straight into the fusion.
    """
    bloc, cap, D = block_coords.shape
    ndev = mesh.shape[axis]
    B = bloc * ndev
    kmax = cap + 1
    pc = ParallelConfig()
    if fixpoint_max_rounds is None:
        fixpoint_max_rounds = pc.fixpoint_max_rounds
    if halo_width_eps is None:
        halo_width_eps = pc.halo_width_eps
    gmetric = grid_metric(metric, D)
    if noise_recluster == "auto":
        # JAX's off-TPU rule (its dense_chunked branch is TPU-only)
        if ndev * noise_capacity_per_device <= 8192:
            noise_recluster = "dense"
        elif gmetric is not None:
            noise_recluster = "grid"
        else:
            noise_recluster = "dense"
    if noise_recluster in ("grid", "distributed") and gmetric is None:
        raise ValueError(
            f"metric {metric!r} has no grid form; use noise_recluster='dense'")
    if halo_mode == "hier" and gmetric is None:
        raise ValueError(
            f"metric {metric!r} has no grid form; use halo_mode='ring'")

    def local_dbscan():
        db = dbscan_blocks_dispatch(block_coords, block_valid, eps, min_pts,
                                    metric, chunk=dbscan_chunk,
                                    backend=backend)
        return db["label"], db["core"]

    if split_programs and checkpoint_dir is not None:
        labels, core = _checkpointed_dbscan(
            mesh, local_dbscan, checkpoint_dir,
            dict(B=B, cap=cap, eps=float(eps), min_pts=int(min_pts),
                 metric=metric, backend=backend, nproc=ndev), bloc, cap)
    else:
        labels, core = local_dbscan()
    return _fusion(
        mesh, block_coords, block_valid, labels, core, eps=eps,
        min_pts=min_pts, metric=metric, gmetric=gmetric, B=B, kmax=kmax,
        min_cluster_size=min_cluster_size, quirks=quirks,
        noise_capacity_per_device=noise_capacity_per_device,
        noise_recluster=noise_recluster, noise_cell_cap=noise_cell_cap,
        noise_skin_cap=noise_skin_cap, noise_root_cap=noise_root_cap,
        noise_local_engine=noise_local_engine, halo_merge=halo_merge,
        halo_cap=halo_cap, max_ids=max_ids, halo_mode=halo_mode,
        dev_halo_cap=dev_halo_cap, halo_cell_cap=halo_cell_cap,
        skin_exchange=skin_exchange, skin_dest_cap=skin_dest_cap,
        fixpoint_max_rounds=fixpoint_max_rounds,
        halo_width_eps=halo_width_eps, cell_table_bits=cell_table_bits,
        centroid_merge=centroid_merge, merge_eps=merge_eps,
        merge_min_pts=merge_min_pts)


def _checkpointed_dbscan(mesh: Mesh, local_dbscan, checkpoint_dir: str,
                         fp: dict, bloc: int, cap: int):
    """The per-rank DBSCAN, resumed from ``checkpoint_dir/p{rank}`` when a
    checkpoint of the same configuration (a stable CRC of ``fp``) is there,
    else computed and saved. Every rank must agree on resuming: a rank that
    computes while another resumes is still correct (no collective runs
    here), so each decides alone."""
    from ..utils.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(checkpoint_dir,
                                         f"p{mesh.axis_index()}"), keep=1)
    like = {"label": np.zeros((bloc, cap), np.int32),
            "core": np.zeros((bloc, cap), bool),
            "fp": np.zeros(1, np.int64)}
    # python hash() is seed-randomised across runs: a CRC of the sorted
    # configuration is stable, so a rerun finds its checkpoint
    fpv = np.asarray([zlib.crc32(repr(sorted(fp.items())).encode())],
                     np.int64)
    try:
        tree, _ = mgr.restore_latest(like)
    except Exception:
        tree = None
    if (tree is not None and tuple(tree["label"].shape) == (bloc, cap)
            and tuple(tree["fp"].shape) == fpv.shape
            and bool((np.asarray(tree["fp"]) == fpv).all())):
        return (torch.as_tensor(np.asarray(tree["label"]),
                                device=mesh.device),
                torch.as_tensor(np.asarray(tree["core"]),
                                device=mesh.device))
    labels, core = local_dbscan()
    mgr.save(0, {"label": labels.cpu().numpy(), "core": core.cpu().numpy(),
                 "fp": fpv})
    return labels, core


def _fusion(mesh: Mesh, coords_loc, valid_loc, labels_loc, core_loc, *,
            eps, min_pts, metric, gmetric, B, kmax, min_cluster_size,
            quirks, noise_capacity_per_device, noise_recluster,
            noise_cell_cap, noise_skin_cap, noise_root_cap,
            noise_local_engine, halo_merge, halo_cap, max_ids, halo_mode,
            dev_halo_cap, halo_cell_cap, skin_exchange, skin_dest_cap,
            fixpoint_max_rounds, halo_width_eps, cell_table_bits,
            centroid_merge, merge_eps, merge_min_pts):
    """The fusion of sharded_blocked_dbscan on this rank's blocks."""
    from ..cluster.fusion import (_block_label_counts, apply_block_gid,
                                  block_keep_rules, noise_pack_order)

    ndev = mesh.size
    rank = mesh.axis_index()
    dev = coords_loc.device
    bloc, cap, D = coords_loc.shape
    counts_loc = _block_label_counts(labels_loc, valid_loc, kmax)

    # per-block-local cull rules; the global renumber is a prefix sum in
    # device-major block order: only the per-rank kept counts cross
    keep_loc = block_keep_rules(counts_loc, min_cluster_size, quirks)
    gid_cum = torch.cumsum(keep_loc.reshape(-1).to(torch.int32), 0,
                           dtype=torch.int32).reshape(bloc, kmax - 1)
    kept_all = mesh.all_gather(gid_cum.reshape(-1)[-1])      # [ndev] i32
    offset = kept_all[:rank].sum(dtype=torch.int32)
    n_kept = kept_all.sum(dtype=torch.int32)
    point_gid = apply_block_gid(labels_loc, valid_loc, keep_loc,
                                gid_cum + offset)

    # ---- noise re-cluster across shards ----
    noise_mask = valid_loc & (point_gid == 0)
    order, sel_valid = noise_pack_order(labels_loc, noise_mask,
                                        noise_capacity_per_device)
    n_noise = noise_mask.sum(dtype=torch.int32)
    noise_ovf = mesh.psum(n_noise - sel_valid.sum(dtype=torch.int32))
    cflat = coords_loc.reshape(bloc * cap, D)
    my_noise = torch.where(sel_valid[:, None], cflat[order], 0.0)
    cf_seed = (n_kept - 1) if quirks else n_kept
    if noise_recluster == "distributed":
        from .noise_shard import sharded_noise_recluster

        my_re, n_new, novf2 = sharded_noise_recluster(
            my_noise, sel_valid, eps, min_pts, gmetric, cf_seed, mesh,
            ndev, skin_cap=noise_skin_cap, root_cap=noise_root_cap,
            cell_cap=noise_cell_cap, max_rounds=fixpoint_max_rounds,
            cell_table_bits=cell_table_bits, local_engine=noise_local_engine)
        noise_ovf = noise_ovf + novf2
        n_total = cf_seed + n_new
    else:
        all_noise = mesh.all_gather(my_noise).reshape(-1, D)
        all_sel = mesh.all_gather(sel_valid).reshape(-1)
        if noise_recluster == "grid":
            re = dbscan_grid(all_noise, all_sel, eps, min_pts, gmetric,
                             cf=cf_seed, cell_cap=noise_cell_cap)
            noise_ovf = noise_ovf + re["overflow"]
        elif noise_recluster == "dense_chunked":
            re = dbscan_dense_chunked(all_noise, all_sel, eps, min_pts,
                                      metric, cf=cf_seed)
        elif noise_recluster == "dense":
            re = dbscan_padded(all_noise, all_sel, eps, min_pts, metric,
                               cf=cf_seed)
        else:
            raise ValueError(f"unknown noise_recluster {noise_recluster!r}")
        n_total = cf_seed + re["n_clusters"]
        my_re = re["label"].reshape(ndev, -1)[rank]

    flat_gid = point_gid.reshape(-1).clone()
    flat_gid[order] = torch.where(sel_valid, my_re.to(flat_gid.dtype),
                                  flat_gid[order])
    out_labels = flat_gid.reshape(bloc, cap).to(torch.int32)

    halo_ovf = torch.zeros((), dtype=torch.int32, device=dev)
    if halo_merge:
        from ..cluster.halo_fusion import (apply_halo_merge, grid_union_ids,
                                           halo_buffers, union_ids)

        hx, hlab, hval, hov = halo_buffers(
            coords_loc, valid_loc, out_labels, core_loc, eps, halo_cap,
            shell_eps=eps * halo_width_eps, block_id_offset=rank * bloc,
            axis=mesh, cell_table_bits=cell_table_bits)
        halo_ovf = mesh.psum(hov)
        if halo_mode == "gather":
            hx = mesh.all_gather(hx).reshape(-1, D)
            hlab = mesh.all_gather(hlab).reshape(-1)
            hval = mesh.all_gather(hval).reshape(-1)
            if gmetric is not None:
                uni = grid_union_ids(hx, hlab, hval, n_total, eps, gmetric,
                                     max_ids, cell_cap=halo_cell_cap,
                                     max_rounds=fixpoint_max_rounds)
                halo_ovf = halo_ovf + uni["overflow"]
            else:
                uni = union_ids(hx, hlab, hval, n_total, eps, metric,
                                max_ids)
        elif halo_mode == "hier":
            uni, hovf2 = _hier_union(
                hx, hlab, hval, n_total, eps, gmetric, max_ids, mesh, ndev,
                fixpoint_max_rounds, dev_halo_cap, halo_cell_cap,
                cell_table_bits=cell_table_bits, skin_exchange=skin_exchange,
                skin_dest_cap=skin_dest_cap)
            halo_ovf = halo_ovf + hovf2
        elif halo_mode == "ring":
            uni = _ring_union(hx, hlab, hval, n_total, eps, metric, max_ids,
                              mesh, ndev, fixpoint_max_rounds)
        else:
            raise ValueError(f"unknown halo_mode {halo_mode!r}")
        out_labels = apply_halo_merge(out_labels, uni["remap"])
        n_total = uni["n_after"]

    if centroid_merge:
        # C11 at scale: the per-id centroid sums are exact int64 fixed-point
        # sums reduced across ranks (the single-device centroids bit for
        # bit), then the reference's centroid DBSCAN runs replicated on the
        # first two metric coordinates
        from ..cluster.fusion import merge_centroid_clusters
        from ..ops.segment import (column_max, fixed_point_sums,
                                   from_fixed_point, masked_rows)

        w = ((out_labels > 0) & valid_loc).reshape(-1)
        lab = out_labels.reshape(-1).long()
        cf2 = coords_loc.reshape(-1, D)
        moments = torch.cat([torch.where(w[:, None], cf2[:, :2], 0.0),
                             w[:, None].to(cf2.dtype)], dim=1)
        ok = w & (lab < max_ids)
        seg = torch.where(ok, lab, 0)
        v = masked_rows(moments, ok)
        amax = column_max(v)
        if mesh.any(~torch.isfinite(amax).all()):
            # a NaN or inf sums in float64, as ops.segment does
            sums = torch.zeros((max_ids + 1, 3), dtype=torch.float64,
                               device=dev).index_add_(0, torch.where(
                                   ok, seg, max_ids), v)[:max_ids]
            sums = mesh.psum(sums)
        else:
            # the scale of every rank's rows together, so the int64 sums
            # add exactly across ranks
            q, k = fixed_point_sums(v, ok, seg, max_ids, mesh.pmax(amax),
                                    v.shape[0] * mesh.size)
            sums = from_fixed_point(mesh.psum(q), k)
        sums = sums.to(cf2.dtype)
        cnt = sums[:, 2]
        cen = sums[:, :2] / torch.clamp_min(cnt, 1.0)[:, None]
        mg = merge_centroid_clusters(cen, cnt > 0, merge_eps, merge_min_pts)
        out_labels = mg["remap"][out_labels.clamp(0, max_ids - 1).long()]
        n_total = mg["n_after"]

    def scalar(x):
        return torch.as_tensor(x, device=dev).to(torch.int32).reshape(())

    return {"label": out_labels.to(torch.int32), "n_total": scalar(n_total),
            "noise_overflow": scalar(noise_ovf),
            "halo_overflow": scalar(halo_ovf)}


def _moments(p, y, w, d2):
    """The 17 Horn moments [sw, sp(3), sy(3), spy(9), sd] of weighted
    pairs; d2 sums where w > 0."""
    pw = p * w[:, None]
    return torch.cat([w.sum()[None], pw.sum(dim=0), (y * w[:, None]).sum(
        dim=0), (pw.T @ y).reshape(-1), torch.where(w > 0, d2, 0.0).sum()[
        None]])


def _solve_moments(tot):
    return se3.horn_from_moments(tot[0], tot[1:4], tot[4:7],
                                 tot[7:16].reshape(3, 3))


def sharded_icp_grid(mesh: Mesh, source, source_valid, target, target_valid,
                     cfg: ICPConfig = ICPConfig(), cell_size: float = 1.0,
                     cell_cap: int = 16, fallback_cap: int = 1024,
                     chunk: int = 4096, axis: str = "blocks",
                     nn: str = "auto", backend: str = "auto"):
    """Distributed large-target ICP, this rank's part: source AND target
    are this rank's shards. Each rank builds one locator over its target
    shard (``nn="grid"``: register.nn_grid; ``"brute"``: K3 by direct
    differences on the card). Per iteration the moved sources circulate the
    ring for ndev hops, each hop folding the visiting queries' nearest
    local target into a running (d2, y), and are home again with the
    global nearest neighbour; one all_reduce of the Horn moments solves.
    "auto" takes "grid", JAX's off-TPU choice.

    Queries not provably resolved on some shard drop out of that
    iteration's solve and count in the overflow (summed over iterations
    and ranks). Returns (r, t, error, iterations, overflow), replicated.
    ``axis`` names the mesh's one axis, as in JAX (``mesh.shape[axis]`` is
    the world size).
    """
    from ..register.icp import nn_correspond
    from ..register.nn_grid import build_nn_grid, nn_grid

    ndev = mesh.shape[axis]
    if nn == "auto":
        nn = "grid"
    if nn not in ("grid", "brute"):
        raise ValueError(f"unknown nn {nn!r}")
    dtype, dev = source.dtype, source.device
    nloc = source.shape[0]
    grid = None if nn == "brute" else build_nn_grid(target, target_valid,
                                                   cell_size)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def global_nn(p):
        vq = p
        vd2 = torch.full((nloc,), torch.inf, dtype=dtype, device=dev)
        vy = torch.zeros((nloc, 3), dtype=dtype, device=dev)
        vok = torch.ones(nloc, dtype=torch.bool, device=dev)
        ovf = zero
        for _ in range(ndev):
            if nn == "brute":
                idx, d2 = nn_correspond(vq, target, target_valid,
                                        min(chunk, nloc), backend)
                resolved, o = torch.ones_like(vok), zero
            else:
                idx, d2, resolved, o = nn_grid(
                    grid, vq, target, target_valid, cell_size,
                    cell_cap=cell_cap, fallback_cap=fallback_cap,
                    chunk=chunk, backend=backend)
            better = d2 < vd2
            vd2 = torch.where(better, d2, vd2)
            vy = torch.where(better[:, None], target[idx.long()], vy)
            vok = vok & resolved
            ovf = ovf + o
            # the last hop brings every buffer home
            vq, vd2, vy, vok = (mesh.ppermute_ring(v)
                                for v in (vq, vd2, vy, vok))
        return vy, vd2, vok, ovf

    r = torch.eye(3, dtype=dtype, device=dev)
    if cfg.start_by_matching_centroids:
        sv = source_valid.to(dtype)
        tv = target_valid.to(dtype)
        s = mesh.psum(torch.cat([sv.sum()[None], (source * sv[:, None]).sum(
            dim=0), tv.sum()[None], (target * tv[:, None]).sum(dim=0)]))
        t = s[5:8] / torch.clamp_min(s[4], 1.0) - s[1:4] / torch.clamp_min(
            s[0], 1.0)
    else:
        t = torch.zeros(3, dtype=dtype, device=dev)
    d = prev_d = torch.tensor(torch.inf, dtype=dtype, device=dev)
    ovf = zero
    it = 0
    converged = False
    while not converged and it < cfg.max_iterations:
        p = se3.apply_rigid(r, t, source)
        y, d2, ok, o = global_nn(p)
        w = (source_valid & ok & torch.isfinite(d2)).to(dtype)
        tot = mesh.psum(_moments(p, y, w, d2))
        d = tot[16]
        r1, t1 = _solve_moments(tot)
        r, t = se3.compose(r1, t1, r, t)
        ovf = ovf + mesh.psum(o)
        converged = bool(torch.abs(d - prev_d) < cfg.tol)
        prev_d = d
        it += 1
    return r, t, d, torch.tensor(it, dtype=torch.int32), ovf


def sharded_icp(mesh: Mesh, source, source_valid, target, target_valid,
                cfg: ICPConfig = ICPConfig(), axis: str = "blocks",
                backend: str = "auto"):
    """Distributed ICP, this rank's part: source is this rank's shard, the
    target replicated. Per iteration: the local nearest neighbours
    (register.icp.nn_correspond: K3 on the card, direct differences),
    one all_reduce of the 17 Horn moments, the replicated moment-form Horn
    solve (ops.se3.horn_from_moments). The convergence flag is a function
    of the all_reduced error, so every rank stops together.
    ``axis`` is JAX's name of the mesh axis, kept
    for its signature and not read: the mesh has one axis.

    Returns (R, t, error, iterations), replicated.
    """
    from ..register.icp import nn_correspond

    dtype, dev = source.dtype, source.device
    w_loc = source_valid.to(dtype)
    r = torch.eye(3, dtype=dtype, device=dev)
    if cfg.start_by_matching_centroids:
        s = mesh.psum(torch.cat([w_loc.sum()[None],
                                 (source * w_loc[:, None]).sum(dim=0)]))
        wt = target_valid.to(dtype)
        t = (target * wt[:, None]).sum(dim=0) / torch.clamp_min(
            wt.sum(), 1.0) - s[1:] / torch.clamp_min(s[0], 1.0)
    else:
        t = torch.zeros(3, dtype=dtype, device=dev)
    d = prev_d = torch.tensor(torch.inf, dtype=dtype, device=dev)
    it = 0
    converged = False
    while not converged and it < cfg.max_iterations:
        p = se3.apply_rigid(r, t, source)
        idx, d2 = nn_correspond(p, target, target_valid, backend=backend)
        tot = mesh.psum(_moments(p, target[idx.long()], w_loc,
                                 torch.where(source_valid, d2, 0.0)))
        d = tot[16]
        r1, t1 = _solve_moments(tot)
        r, t = se3.compose(r1, t1, r, t)
        converged = bool(torch.abs(d - prev_d) < cfg.tol)
        prev_d = d
        it += 1
    return r, t, d, torch.tensor(it, dtype=torch.int32)
