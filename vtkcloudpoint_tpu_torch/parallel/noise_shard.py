"""Owner-sharded cross-boundary noise re-cluster (port of
vtkcloudpoint_tpu.parallel.noise_shard).

The replicated re-cluster (parallel.sharded noise_recluster="grid" /
"dense") all_gathers every rank's noise and clusters the world on every
rank. Here each rank keeps its own noise and only the skin crosses -- the
noise points whose eps-cell stencil touches another rank's occupied cells
(the distinct-cell lists and two-hash filter of cluster.halo_fusion):

1. exchange distinct occupied eps-cell hash pairs;
2. mark own skin points, all_gather their coordinates and gids;
3. every rank counts neighbours over [own noise + foreign skins] (exact for
   own points: every eps-neighbour is own or a gathered skin); the skins'
   core flags come from their owners;
4. components: least-global-gid label fixpoint, local sweeps, then one
   skin-label all_gather per outer round until no rank's skin labels move
   (an all_reduced flag, so every rank runs the same rounds);
5. ids: every rank publishes its root gids; an id is cf + the root's rank
   in the merged sorted list, which equals the replicated dbscan_grid's
   scan-order numbering because gids are device-major pack order. Border
   points take the largest adjacent core id.

Exact iff the returned overflow is 0 (dropped cells, skin and root
capacity drops, grid cell truncation, non-convergence; summed over ranks):
then the labels equal the replicated dbscan_grid over the gathered noise.
The local engine is the grid (stencil candidates) or the dense distance
tiles; "auto" takes the grid, JAX's off-TPU choice. Plain PyTorch: the JAX
package runs this as XLA, with no Pallas kernel.
"""
from __future__ import annotations

from itertools import product

import torch

from ..cluster.dbscan import _threshold
from ..cluster.grid import (_MASK, _PRIMES, _PRIMES2, _pair_dist, cell_hash,
                            reciprocal, stencil_deltas)
from ..cluster.halo_fusion import cell_hashes, foreign_cell_filter, pack_cells

_INF = 2**31 - 1


def _grid_sorted(coords, valid, eps: float, cell_cap: int, metric: str):
    """Sorted-cell candidate structure over a padded set (dbscan_grid's
    machinery, for queries with outside per-point values). Returns (order,
    cand_fn, overflow): cand_fn(s, e) gives the candidates of sorted rows
    s:e (sorted indices [c, 3^D * cell_cap]) and which lie within eps."""
    n, ndim = coords.shape
    dev = coords.device
    self_idx = list(product((-1, 0, 1), repeat=ndim)).index((0,) * ndim)
    lo = torch.where(valid[:, None], coords, 1e30).amin(dim=0)
    raw = cell_hash(torch.floor((coords - lo) * reciprocal(
        eps, coords.dtype)).long(), _PRIMES)
    cell = torch.where(valid, raw & _MASK, _INF)
    sc, order = torch.sort(cell, stable=True)
    pts_s = [coords[order, k].contiguous() for k in range(ndim)]
    valid_s = valid[order]
    nbr = torch.stack([(raw + d) & _MASK
                       for d in stencil_deltas(ndim, _PRIMES)], dim=1)[order]
    starts = torch.searchsorted(sc, nbr.contiguous())
    k_idx = torch.arange(cell_cap, device=dev)
    thr = _threshold(eps)

    def cand_fn(s, e):
        raw_c = starts[s:e, :, None] + k_idx
        in_range = raw_c < n
        cand = raw_c.clamp_max(n - 1)
        ok = (sc[cand] == nbr[s:e, :, None]) & valid_s[cand] & in_range
        cand = cand.reshape(e - s, -1)
        q = torch.stack([p[s:e] for p in pts_s], dim=1)
        d = _pair_dist(q, [p[cand] for p in pts_s], metric)
        return cand, ok.reshape(e - s, -1) & (d <= thr)

    rank = torch.arange(n, device=dev) - starts[:, self_idx]
    overflow = ((rank >= cell_cap) & valid_s).sum(dtype=torch.int32)
    return order, cand_fn, overflow


def _dense_candidates(a_x, a_ok, eps: float, metric: str):
    """The grid machinery's drop-in with every row a candidate: adjacency
    from [chunk, na] distance tiles, rows in their own order."""
    na, ndim = a_x.shape
    cols = [a_x[:, k][None, :] for k in range(ndim)]
    cand_row = torch.arange(na, device=a_x.device)
    thr = _threshold(eps)

    def cand_fn(s, e):
        d = _pair_dist(a_x[s:e], cols, metric)
        hit = (d <= thr) & a_ok[s:e, None] & a_ok[None, :]
        return cand_row[None, :].expand(e - s, na), hit

    return cand_row, cand_fn, torch.zeros((), dtype=torch.int32,
                                          device=a_x.device)


def sharded_noise_recluster(coords, sel, eps: float, min_pts: int,
                            metric: str, cf, axis, ndev: int,
                            skin_cap: int = 1024, root_cap: int = 4096,
                            cell_cap: int = 32, max_rounds: int = 16,
                            cell_table_bits: int = 24, chunk: int = 8192,
                            local_engine: str = "auto"):
    """Owner-sharded noise re-cluster, this rank's part.

    coords [capd, D]: this rank's packed noise; sel bool[capd]: valid
    rows; cf: the replicated id seed; ``axis``: the mesh
    (parallel.mesh.Mesh). Returns (label i32[capd] -- global ids cf+1..,
    0 noise --, n_clusters i32[] over all ranks, overflow i32[] summed over
    ranks).
    """
    mesh = axis
    capd, D = coords.shape
    dev = coords.device
    rank = mesh.axis_index()
    gid0 = rank * capd + torch.arange(capd, device=dev)

    # ---- step 1: distinct-cell exchange + skin detection ----
    raw1, d1 = cell_hashes(coords, eps, _PRIMES)
    raw2, d2 = cell_hashes(coords, eps, _PRIMES2)
    cells, csel, cdrop = pack_cells(raw1, raw2, sel, max(1024, capd // 2))
    gcells = mesh.all_gather(cells)
    gcsel = mesh.all_gather(csel)
    other = torch.arange(ndev, device=dev) != rank
    skin = sel & foreign_cell_filter(
        raw1, raw2, d1, d2, gcells.reshape(-1, 2),
        (gcsel & other[:, None]).reshape(-1), cell_table_bits)

    # ---- step 2: skin exchange (coords + gids) ----
    slot = torch.where(skin, torch.arange(capd, device=dev), capd)
    sorder = torch.sort(slot, stable=True)[1][:skin_cap]
    s_ok = slot[sorder] < capd
    s_x = torch.where(s_ok[:, None], coords[sorder], 1e30)
    s_g = torch.where(s_ok, gid0[sorder], _INF)
    skin_drop = skin.sum(dtype=torch.int32) - s_ok.sum(dtype=torch.int32)
    g_sx = mesh.all_gather(s_x)                   # [ndev, skin_cap, D]
    g_sg = mesh.all_gather(s_g)
    g_sok = mesh.all_gather(s_ok)
    not_own = other[:, None]
    a_x = torch.cat([coords, g_sx.reshape(-1, D)])
    a_ok = torch.cat([sel, (g_sok & not_own).reshape(-1)])
    na = a_x.shape[0]

    if local_engine == "auto":
        local_engine = "grid"
    if local_engine == "dense":
        order, cand_fn, grid_ovf = _dense_candidates(a_x, a_ok, eps, metric)
        chunk = min(chunk, 2048)   # bound the [chunk, na] distance tile
    elif local_engine == "grid":
        order, cand_fn, grid_ovf = _grid_sorted(a_x, a_ok, eps, cell_cap,
                                                metric)
    else:
        raise ValueError(f"unknown local_engine {local_engine!r}")

    def sorted_reduce(fn):
        """fn(cand, hit) per chunk of sorted rows, scattered back to the
        original augmented order."""
        out = torch.cat([fn(*cand_fn(s, min(s + chunk, na)))
                         for s in range(0, na, chunk)])
        back = torch.empty_like(out)
        back[order] = out
        return back

    # ---- step 3: own counts/core; skins' core flags from their owners ----
    counts = sorted_reduce(lambda cand, hit: hit.sum(dim=1,
                                                     dtype=torch.int32))
    core_own = (counts[:capd] >= min_pts) & sel
    s_core = torch.where(s_ok, core_own[sorder], False)
    g_score = mesh.all_gather(s_core)
    a_core_s = torch.cat([core_own, (g_score & not_own).reshape(-1)])[order]

    # ---- step 4: least-gid label fixpoint (local sweeps + skin rounds) ----
    lab_own0 = torch.where(core_own, gid0, _INF)
    skin_lab0 = torch.where(g_score & g_sok, g_sg, _INF)   # [ndev, skin_cap]
    lo_gid = rank * capd

    def local_fixpoint(lab_own, f_lab):
        """Sweeps with the foreign labels fixed: no collective inside, so
        each rank may take its own number of sweeps."""
        def sweep(lab_own):
            lab_s = torch.cat([lab_own, f_lab.reshape(-1)])[order]
            nm = sorted_reduce(lambda cand, hit: torch.where(
                hit & a_core_s[cand], lab_s[cand], _INF).amin(dim=1))
            new = torch.where(core_own, torch.minimum(lab_own, nm[:capd]),
                              _INF)
            # partial pointer jump through own gids (labels are global
            # gids; only locally-owned links can shortcut here)
            local = (new >= lo_gid) & (new < lo_gid + capd)
            jumped = new[(new - lo_gid).clamp(0, capd - 1)]
            return torch.where(local, torch.minimum(new, jumped), new)

        lab, nl = lab_own, sweep(lab_own)
        it = 1
        while it < 64 and not torch.equal(nl, lab):
            lab, nl = nl, sweep(nl)
            it += 1
        return nl

    def skin_labels(lab_own):
        return mesh.all_gather(torch.where(s_ok, lab_own[sorder], _INF))

    def outer(lab_own, f_lab):
        lab_own = local_fixpoint(lab_own, f_lab)
        f_new = torch.minimum(f_lab, skin_labels(lab_own))
        return lab_own, f_new, mesh.any((f_new != f_lab).any())

    lab_own, f_lab, changing = outer(lab_own0, skin_lab0)
    rounds = 1
    while changing and rounds < max_rounds:
        lab_own, f_lab, changing = outer(lab_own, f_lab)
        rounds += 1
    # leaving on the round cap with labels still moving surfaces in the
    # overflow (exact iff overflow == 0)
    unconverged = int(changing)
    f_final = torch.minimum(skin_lab0, skin_labels(lab_own))
    lab_own = local_fixpoint(lab_own, f_final)

    # ---- step 5: roots -> global ranks -> ids ----
    is_root = core_own & (lab_own == gid0)
    r_slot = torch.where(is_root, torch.arange(capd, device=dev), capd)
    rorder = torch.sort(r_slot, stable=True)[1][:root_cap]
    r_ok = r_slot[rorder] < capd
    r_g = torch.where(r_ok, gid0[rorder], _INF)
    root_drop = is_root.sum(dtype=torch.int32) - r_ok.sum(dtype=torch.int32)
    g_roots = torch.sort(mesh.all_gather(r_g).reshape(-1))[0]
    n_clusters = (g_roots < _INF).sum(dtype=torch.int32)

    def rank_of(lab):
        # 1-based rank of a root gid in the merged sorted root list; every
        # converged label is a root gid
        return torch.searchsorted(g_roots, lab) + 1

    core_id_own = torch.where(core_own, cf + rank_of(lab_own), 0)
    a_lab_s = torch.cat([lab_own, f_final.reshape(-1)])[order]
    a_id_s = torch.where(a_core_s, cf + rank_of(a_lab_s), 0)
    border = sorted_reduce(lambda cand, hit: torch.where(
        hit & a_core_s[cand], a_id_s[cand], 0).amax(dim=1))[:capd]
    label = torch.where(core_own, core_id_own,
                        torch.where(sel, border, 0)).to(torch.int32)
    overflow = mesh.psum(cdrop + skin_drop + root_drop + grid_ovf
                         + unconverged)
    return label, n_clusters, overflow
