"""Grid-hash DBSCAN: global clustering without blocks (port of
vtkcloudpoint_tpu.cluster.grid).

Points bin into eps-sized cells; every neighbourhood scan is restricted to
the 3^D surrounding cells (9 for D = 2, 27 for D = 3), which cover the
eps-ball for L1 and L2. Cell ids are a multiplicative hash of the integer
cell coordinates, linear in them, so a stencil neighbour's id is the own
raw hash plus a constant: ``(raw + delta) & MASK == hash(c + offset)``.
Collisions only add candidates that the distance test rejects. Points sort
by cell id; each query reads a window of ``cell_cap`` slots per stencil
cell. Points beyond ``cell_cap`` in an overfull cell stay queries but stop
being candidates: ``overflow`` counts them (exact iff it is 0).

Arithmetic follows the compiled JAX program:
- the int32 hash wraps in two's complement. Torch computes it in int64 and
  wraps explicitly (``wrap32``); the mask is applied after the add;
- XLA turns the division by the static eps into a multiplication by its
  reciprocal in the coordinates' precision, so float32 cell coordinates
  here are ``floor((x - lo) * f32(1 / f32(eps)))`` (``reciprocal``);
- the distance rule is the grid's own: L1 ``sum |d|`` or L2
  ``sqrt(sum d^2)`` from direct differences, summed left to right, against
  eps rounded to float32;
- one Jacobi sweep, then sweeps while a label changed and fewer than
  ``max_iters`` ran, each followed by one pointer jump ``min(new,
  new[new])`` (``cluster.dbscan.fixpoint``, ``relabel``). The loop reads
  one flag from the device per sweep.

Queries run in row chunks of at most ``CANDIDATE_BUDGET`` candidates, which
bounds memory and does not change results (every reduction is a min, a max
or a count). This is plain PyTorch: the JAX package runs it as XLA, with no
Pallas kernel.
"""
from __future__ import annotations

from itertools import product

import numpy as np
import torch

from .dbscan import _threshold, fixpoint, relabel

# odd multiplicative constants as int32 (0x9E3779B1 etc.) and an
# independent second set for two-hash membership tests (halo_fusion.py)
_PRIMES = (-1640531535, -2048144789, -1028477387)
_PRIMES2 = (-1898519407, -1376312589, -741103597)
_MASK = 0x7FFFFFFE      # ids in [0, 2^31 - 2]; INT_MAX marks invalid points
_INT_MAX = 2**31 - 1
CANDIDATE_BUDGET = 1 << 26


def wrap32(v):
    """Two's-complement int32 wrap of an int64 tensor or a Python int."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def reciprocal32(size: float) -> float:
    """f32(1 / f32(size)): the factor XLA multiplies by where the JAX
    package divides float32 values by a static cell size."""
    return float(np.float32(1.0) / np.float32(size))


def reciprocal(size: float, dtype) -> float:
    """The factor XLA multiplies values of ``dtype`` by where the JAX
    package divides them by a static size: 1 / size in the values' own
    precision (reciprocal32 for float32, the double 1 / size for
    float64)."""
    return 1.0 / size if dtype == torch.float64 else reciprocal32(size)


def cell_hash(cidx, primes):
    """int32-wrapped (as int64) sum of cell coordinates [..., D] times the
    primes: the unmasked raw hash."""
    raw = wrap32(cidx[..., 0] * primes[0])
    for ax in range(1, cidx.shape[-1]):
        raw = wrap32(raw + wrap32(cidx[..., ax] * primes[ax]))
    return raw


def stencil_deltas(ndim: int, primes):
    """Raw-hash offsets of the 3^D stencil cells, nested (-1, 0, 1) order."""
    return [wrap32(sum(o[ax] * primes[ax] for ax in range(ndim)))
            for o in product((-1, 0, 1), repeat=ndim)]


def grid_metric(metric: str, ndim: int):
    """The grid-engine metric equivalent to ``metric`` on D-dim coords, or
    None when it has no grid form (signed_sum_xy is not a metric)."""
    if metric == "l1_motor":
        return "l1_motor"
    if metric == "l2_xyz":
        return "l2_xyz" if ndim == 3 else "l2_xy"
    if metric == "l2_xy":
        return "l2_xy"
    return None


def _pair_dist(q, cols, metric):
    """Distance of each query row q [c, D] to its candidates, given per axis
    as cols[k] [c, K]."""
    if metric == "l1_motor":
        d = (q[:, 0:1] - cols[0]).abs()
        for k in range(1, len(cols)):
            d = d + (q[:, k:k + 1] - cols[k]).abs()
        return d
    if metric in ("l2_xy", "l2_xyz"):
        e = q[:, 0:1] - cols[0]
        d = e * e
        for k in range(1, len(cols)):
            e = q[:, k:k + 1] - cols[k]
            d = d + e * e
        return torch.sqrt(d)
    raise ValueError(f"grid mode does not support metric {metric!r}")


def dbscan_grid(coords, valid, eps: float, min_pts: int,
                metric: str = "l1_motor", cf=0, cell_cap: int = 32,
                max_iters: int = 64):
    """Grid-hash DBSCAN over one (large) point set.

    coords [N, D] with D in (2, 3); valid [N]. Returns dict: label i32[N]
    (cf + 1.., 0 noise), n_clusters i32[], core bool[N], overflow i32[] --
    the id semantics of cluster.dbscan.dbscan_padded.
    """
    n, ndim = coords.shape
    if ndim not in (2, 3):
        raise ValueError(f"dbscan_grid supports D in (2, 3), got {ndim}")
    dev = coords.device
    deltas = stencil_deltas(ndim, _PRIMES)
    n_off = len(deltas)
    self_idx = list(product((-1, 0, 1), repeat=ndim)).index((0,) * ndim)
    lo = torch.where(valid[:, None], coords, 1e30).amin(dim=0)
    cidx = torch.floor((coords - lo) * reciprocal(eps, coords.dtype)).long()
    raw = cell_hash(cidx, _PRIMES)
    cell = torch.where(valid, raw & _MASK, _INT_MAX)
    sc, order = torch.sort(cell, stable=True)
    pts_s = [coords[order, k].contiguous() for k in range(ndim)]
    valid_s = valid[order]
    nbr = torch.stack([(raw + d) & _MASK for d in deltas], dim=1)[order]
    starts = torch.searchsorted(sc, nbr.contiguous())         # [n, 3^D]

    k_idx = torch.arange(cell_cap, device=dev)
    thr = _threshold(eps)
    rows = max(1, CANDIDATE_BUDGET // (n_off * cell_cap))

    def hits(s, e):
        """Candidates of sorted rows s:e and which lie within eps:
        (cand [c, 3^D * cap] sorted index, hit bool)."""
        raw_c = starts[s:e, :, None] + k_idx                 # [c, 3^D, cap]
        in_range = raw_c < n      # masked before clamping: a clamped index
        cand = raw_c.clamp_max(n - 1)   # could alias the last point
        ok = (sc[cand] == nbr[s:e, :, None]) & valid_s[cand] & in_range
        cand = cand.reshape(e - s, -1)
        q = torch.stack([p[s:e] for p in pts_s], dim=1)
        d = _pair_dist(q, [p[cand] for p in pts_s], metric)
        return cand, ok.reshape(e - s, -1) & (d <= thr)

    def row_reduce(fn):
        return torch.cat([fn(*hits(s, min(s + rows, n)))
                          for s in range(0, n, rows)])

    counts_s = row_reduce(lambda cand, hit: hit.sum(dim=1,
                                                    dtype=torch.int32))
    core_s = (counts_s >= min_pts) & valid_s
    rank = torch.arange(n, device=dev) - starts[:, self_idx]
    overflow = ((rank >= cell_cap) & valid_s).sum(dtype=torch.int32)

    # min-label propagation in ORIGINAL index space
    core = torch.zeros(n, dtype=torch.bool, device=dev)
    core[order] = core_s
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    inf = n

    def sweep(lab):
        lab_s = lab[order]
        nl_s = row_reduce(lambda cand, hit: torch.where(
            hit & core_s[cand], lab_s[cand], inf).amin(dim=1))
        nl = torch.empty_like(lab)
        nl[order] = nl_s
        return relabel(lab, nl, core, inf)

    lab = fixpoint(sweep, torch.where(core, idx, inf), max_iters)

    # renumber + border (the rules of dbscan_padded)
    is_root = core & (lab == idx)
    rank_root = torch.cumsum(is_root.to(torch.int32), 0, dtype=torch.int32)
    core_id = torch.where(core, cf + rank_root[lab.clamp(0, n - 1).long()],
                          0).to(torch.int32)
    core_id_s = core_id[order]
    border_s = row_reduce(lambda cand, hit: torch.where(
        hit & core_s[cand], core_id_s[cand], 0).amax(dim=1))
    border = torch.empty_like(core_id)
    border[order] = border_s.to(torch.int32)
    label = torch.where(core, core_id,
                        torch.where(valid, border, 0)).to(torch.int32)
    return {"label": label, "n_clusters": is_root.sum(dtype=torch.int32),
            "core": core, "overflow": overflow}
