"""Per-cluster segment reductions and padded per-cluster tables (port of
vtkcloudpoint_tpu.ops.segment).

Label 0 = noise, clusters 1..K; row c of every table is cluster id c. Ids
outside [0, num_segments) and invalid points are dropped, as the JAX one-hot
reductions drop them. The JAX package's TPU branches (one-hot matmuls,
sort-and-window tables) are not ported: on a GPU scatter-adds and stable
sorts are the natural tools.

Counts accumulate in int64 (exact at any size, cf. segment.py:114-121 of the
reference). Float sums are exact sums in int64 fixed point, rounded once
(``_segment_sum``): integer atomics give the same bits in any order, so a
run on the card repeats bit for bit and equals the CPU's -- a float64
``index_add_`` does not once a sum rounds (float32 values spread over more
than ~29 binary orders of magnitude, as BA's Jacobian blocks are), and a
sorted ``index_put_(accumulate=True)`` adds each segment's duplicates one
by one (at tier 3's 5M points on an H100: 7.9 ms against 0.8 for the
atomics; tools/profile_segment.py times the three).
"""
from __future__ import annotations

import torch

from ..utils import profiling as prof


# the fixed-point sums of _segment_sum keep every partial sum below 2^62
_FIXED_BITS = 62


def segment_sum(values, ids, num_segments: int):
    """jax.ops.segment_sum: values [N, ...] summed by segment id [N] into
    [num_segments, ...] of the values' dtype; ids outside
    [0, num_segments) are dropped."""
    ok = (ids >= 0) & (ids < num_segments)
    return _segment_sum(values, ok, ids.long(), num_segments).to(
        values.dtype)


def _segments(label, valid, num_segments: int):
    """(in_range mask, segment id clamped into [0, num_segments))."""
    ok = valid & (label >= 0) & (label < num_segments)
    return ok, torch.where(ok, label, torch.zeros_like(label)).long()


def _pow2(k):
    """2.0 ** k for an int64 tensor k in [-1022, 1023], built from its
    float64 bits (exact)."""
    return ((k + 1023) << 52).view(torch.float64)


def _segment_sum(values, ok, seg, num_segments: int):
    """Sum the rows of values [N, ...] with ``ok`` by segment id ``seg``
    into [num_segments, ...]: integers in their dtype, floats in float64.

    A float column scales by the power of two 2^k that puts N * max|column|
    under 2^_FIXED_BITS, rounds to int64 and adds with ``index_add_``: the
    exact integer sum, whatever the order of the atomics, scaled back once.
    A value finer than 2^-k (1.2e-10 for 5M coordinates of up to 64 m)
    rounds to that grid. A column holding a NaN or infinite value sums in
    float64 instead, so NaN and inf propagate as in jnp."""
    idx = torch.where(ok, seg, num_segments)
    shape = (num_segments + 1,) + values.shape[1:]
    if not values.is_floating_point():
        out = torch.zeros(shape, dtype=values.dtype, device=values.device)
        return out.index_add_(0, idx, values)[:num_segments]
    v = masked_rows(values, ok)
    amax = column_max(v)
    if not prof.sync(bool, torch.isfinite(amax).all()):
        out = torch.zeros(shape, dtype=torch.float64, device=values.device)
        return out.index_add_(0, idx, v)[:num_segments]
    q, k = fixed_point_sums(v, ok, seg, num_segments, amax, v.shape[0])
    return from_fixed_point(q, k)


def masked_rows(values, ok):
    """values [N, ...] in float64, the rows without ``ok`` zeroed."""
    rows = ok.reshape((-1,) + (1,) * (values.dim() - 1))
    return torch.where(rows, values.double(), 0.0)


def column_max(v):
    """max |v| over the rows of v [N, ...] (0 for no rows)."""
    if v.shape[0]:
        return v.abs().amax(dim=0)
    return torch.zeros(v.shape[1:], dtype=torch.float64, device=v.device)


def fixed_point_sums(v, ok, seg, num_segments: int, amax, n_rows: int):
    """The int64 fixed-point segment sums of the float64 rows v [N, ...]
    with ``ok`` and their scale exponent k (the sums are 2^k times the
    real ones). ``amax`` (the finite column maxima) and ``n_rows`` bound
    the sums; a caller that sums the int64 results of several shards
    passes the maxima and row count of all of them, so the total stays
    below 2^_FIXED_BITS and every shard rounds to the same grid."""
    # max|column| < 2^e and N <= 2^bits(N - 1), so N * max < 2^(e + bits)
    k = (_FIXED_BITS - torch.frexp(amax)[1].long()
         - max(n_rows - 1, 0).bit_length()).clamp(-1000, 1000)
    q = (v * _pow2(k)).round().long()
    out = torch.zeros((num_segments + 1,) + v.shape[1:], dtype=torch.int64,
                      device=v.device)
    out.index_add_(0, torch.where(ok, seg, num_segments), q)
    return out[:num_segments], k


def from_fixed_point(q, k):
    """float64 sums of fixed_point_sums' int64 sums q at scale 2^k."""
    return q.double() * _pow2(-k)


def cluster_counts(label, valid, num_segments: int):
    """Point count per cluster id, i32[num_segments] (row 0 = noise)."""
    ok, seg = _segments(label, valid, num_segments)
    sel = prof.sync(lambda: seg[ok])
    return prof.sync(torch.bincount, sel, minlength=num_segments).to(
        torch.int32)


def cluster_means(values, label, valid, num_segments: int, weights=None):
    """Per-cluster mean of ``values`` [N, D] -> ([num_segments, D], weight
    sum [num_segments]). Empty clusters return 0."""
    w = valid.to(values.dtype)
    if weights is not None:
        w = w * weights.to(values.dtype)
    ok, seg = _segments(label, valid, num_segments)
    both = torch.cat([values * w[:, None], w[:, None]], dim=1)
    sums = _segment_sum(both, ok, seg, num_segments).to(values.dtype)
    cnt = sums[:, -1]
    return sums[:, :-1] / torch.clamp_min(cnt, 1.0)[:, None], cnt


def cluster_stats(xyz, motor, label, valid, num_segments: int, mult=None):
    """All centroid tables in one pass.

    Returns dict: count i32[K+1], weighted_count f[K+1], center3d f[K+1, 3],
    center2d f[K+1, 2].
    """
    dt = xyz.dtype
    w = valid.to(dt)
    if mult is not None:
        w = w * mult.to(dt)
    ok, seg = _segments(label, valid, num_segments)
    cols = torch.cat([xyz * w[:, None], motor * w[:, None], w[:, None]],
                     dim=1)
    sums = _segment_sum(cols, ok, seg, num_segments).to(dt)
    wcnt = sums[:, 5]
    inv = 1.0 / torch.clamp_min(wcnt, 1.0)
    return {
        "count": cluster_counts(label, valid, num_segments),
        "weighted_count": wcnt,
        "center3d": sums[:, :3] * inv[:, None],
        "center2d": sums[:, 3:5] * inv[:, None],
    }


def _sorted_runs(label, valid, num_segments: int):
    """Stable sort by cluster id (invalid -> num_segments): (order,
    sorted ids, run start of each id [num_segments + 1], rank in run)."""
    lab = torch.where(valid, label,
                      torch.full_like(label, num_segments)).to(torch.int64)
    sorted_lab, order = torch.sort(lab, stable=True)
    ids = torch.arange(num_segments + 1, device=label.device)
    first = torch.searchsorted(sorted_lab, ids)
    pos = torch.arange(lab.shape[0], device=label.device)
    rank = pos - first[sorted_lab.clamp(0, num_segments)]
    return order, sorted_lab, first, rank


def bucket_payload_by_cluster(label, valid, payload, num_segments: int,
                              capacity: int):
    """Per-cluster padded payload tables.

    payload: f32 [N, P] or a tuple of f32 [N] columns. Returns (tables
    [num_segments, capacity, P] with zeros in empty slots, slot_valid
    [num_segments, capacity], counts i32[num_segments], overflow
    i32[num_segments]). Slot order within a cluster is ascending point
    index (the stable sort).
    """
    if isinstance(payload, (tuple, list)):
        payload = torch.stack(tuple(payload), dim=-1)
    order, sorted_lab, first, rank = _sorted_runs(label, valid,
                                                  num_segments)
    run = (first[1:] - first[:-1]).to(torch.int32)
    keep = (rank < capacity) & (sorted_lab >= 0) & (
        sorted_lab < num_segments)
    flat = (prof.sync(lambda: sorted_lab[keep]) * capacity
            + prof.sync(lambda: rank[keep]))
    p = payload.shape[1]
    tables = torch.zeros((num_segments * capacity, p), dtype=payload.dtype,
                         device=payload.device)
    tables[flat] = payload[prof.sync(lambda: order[keep])]
    slot_valid = (torch.arange(capacity, device=label.device)[None, :]
                  < torch.clamp_max(run, capacity)[:, None])
    return (tables.reshape(num_segments, capacity, p), slot_valid, run,
            torch.clamp_min(run - capacity, 0))


def bucket_by_cluster(label, valid, num_segments: int, capacity: int):
    """Per-cluster point-index table i32[num_segments, capacity] (-1 = empty
    slot, ascending point index within a cluster) and overflow
    i32[num_segments] (points beyond ``capacity``, dropped)."""
    order, sorted_lab, _, rank = _sorted_runs(label, valid, num_segments)
    keep = (rank < capacity) & (sorted_lab >= 0) & (
        sorted_lab < num_segments)
    table = torch.full((num_segments * capacity,), -1, dtype=torch.int32,
                       device=label.device)
    table[prof.sync(lambda: sorted_lab[keep]) * capacity
          + prof.sync(lambda: rank[keep])] = prof.sync(
        lambda: order[keep]).to(torch.int32)
    counts = cluster_counts(label, valid, num_segments)
    return (table.reshape(num_segments, capacity),
            torch.clamp_min(counts - capacity, 0))
