"""Roofline counts of the hand-written kernels K1 (per-block DBSCAN), K2
(cluster shapes) and K3 (nearest-neighbour argmin), and the card's peaks.

What is counted is the work of the problem on these inputs, not the
instructions of a build: operations are the float32 arithmetic and
comparisons that the least algorithm needs, bytes are each input read once
and each output written once. A kernel that does the same work another way
(fused multiply-adds, another tiling, a pruned search) reads no higher
against these counts; one that does more work than needed reads lower.

- K1: the least DBSCAN tests every unordered pair of distinct valid points
  of a block once: nv (nv - 1) / 2 pairs, each D subtractions, D - 1
  additions (the absolute value is an operand modifier) and one comparison
  with eps, 2 D operations. Bytes: the block table in (D float32 and a
  valid byte a slot), labels and core flags out (4 + 1 bytes a slot).
- K2: from each table's valid count n and hull size h (the gift wrap of the
  reference): the wrap, h steps of a pseudo-angle (~7) over n points; the
  minimal enclosing circle, C(h, 2) pair and C(h, 3) triple circles (~9 and
  ~25) each tested against h hull points (6); the rectangle, h edges (~8)
  projecting h points (10). Bytes: the tables in (two float32 and a valid
  byte a slot, a count a table), six float32 results a table out.
- K3: every valid query against every valid reference: 3 subtractions, 3
  multiplications, 2 additions and one comparison, 9 operations a pair.
  Bytes: queries and references in (three float32 each, a valid byte a
  reference), an index and a distance a query out.

Peaks: NVIDIA H100 SXM data sheet, 67 TFLOP/s float32 outside the tensor
cores, 3.35 TB/s HBM3, at the full 700 W power limit. A share is the least
time the card could take (the larger of operations over the FLOP peak and
bytes over the bandwidth) over the kernel's measured time, in percent.
"""
from __future__ import annotations

import re

PEAK_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# kernel names of each hand-written kernel in the device trace (a K3 call
# is three kernels: fill, search, unpack)
KERNELS = {
    "K1": ("dbscan_block_kernel",),
    "K2": ("shapes_kernel",),
    "K3": ("nn_kernel", "fill_keys", "unpack_keys"),
}


def kernel_seconds(kernels: dict, which: str) -> float:
    """Summed trace seconds of the kernels of ``which`` ("K1".."K3"):
    names matched as whole words of the demangled name."""
    pat = re.compile(r"\b(%s)\b" % "|".join(KERNELS[which]))
    return sum(sec for name, sec in kernels.items() if pat.search(name))


def k1_work(nv, d: int, cap: int):
    """K1 on blocks of valid counts nv (a sequence of ints) of capacity cap
    at dimension d: (operations, bytes)."""
    pairs = sum(n * (n - 1) // 2 for n in nv)
    slots = len(nv) * cap
    return 2 * d * pairs, slots * (4 * d + 1) + slots * (4 + 1)


def k2_work(n, h, cap: int):
    """K2 on tables of valid counts n and hull sizes h (sequences):
    (operations, bytes)."""
    ops = 0
    for nn, hh in zip(n, h):
        pairs = hh * (hh - 1) / 2
        triples = hh * (hh - 1) * (hh - 2) / 6
        ops += (7 * hh * nn + pairs * (9 + 6 * hh) + triples * (25 + 6 * hh)
                + hh * (8 + 10 * hh))
    k = len(n)
    return ops, k * cap * (2 * 4 + 1) + k * 4 + k * 6 * 4


def k3_work(n_valid: int, m_valid: int, n_rows: int, m_rows: int):
    """One K3 call: (operations, bytes)."""
    return (9 * n_valid * m_valid,
            n_rows * 12 + m_rows * (12 + 1) + n_rows * 8)


def share_pct(ops: float, n_bytes: float, seconds: float):
    """Percent of the roofline, or None where nothing was timed."""
    if seconds <= 0 or (ops <= 0 and n_bytes <= 0):
        return None
    least = max(ops / PEAK_FLOPS, n_bytes / PEAK_BYTES_PER_S)
    return 100.0 * least / seconds
