"""Exact-duplicate collapse, copied from the port's io/loaders.py."""
from __future__ import annotations

import numpy as np


def dedup_exact(xyz: np.ndarray):
    """Collapse exact-duplicate rows, keeping FIRST occurrence order.

    Returns (unique_index i64[M] into the original array, mult i64[M]).
    """
    _, first_idx, inverse, counts = np.unique(
        xyz, axis=0, return_index=True, return_inverse=True, return_counts=True
    )
    order = np.argsort(first_idx, kind="stable")
    return first_idx[order], counts[order]
