"""Carry arrays and results between numpy (e.g. np.asarray of the JAX
package's outputs) and the port's tensors, keeping dtypes (bool, int32,
float32) as they are.

Trees are nested dicts, lists, tuples and NamedTuples (ClusterResult,
ICPResult) of arrays; other leaves (Python scalars, None) pass through.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def from_numpy(tree, device=DEFAULT_DEVICE):
    """Every array-like leaf (anything with ``__array__``) -> a tensor of
    the same dtype on ``device`` (default the card)."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
            return torch.from_numpy(np.array(x, copy=True)).to(device)
        return x

    return _map(leaf, tree)


def to_numpy(tree):
    """Every tensor leaf -> a numpy array of the same dtype (host copy)."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return _map(leaf, tree)
