"""Carry arrays and results between numpy (e.g. np.asarray of the JAX
package's outputs) and the port's tensors, keeping dtypes (bool, int32,
float32) as they are.

Trees are nested dicts, lists, tuples and NamedTuples of arrays; other
leaves (Python scalars, None) pass through. A NamedTuple of the JAX package
(ClusterResult, ICPResult, and the SLAM state PoseGraph, Observations,
Trajectory, MapState) becomes the port's NamedTuple of the same name.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device


def _port_namedtuples() -> dict:
    """The port's NamedTuples that carry state across packages, by name."""
    from .cluster.pipeline import ClusterResult
    from .register.icp import ICPResult
    from .slam.ba import Observations
    from .slam.posegraph import PoseGraph
    from .slam.scan2map import MapState
    from .slam.trajectory import Trajectory

    return {cls.__name__: cls for cls in (ClusterResult, ICPResult,
                                          PoseGraph, Observations,
                                          Trajectory, MapState)}


def _map(fn, tree, types=None):
    """``fn`` over every leaf. A NamedTuple is rebuilt as its own type, or
    with ``types`` as the type of its name there (same fields) if any."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, types) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = type(tree)
        mine = (types or {}).get(cls.__name__)
        if mine is not None and mine._fields == tree._fields:
            cls = mine
        return cls(*(_map(fn, v, types) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, types) for v in tree)
    return fn(tree)


def from_numpy(tree, device=DEFAULT_DEVICE):
    """Every array-like leaf (anything with ``__array__``) -> a tensor of
    the same dtype on ``device`` (default the card); the JAX package's
    NamedTuples -> the port's of the same name."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
            return torch.from_numpy(np.array(x, copy=True)).to(device)
        return x

    return _map(leaf, tree, _port_namedtuples())


def to_numpy(tree):
    """Every tensor leaf -> a numpy array of the same dtype (host copy)."""

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return x

    return _map(leaf, tree)
