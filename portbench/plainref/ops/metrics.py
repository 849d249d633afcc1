"""Point-pair distance metrics (port of vtkcloudpoint_tpu.ops.metrics).

- "l1_motor": |dx|+|dy| over motor coords (DBImproved.cs:14-25)
- "signed_sum_xy": dx+dy over X/Y, no abs (the DB.cs:14-25 legacy bug)
- "l2_xyz" / "l2_xy": Euclidean, dimension-agnostic

Every function takes a [..., M, D] and b [..., N, D] and returns the
[..., M, N] block; leading dimensions batch. Per-coordinate terms are summed
in coordinate order (k = 0, 1, 2), the order of the JAX reduction, so an L1
or signed-sum distance is bit-equal to the reference's.
"""
from __future__ import annotations

import torch

from .. import device as _device  # noqa: F401  (full-f32 matmuls)


def _diff(a, b, k):
    return a[..., :, None, k] - b[..., None, :, k]


def pairwise_l1(a, b):
    d = _diff(a, b, 0).abs()
    for k in range(1, a.shape[-1]):
        d = d + _diff(a, b, k).abs()
    return d


def pairwise_signed_sum(a, b):
    """Reference legacy metric (DB.cs:14-25): sum of SIGNED deltas a - b."""
    d = _diff(a, b, 0)
    for k in range(1, a.shape[-1]):
        d = d + _diff(a, b, k)
    return d


def _sqnorm(a):
    s = a[..., 0] * a[..., 0]
    for k in range(1, a.shape[-1]):
        s = s + a[..., k] * a[..., k]
    return s


def pairwise_sqdist(a, b):
    """Squared L2 via the |a|^2 - 2ab + |b|^2 expansion, in full float32
    (device.py turns TF32 off). Less exact than direct differences: use it
    only where its rounding cannot change a decision."""
    ab = torch.matmul(a, b.transpose(-1, -2))
    d = _sqnorm(a)[..., :, None] - 2.0 * ab + _sqnorm(b)[..., None, :]
    return torch.clamp_min(d, 0.0)


def pairwise_l2(a, b):
    return torch.sqrt(pairwise_sqdist(a, b))


def pairwise(a, b, metric: str):
    if metric == "l1_motor":
        return pairwise_l1(a, b)
    if metric == "signed_sum_xy":
        return pairwise_signed_sum(a, b)
    if metric in ("l2_xyz", "l2_xy"):
        return pairwise_l2(a, b)
    raise ValueError(f"unknown metric {metric!r}")


def coords_for_metric(xyz, motor, metric: str):
    """The coordinate set a metric operates on."""
    if metric == "l1_motor":
        return motor
    if metric == "signed_sum_xy":
        return xyz[..., :2]
    if metric == "l2_xyz":
        return xyz
    raise ValueError(f"unknown metric {metric!r}")
