"""PointBatch: struct-of-arrays point-cloud container of fixed capacity
(port of vtkcloudpoint_tpu.data.pointbatch).

Every field is a tensor on one device; dynamic sizes are a ``valid`` mask
over a static capacity. Padding rows hold zeros, mult 1 and valid False, as
in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..utils import profiling as prof


def _host(a):
    """A tensor or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return prof.sync(lambda: a.detach().cpu().numpy())
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """A padded batch of scanner points (reference Point3D,
    DataModel.cs:102-160):

      xyz     f[N, 3]  Cartesian coordinates
      motor   f[N, 2]  raw motor angles
      rng     f[N]     raw range reading (Distance)
      label   i32[N]   cluster id, 0 = noise
      mult    i32[N]   duplicate multiplicity (ptsCount)
      valid   bool[N]  padding mask
      path_id i32[N]   source-file index (pathId)
    """

    xyz: torch.Tensor
    motor: torch.Tensor
    rng: torch.Tensor
    label: torch.Tensor
    mult: torch.Tensor
    valid: torch.Tensor
    path_id: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def count(self) -> torch.Tensor:
        """Number of valid points (a 0-d int32 tensor on the device)."""
        return self.valid.sum(dim=-1, dtype=torch.int32)

    @staticmethod
    def empty(capacity: int, device=DEFAULT_DEVICE,
              dtype=torch.float32) -> "PointBatch":
        device = resolve_device(device)

        def full(shape, fill, dt):
            return torch.full(shape, fill, dtype=dt, device=device)

        return PointBatch(
            xyz=full((capacity, 3), 0.0, dtype),
            motor=full((capacity, 2), 0.0, dtype),
            rng=full((capacity,), 0.0, dtype),
            label=full((capacity,), 0, torch.int32),
            mult=full((capacity,), 1, torch.int32),
            valid=full((capacity,), False, torch.bool),
            path_id=full((capacity,), 0, torch.int32),
        )

    @staticmethod
    def from_arrays(xyz, motor=None, rng=None, label=None, mult=None,
                    valid=None, path_id=None, capacity: Optional[int] = None,
                    device=DEFAULT_DEVICE,
                    dtype=torch.float32) -> "PointBatch":
        """Build a PointBatch from host arrays (or tensors), padding to
        ``capacity``, on ``device`` (default the card)."""
        device = resolve_device(device)
        xyz = _host(xyz)
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        np_dt = torch.empty(0, dtype=dtype).numpy().dtype

        def pad(a, fill, dt, shape_tail=()):
            out = np.full((cap,) + shape_tail, fill, dtype=dt)
            out[:n] = _host(a)
            return prof.sync(torch.from_numpy(out).to, device)

        return PointBatch(
            xyz=pad(xyz, 0.0, np_dt, (3,)),
            motor=pad(np.zeros((n, 2)) if motor is None else motor, 0.0,
                      np_dt, (2,)),
            rng=pad(np.zeros(n) if rng is None else rng, 0.0, np_dt),
            label=pad(np.zeros(n, np.int32) if label is None else label, 0,
                      np.int32),
            mult=pad(np.ones(n, np.int32) if mult is None else mult, 1,
                     np.int32),
            valid=pad(np.ones(n, bool) if valid is None else valid, False,
                      bool),
            path_id=pad(np.zeros(n, np.int32) if path_id is None
                        else path_id, 0, np.int32),
        )

    def with_labels(self, label) -> "PointBatch":
        return dataclasses.replace(self, label=label)

    def with_valid(self, valid) -> "PointBatch":
        return dataclasses.replace(self, valid=valid)

    def to_numpy(self) -> dict:
        """Device -> host, padding stripped."""
        v = _host(self.valid)
        return {name: _host(getattr(self, name))[v]
                for name in ("xyz", "motor", "rng", "label", "mult",
                             "path_id")}


def concat(batches: list, capacity: Optional[int] = None,
           device=None) -> PointBatch:
    """Concatenate PointBatches through the host; the result lies on
    ``device`` (default: the first batch's)."""
    parts = [b.to_numpy() for b in batches]

    def cat(name):
        return np.concatenate([p[name] for p in parts])

    return PointBatch.from_arrays(
        cat("xyz"), motor=cat("motor"), rng=cat("rng"), label=cat("label"),
        mult=cat("mult"), path_id=cat("path_id"), capacity=capacity,
        device=batches[0].device if device is None else device)
