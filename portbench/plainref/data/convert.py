"""Motor-angle <-> Cartesian coordinate conversion (port of
vtkcloudpoint_tpu.data.convert).

Forward conversion, reference FrmMain.cs:1025-1062:

    pitch   = -2 * (motor_x - x_angle) * pi / 180
    azimuth =  2 * (motor_y - y_angle) * pi / 180
    tmpx = D * cos(pitch) * sin(azimuth)
    tmpy = D * sin(pitch) * cos(azimuth)
    z    = D * cos(pitch)
    X, Y picked from {tmpy, tmpx, -tmpy, -tmpx} via the xdir/ydir switches.

The operations run in the order of the JAX functions, in the tensors' dtype
(float32 in the Engine); torch's and XLA's trigonometric functions may
differ by an ulp.
"""
from __future__ import annotations

import math

import torch

from ..config import ImportConfig

_DIR_SIGN = {1: 1.0, 2: 1.0, 3: -1.0, 4: -1.0}
_DIR_PICKS_TMPY = {1: True, 2: False, 3: True, 4: False}


def motor_to_xyz(motor, rng, cfg: ImportConfig = ImportConfig()):
    """Spherical (motor_x, motor_y, Distance) -> Cartesian xyz [N, 3]."""
    mx = motor[..., 0]
    my = motor[..., 1]
    pitch = (-2.0) * (mx - cfg.x_angle) / 180.0 * math.pi
    az = 2.0 * (my - cfg.y_angle) / 180.0 * math.pi
    tmpx = rng * torch.cos(pitch) * torch.sin(az)
    tmpy = rng * torch.sin(pitch) * torch.cos(az)
    z = rng * torch.cos(pitch)

    def pick(d):
        base = tmpy if _DIR_PICKS_TMPY[d] else tmpx
        return _DIR_SIGN[d] * base

    return torch.stack([pick(cfg.xdir), pick(cfg.ydir), z], dim=-1)


def range_gate(rng, cfg: ImportConfig = ImportConfig()):
    """Validity mask of the import range gate (FrmMain.cs:1011): drop
    Distance == 0 and Distance > 1000."""
    return (rng != cfg.range_min_exclusive) & (rng <= cfg.range_max)


def distance_window(rng, dis_min: float, dis_max: float):
    """Distance-window mask, True = keep: the open interval
    (dis_min, dis_max) (Tools.cs:416-431)."""
    return (rng < dis_max) & (rng > dis_min)
