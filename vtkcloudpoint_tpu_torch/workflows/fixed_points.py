"""Fixed-point (survey-marker) workflow (port of
vtkcloudpoint_tpu.workflows.fixed_points).

Folders where each file is one known control marker (AddFolder typpe 3/4,
FrmMain.cs:946-947, 1020-1089): each file becomes one cluster, exact
duplicates collapse into a multiplicity count, centroids are optionally
multiplicity-weighted (getFixedPtsCentroid, Tools.cs:78-111), and markers
join a truth list by name (FrmMain.cs:2366-2405). Host numpy throughout,
except the range gate and the motor -> XYZ conversion, which run on the
device in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import ImportConfig
from ..data.convert import motor_to_xyz, range_gate
from ..device import DEFAULT_DEVICE, resolve_device
from ..io.loaders import dedup_exact, load_folder, read_text_lines


class FixedPointSet(NamedTuple):
    xyz: np.ndarray        # [N, 3]
    motor: np.ndarray      # [N, 2]
    rng: np.ndarray        # [N]
    mult: np.ndarray       # i64[N] duplicate multiplicity (ptsCount)
    cluster: np.ndarray    # i32[N] marker id = file index + 1
    names: list            # marker names (file basenames)


def import_fixed_points(folder: str, cfg: ImportConfig = ImportConfig(),
                        collapse_duplicates: bool = True,
                        device=DEFAULT_DEVICE) -> FixedPointSet:
    """typpe 3 (collapse duplicates, count them) / typpe 4 (keep all); the
    range gate and the conversion run on ``device`` (default the card)."""
    device = resolve_device(device)
    raw, pid, names = load_folder(folder)
    rng_t = torch.from_numpy(raw[:, 2].astype(np.float32)).to(device)
    keep = range_gate(rng_t, cfg).cpu().numpy()
    raw, pid = raw[keep], pid[keep]
    motor = raw[:, :2]
    rng = raw[:, 2]
    xyz = motor_to_xyz(
        torch.from_numpy(motor.astype(np.float32)).to(device),
        torch.from_numpy(rng.astype(np.float32)).to(device),
        cfg).cpu().numpy()
    if collapse_duplicates:
        # dedup within each marker file (the reference dedups per cluster)
        keep_idx, mult = [], []
        for i in range(len(names)):
            m = np.nonzero(pid == i)[0]
            ki, mu = dedup_exact(xyz[m])
            keep_idx.append(m[ki])
            mult.append(mu)
        keep_idx = (np.concatenate(keep_idx) if keep_idx
                    else np.zeros(0, np.int64))
        mult = np.concatenate(mult) if mult else np.zeros(0, np.int64)
        xyz, motor, rng, pid = (xyz[keep_idx], motor[keep_idx],
                                rng[keep_idx], pid[keep_idx])
    else:
        mult = np.ones(len(xyz), np.int64)
    return FixedPointSet(xyz=xyz, motor=motor, rng=rng, mult=mult,
                         cluster=(pid + 1).astype(np.int32), names=names)


def fixed_point_centroids(fps: FixedPointSet, weighted: bool = True):
    """Per-marker centroid [K, 3] (float64); weighted=False ignores the
    multiplicity (isIgnoreDuplication, Tools.cs:88-101)."""
    k = len(fps.names)
    out = np.zeros((k, 3))
    for i in range(k):
        m = fps.cluster == i + 1
        w = fps.mult[m].astype(float) if weighted else np.ones(m.sum())
        out[i] = (fps.xyz[m] * w[:, None]).sum(0) / max(w.sum(), 1.0)
    return out


def match_by_name(names: list, truth_names: list, truth_xyz: np.ndarray):
    """Name-join marker centroids to truth entries. Returns (marker_idx
    i64[M], truth_idx i64[M]) for the names present in both."""
    tmap = {n: i for i, n in enumerate(truth_names)}
    pairs = [(i, tmap[n]) for i, n in enumerate(names) if n in tmap]
    mi = np.array([p[0] for p in pairs], np.int64)
    ti = np.array([p[1] for p in pairs], np.int64)
    return mi, ti


def parse_truth_csv(path: str):
    """Truth marker file, 'name x y z' or 'name,x,y,z' per line
    (FixedPtsMatch_Export.cs:20-78), GB2312-tolerant. Returns (names,
    xyz [K, 3])."""
    names, rows = [], []
    for line in read_text_lines(path):
        parts = line.replace(",", " ").split()
        if len(parts) >= 4:
            try:
                rows.append([float(parts[1]), float(parts[2]),
                             float(parts[3])])
            except ValueError:
                continue
            names.append(parts[0])
    return names, np.array(rows).reshape(-1, 3)


def export_fixed_point_matches(path: str, fps: FixedPointSet,
                               centroids: np.ndarray, truth_names: list,
                               truth_xyz: np.ndarray, bit: int = 4):
    """Per-marker export: name, centroid, matched truth coordinates.
    Returns the number of rows written."""
    mi, ti = match_by_name(fps.names, truth_names, truth_xyz)
    with open(path, "w") as f:
        for a, b in zip(mi, ti):
            c = centroids[a]
            t = truth_xyz[b]
            f.write(
                f"{fps.names[a]}\t{c[0]:.{bit}f}\t{c[1]:.{bit}f}\t"
                f"{c[2]:.{bit}f}\t{t[0]:.{bit}f}\t{t[1]:.{bit}f}\t"
                f"{t[2]:.{bit}f}\n"
            )
    return len(mi)
