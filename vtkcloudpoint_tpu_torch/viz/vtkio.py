"""Headless visualization: legacy-VTK polydata writers.

The reference's visualization engine (C25-C27, SURVEY.md) is a native VTK 5.0
render window. A TPU engine is headless, so the equivalent capability is
EMITTING the same scene as .vtk polydata files (points colored by cluster id,
circumcircle outlines, match lines, region boxes) that any VTK viewer /
ParaView renders -- replacing ShowPointsFromFile (FrmMain.cs:353-527),
showCircle (:680-744), showMatchedLine (:247-345), showBounds (:2932-2991).

The port's own copy of vtkcloudpoint_tpu/viz/vtkio.py (numpy and the stdlib
only), so the port never imports the JAX package.
"""
from __future__ import annotations

import numpy as np


def _header(f, name):
    f.write("# vtk DataFile Version 3.0\n")
    f.write(f"{name}\n")
    f.write("ASCII\nDATASET POLYDATA\n")


def write_points_vtk(path: str, xyz: np.ndarray, labels=None,
                     name: str = "points"):
    """Point cloud with optional per-point cluster-id scalars (the
    color-by-class display, ShowPointsFromFile semantics)."""
    xyz = np.asarray(xyz, float)
    n = len(xyz)
    with open(path, "w") as f:
        _header(f, name)
        f.write(f"POINTS {n} float\n")
        for p in xyz:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2] if len(p) > 2 else 0.0:.6f}\n")
        f.write(f"VERTICES {n} {2 * n}\n")
        for i in range(n):
            f.write(f"1 {i}\n")
        if labels is not None:
            f.write(f"POINT_DATA {n}\nSCALARS cluster_id int 1\n"
                    "LOOKUP_TABLE default\n")
            for v in np.asarray(labels).astype(int):
                f.write(f"{v}\n")


def write_circles_vtk(path: str, centers_xy: np.ndarray, radii: np.ndarray,
                      segments: int = 64, name: str = "circles"):
    """Circumcircle outlines (vtkRegularPolygonSource equivalent,
    showCircle FrmMain.cs:680-744)."""
    centers_xy = np.asarray(centers_xy, float)
    radii = np.asarray(radii, float)
    keep = radii > 0
    centers_xy, radii = centers_xy[keep], radii[keep]
    k = len(radii)
    theta = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    with open(path, "w") as f:
        _header(f, name)
        f.write(f"POINTS {k * segments} float\n")
        for c, r in zip(centers_xy, radii):
            for t in theta:
                f.write(f"{c[0] + r * np.cos(t):.6f} "
                        f"{c[1] + r * np.sin(t):.6f} 0.0\n")
        f.write(f"LINES {k} {k * (segments + 2)}\n")
        for i in range(k):
            ids = " ".join(str(i * segments + j) for j in range(segments))
            f.write(f"{segments + 1} {ids} {i * segments}\n")


def write_lines_vtk(path: str, starts: np.ndarray, ends: np.ndarray,
                    name: str = "match_lines"):
    """Match/connection lines (vtkLineSource equivalent, showMatchedLine)."""
    starts = np.asarray(starts, float)
    ends = np.asarray(ends, float)
    n = len(starts)
    with open(path, "w") as f:
        _header(f, name)
        f.write(f"POINTS {2 * n} float\n")
        for a, b in zip(starts, ends):
            f.write(f"{a[0]:.6f} {a[1]:.6f} {a[2] if len(a) > 2 else 0.0:.6f}\n")
            f.write(f"{b[0]:.6f} {b[1]:.6f} {b[2] if len(b) > 2 else 0.0:.6f}\n")
        f.write(f"LINES {n} {3 * n}\n")
        for i in range(n):
            f.write(f"2 {2 * i} {2 * i + 1}\n")


def write_box_vtk(path: str, min_x, min_y, max_x, max_y, name: str = "region"):
    """Region box outline (showBounds equivalent)."""
    pts = [(min_x, min_y), (max_x, min_y), (max_x, max_y), (min_x, max_y)]
    with open(path, "w") as f:
        _header(f, name)
        f.write("POINTS 4 float\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} 0.0\n")
        f.write("LINES 1 6\n5 0 1 2 3 0\n")


def scene_export(prefix: str, xyz, labels, centers3d=None, radius3d=None,
                 match_starts=None, match_ends=None):
    """One-call scene dump: points+ids, circles, match lines."""
    write_points_vtk(prefix + "_points.vtk", xyz, labels)
    if centers3d is not None and radius3d is not None:
        write_circles_vtk(prefix + "_circles.vtk",
                          np.asarray(centers3d)[:, :2], radius3d)
    if match_starts is not None:
        write_lines_vtk(prefix + "_matches.vtk", match_starts, match_ends)
