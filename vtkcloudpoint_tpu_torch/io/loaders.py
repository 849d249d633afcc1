"""Scan ingestion + export.

Host-side IO replacing the reference's L3 layer (SURVEY.md §1):
- text scan loading via the native mmap parser (native/fastparse.cpp, the
  FileMap.ReadFileMap equivalent, FileMap.cs:137-200) with a NumPy fallback
- folder walk where each file is one path/marker (AddFolder,
  FrmMain.cs:916-1134)
- exact-duplicate collapse with multiplicity counts (FrmMain.cs:1063-1089;
  O(N log N) here vs the reference's quadratic FindAll scan)
- export writers mirroring Tools.exportClustersCenterFile /
  exportClustersPointsFile (Tools.cs:322-387)

The port's own copy of vtkcloudpoint_tpu/io/loaders.py (numpy and the stdlib
only), so the port never imports the JAX package.
"""
from __future__ import annotations

import ctypes
import glob
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB = None
_LIB_TRIED = False


def _native_lib():
    """Build (once) and load the native parser; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(_NATIVE_DIR, "libfastparse.so")
    src = os.path.join(_NATIVE_DIR, "fastparse.cpp")
    try:
        # rebuild keyed on source CONTENT (mtimes are unreliable after a
        # checkout: equal stamps would silently keep a stale binary)
        import hashlib

        digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
        stamp = so + ".srchash"
        stale = (not os.path.exists(so)) or (not os.path.exists(stamp)) or (
            open(stamp).read().strip() != digest
        )
        if stale:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", so, src, "-lpthread"],
                check=True, capture_output=True,
            )
            with open(stamp, "w") as f:
                f.write(digest)
        lib = ctypes.CDLL(so)
        lib.fastparse_xyz.restype = ctypes.c_long
        lib.fastparse_xyz.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
            ctypes.c_int,
        ]
        lib.fastparse_count.restype = ctypes.c_long
        lib.fastparse_count.argtypes = [ctypes.c_char_p, ctypes.c_int]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def load_scan(path: str, use_native: bool = True) -> np.ndarray:
    """Dispatch by extension: .xls -> BIFF reader, else text parser
    (the reference's isXLS switch, FrmMain.cs:957-1010)."""
    if path.lower().endswith(".xls"):
        from .xls import load_scan_xls

        return load_scan_xls(path)
    return load_scan_txt(path, use_native)


def read_text_lines(path: str):
    """Read a text file's lines, GB2312-tolerant.

    The reference decodes scan files via GB2312 (FileMap.ReadFile,
    FileMap.cs:16-33 -- Chinese-locale scanner exports). Numeric content is
    ASCII either way; this matters for marker/truth names. Try strict utf-8
    first, then gb18030 (superset of GB2312/GBK), then latin-1 as a lossless
    last resort."""
    with open(path, "rb") as f:
        raw = f.read()
    for enc in ("utf-8", "gb18030", "latin-1"):
        try:
            return raw.decode(enc).splitlines()
        except UnicodeDecodeError:
            continue
    return raw.decode("utf-8", errors="replace").splitlines()


def sniff_decimals(path: str, default: int = 4) -> int:
    """Decimal-precision sniff: digits after the last '.' in the FIRST
    field of the first parseable line (FrmMain.cs:984: ``bit = ssss.Length -
    ssss.LastIndexOf(".") - 1``). Drives export formatting precision."""
    try:
        for line in read_text_lines(path):
            field = line.replace(",", " ").replace(";", " ").split()
            if not field:
                continue
            s = field[0]
            try:
                float(s)
            except ValueError:
                continue
            # C# semantics: LastIndexOf returns -1 when absent -> bit = len
            return len(s) - s.rfind(".") - 1
    except OSError:
        pass
    return default


def load_scan_txt(path: str, use_native: bool = True) -> np.ndarray:
    """Parse a 3-column scan file -> float64 [N, 3] (motor_x, motor_y, dist)."""
    lib = _native_lib() if use_native else None
    if lib is not None:
        cap = max(lib.fastparse_count(path.encode(), 0), 16)
        # fastparse_count is an exact per-line bound, so -2 (truncation)
        # only fires on multi-row lines; grow and retry rather than silently
        # degrading to the slow python parser
        for _ in range(3):
            buf = np.empty((cap, 3), dtype=np.float64)
            n = lib.fastparse_xyz(
                path.encode(),
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                cap, 0,
            )
            if n >= 0:
                return buf[:n].copy()
            if n != -2:
                break
            cap *= 4
    # fallback: tolerant python parse (tab/space/comma separated)
    rows = []
    for line in read_text_lines(path):
        parts = line.replace(",", " ").replace(";", " ").split()
        if len(parts) >= 3:
            try:
                rows.append((float(parts[0]), float(parts[1]),
                             float(parts[2])))
            except ValueError:
                continue
    return np.array(rows, dtype=np.float64).reshape(-1, 3)


def load_folder(folder: str, pattern: str = "*.txt", use_native: bool = True):
    """Load every matching file; returns (data [N,3], path_id i32[N],
    names list). Each file is one path (reference pathId semantics)."""
    files = sorted(glob.glob(os.path.join(folder, pattern)))
    datas, pids, names = [], [], []
    for i, f in enumerate(files):
        d = load_scan(f, use_native)
        datas.append(d)
        pids.append(np.full(len(d), i, np.int32))
        names.append(os.path.splitext(os.path.basename(f))[0])
    if not datas:
        return np.zeros((0, 3)), np.zeros(0, np.int32), []
    return np.concatenate(datas), np.concatenate(pids), names


def dedup_exact(xyz: np.ndarray):
    """Collapse exact-duplicate rows, keeping FIRST occurrence order.

    Returns (unique_index i64[M] into the original array, mult i64[M]).
    Reference semantics (FrmMain.cs:1063-1089): typpe 1 drops duplicates,
    typpe 3/4 counts them into ptsCount -- both served by the multiplicity.
    """
    _, first_idx, inverse, counts = np.unique(
        xyz, axis=0, return_index=True, return_inverse=True, return_counts=True
    )
    order = np.argsort(first_idx, kind="stable")
    return first_idx[order], counts[order]


def export_centroids(path: str, centers: np.ndarray, bit: int = 4):
    """x \t y \t z with F{bit} formatting (Tools.cs:343 active branch)."""
    with open(path, "w") as f:
        for c in centers:
            f.write(f"{c[0]:.{bit}f}\t{c[1]:.{bit}f}\t{c[2]:.{bit}f}\n")


def export_cluster_points(path: str, labels, motor, dist, bit: int = 4):
    """clusterId \t motor_x \t motor_y \t Distance (Tools.cs:371-377)."""
    with open(path, "w") as f:
        for lab, m, d in zip(labels, motor, dist):
            f.write(f"{int(lab)}\t{m[0]:.{bit}f}\t{m[1]:.{bit}f}\t{d:.{bit}f}\n")


def export_matches(path: str, motor, dist, truth_xyz, matched_mask,
                   match_idx, bit: int = 4):
    """Matched centroid export: angles + range + matched truth coords
    (exportMatchingFile, FrmMain.cs:1672-1716)."""
    with open(path, "w") as f:
        for i in range(len(motor)):
            if not matched_mask[i]:
                continue
            t = truth_xyz[match_idx[i]]
            f.write(
                f"{motor[i][0]:.{bit}f}\t{motor[i][1]:.{bit}f}\t"
                f"{dist[i]:.{bit}f}\t{t[0]:.{bit}f}\t{t[1]:.{bit}f}\t"
                f"{t[2]:.{bit}f}\n"
            )
