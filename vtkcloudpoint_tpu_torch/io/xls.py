"""Minimal legacy .xls (BIFF8) numeric reader.

Replaces the reference's NPOI XLS scan import (C4, FrmMain.cs:961-1002):
scan spreadsheets hold three numeric columns (motor_x, motor_y, Distance).
This is a from-scratch reader for that case -- OLE2 compound document
parsing + a BIFF record scan for NUMBER (0x0203), RK (0x027E) and MULRK
(0x00BD) cells -- with no external spreadsheet dependency (xlrd/openpyxl are
not available in this environment).

Limitations (by design): numeric cells only (strings/dates/formulas are
skipped), first worksheet's cells only in (row, col) order.

The port's own copy of vtkcloudpoint_tpu/io/xls.py (numpy and the stdlib
only), so the port never imports the JAX package.
"""
from __future__ import annotations

import struct

import numpy as np

_SECTOR = 512


def _read_ole2_stream(data: bytes, want_names=("Workbook", "Book")) -> bytes:
    """Extract a named stream from an OLE2 compound file."""
    if data[:8] != b"\xd0\xcf\x11\xe0\xa1\xb1\x1a\xe1":
        raise ValueError("not an OLE2 compound file")
    (sector_shift,) = struct.unpack_from("<H", data, 30)
    sec_size = 1 << sector_shift
    (num_fat_sectors,) = struct.unpack_from("<I", data, 44)
    (dir_start,) = struct.unpack_from("<I", data, 48)
    (mini_cutoff,) = struct.unpack_from("<I", data, 56)
    (minifat_start,) = struct.unpack_from("<I", data, 60)
    (num_minifat,) = struct.unpack_from("<I", data, 64)
    (difat_start,) = struct.unpack_from("<I", data, 68)
    (num_difat,) = struct.unpack_from("<I", data, 72)

    # FAT sector list: 109 entries in header + DIFAT chain
    fat_sectors = list(struct.unpack_from("<109i", data, 76))
    ds = difat_start
    for _ in range(num_difat):
        base = 512 + ds * sec_size
        entries = struct.unpack_from(f"<{sec_size // 4}i", data, base)
        fat_sectors.extend(entries[:-1])
        ds = entries[-1]
        if ds < 0:
            break
    fat_sectors = [s for s in fat_sectors if s >= 0][:num_fat_sectors]

    fat = []
    for s in fat_sectors:
        fat.extend(struct.unpack_from(f"<{sec_size // 4}i", data,
                                      512 + s * sec_size))

    def read_chain(start):
        out = bytearray()
        s = start
        guard = 0
        while s >= 0 and guard < len(fat) + 2:
            out += data[512 + s * sec_size: 512 + (s + 1) * sec_size]
            s = fat[s] if s < len(fat) else -2
            guard += 1
        return bytes(out)

    directory = read_chain(dir_start)
    root_start = None
    target = None
    for off in range(0, len(directory) - 127, 128):
        name_len = struct.unpack_from("<H", directory, off + 64)[0]
        if name_len < 2:
            continue
        name = directory[off: off + name_len - 2].decode("utf-16-le",
                                                         errors="replace")
        obj_type = directory[off + 66]
        start = struct.unpack_from("<i", directory, off + 116)[0]
        size = struct.unpack_from("<I", directory, off + 120)[0]
        if obj_type == 5:  # root storage
            root_start = start
        if name in want_names and obj_type == 2:
            target = (start, size)
    if target is None:
        raise ValueError("no Workbook stream found")
    start, size = target

    if size >= mini_cutoff:
        return read_chain(start)[:size]

    # stream lives in the mini-FAT inside the root storage
    mini_fat = []
    s = minifat_start
    for _ in range(num_minifat):
        if s < 0:
            break
        mini_fat.extend(struct.unpack_from(f"<{sec_size // 4}i", data,
                                           512 + s * sec_size))
        s = fat[s]
    mini_data = read_chain(root_start)
    out = bytearray()
    ms = start
    guard = 0
    while ms >= 0 and guard < len(mini_fat) + 2:
        out += mini_data[ms * 64: (ms + 1) * 64]
        ms = mini_fat[ms] if ms < len(mini_fat) else -2
        guard += 1
    return bytes(out[:size])


def _decode_rk(rk: int) -> float:
    div100 = rk & 1
    if rk & 2:  # 30-bit signed integer
        v = float(np.int32(rk) >> 2)
    else:  # top 30 bits are the high bits of an IEEE double
        v = struct.unpack("<d", b"\x00\x00\x00\x00" +
                          struct.pack("<I", rk & 0xFFFFFFFC))[0]
    return v / 100.0 if div100 else v


def read_xls_numeric(path: str) -> np.ndarray:
    """Read numeric cells of the first sheet -> dense [rows, cols] float64
    (missing cells NaN), trimmed to the used range."""
    with open(path, "rb") as f:
        data = f.read()
    stream = _read_ole2_stream(data)
    cells = {}
    off = 0
    n = len(stream)
    sheet = 0
    while off + 4 <= n:
        rec, length = struct.unpack_from("<HH", stream, off)
        body = stream[off + 4: off + 4 + length]
        off += 4 + length
        if rec == 0x0809:  # BOF
            if len(body) >= 4:
                doctype = struct.unpack_from("<H", body, 2)[0]
                if doctype == 0x0010:  # worksheet substream
                    sheet += 1
                    if sheet > 1:
                        break
        elif rec == 0x0203 and sheet == 1 and len(body) >= 14:  # NUMBER
            row, col = struct.unpack_from("<HH", body, 0)
            (val,) = struct.unpack_from("<d", body, 6)
            cells[(row, col)] = val
        elif rec == 0x027E and sheet == 1 and len(body) >= 10:  # RK
            row, col = struct.unpack_from("<HH", body, 0)
            (rk,) = struct.unpack_from("<i", body, 6)
            cells[(row, col)] = _decode_rk(rk)
        elif rec == 0x00BD and sheet == 1 and len(body) >= 12:  # MULRK
            row, col_first = struct.unpack_from("<HH", body, 0)
            (col_last,) = struct.unpack_from("<H", body, len(body) - 2)
            k = 4
            for c in range(col_first, col_last + 1):
                (rk,) = struct.unpack_from("<i", body, k + 2)
                cells[(row, c)] = _decode_rk(rk)
                k += 6
        elif rec == 0x000A and sheet >= 1:  # EOF of substream
            if sheet >= 1:
                break
    if not cells:
        return np.zeros((0, 0))
    rmax = max(r for r, _ in cells) + 1
    cmax = max(c for _, c in cells) + 1
    out = np.full((rmax, cmax), np.nan)
    for (r, c), v in cells.items():
        out[r, c] = v
    return out


def load_scan_xls(path: str) -> np.ndarray:
    """XLS scan import: first three numeric columns per row
    (motor_x, motor_y, Distance), rows with any NaN dropped
    (FrmMain.cs:995-1010 cell-read semantics)."""
    grid = read_xls_numeric(path)
    if grid.shape[1] < 3:
        return np.zeros((0, 3))
    rows = grid[:, :3]
    return rows[~np.isnan(rows).any(axis=1)]
