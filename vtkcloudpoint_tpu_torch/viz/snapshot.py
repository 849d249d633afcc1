"""Headless scene snapshots: the engine's screenshot / 2D-view / legend
analog.

The reference renders through VTK and offers (a) a screenshot capture
(Tools.Screen, Tools.cs:32-54), (b) 2D motor-space views (Show2DPoints,
FrmMain.cs:542-674), and (c) a legend panel of cluster colors/names
(isShowLegend, FrmMain.cs:1981-2102). A headless TPU engine replaces the
interactive window with deterministic raster snapshots: an orthographic
point rasterizer -> RGB array -> PNG (pure stdlib zlib encoder, no imaging
dependency), plus a structured legend (id, color, count, name) written as a
sidecar text file and as swatch rows in the image margin.

Everything here is host-side NumPy by design -- visualization is an IO
boundary, not a device computation.

The port's own copy of vtkcloudpoint_tpu/viz/snapshot.py (numpy and the
stdlib only), so the port never imports the JAX package.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

# distinct, stable cluster palette (loops after 20); noise id 0 is gray,
# mirroring the reference's distinct-color-per-cluster legend scheme
_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
], np.uint8)
NOISE_COLOR = np.array([90, 90, 90], np.uint8)
BG_COLOR = np.array([0, 0, 0], np.uint8)


def label_colors(labels: np.ndarray) -> np.ndarray:
    """RGB per point from cluster id (0 = noise -> gray)."""
    labels = np.asarray(labels)
    c = _PALETTE[(labels - 1) % len(_PALETTE)]
    c[labels <= 0] = NOISE_COLOR
    return c


def write_png(path: str, rgb: np.ndarray) -> str:
    """Minimal PNG encoder (8-bit RGB, one IDAT). Pure stdlib."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


def rasterize_points(xy, colors, width: int = 800, height: int = 600,
                     bounds=None, point_size: int = 1,
                     background=BG_COLOR) -> np.ndarray:
    """Orthographic scatter of 2D points into an RGB image.

    xy: [N, 2]; colors: [N, 3] uint8. Later points overdraw earlier ones
    (deterministic). bounds=(xmin, ymin, xmax, ymax) or auto from data.
    """
    xy = np.asarray(xy, np.float64)
    colors = np.asarray(colors, np.uint8)
    img = np.tile(np.asarray(background, np.uint8), (height, width, 1))
    if len(xy) == 0:
        return img
    if bounds is None:
        lo = xy.min(0)
        hi = xy.max(0)
        span = np.maximum(hi - lo, 1e-12)
        lo = lo - 0.02 * span
        hi = hi + 0.02 * span
    else:
        lo = np.array(bounds[:2], np.float64)
        hi = np.array(bounds[2:], np.float64)
    span = np.maximum(hi - lo, 1e-12)
    px = ((xy[:, 0] - lo[0]) / span[0] * (width - 1)).astype(np.int64)
    py = ((hi[1] - xy[:, 1]) / span[1] * (height - 1)).astype(np.int64)
    ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    r = max(int(point_size) - 1, 0)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            qx = np.clip(px[ok] + dx, 0, width - 1)
            qy = np.clip(py[ok] + dy, 0, height - 1)
            img[qy, qx] = colors[ok]
    return img


def legend_entries(labels, counts=None, names=None):
    """Structured legend: [(cluster_id, (r, g, b), count, name), ...] for
    every id present (noise excluded), ascending -- the headless analog of
    the reference's legend panel (FrmMain.cs:1981-2102)."""
    labels = np.asarray(labels)
    ids = np.unique(labels[labels > 0])
    out = []
    for i in ids:
        color = tuple(int(v) for v in _PALETTE[(int(i) - 1) % len(_PALETTE)])
        count = (int(counts[int(i)]) if counts is not None
                 else int((labels == i).sum()))
        name = names.get(int(i)) if names else f"cluster {int(i)}"
        out.append((int(i), color, count, name))
    return out


def draw_legend(img: np.ndarray, entries, swatch: int = 10,
                margin: int = 4) -> np.ndarray:
    """Paint legend swatch rows into the top-left margin (no text -- the
    sidecar file carries names/counts)."""
    img = img.copy()
    y = margin
    for _id, color, _count, _name in entries:
        if y + swatch >= img.shape[0]:
            break
        img[y:y + swatch, margin:margin + swatch] = np.asarray(
            color, np.uint8)
        y += swatch + margin // 2 + 2
    return img


def save_legend(path: str, entries) -> str:
    with open(path, "w") as f:
        f.write("id\tr\tg\tb\tcount\tname\n")
        for i, (r, g, b), count, name in entries:
            f.write(f"{i}\t{r}\t{g}\t{b}\t{count}\t{name}\n")
    return path


def snapshot_clusters(path: str, xyz=None, motor=None, labels=None,
                      valid=None, view: str = "xy", width: int = 800,
                      height: int = 600, point_size: int = 1,
                      counts=None, names=None, with_legend: bool = True):
    """One-call scene snapshot: pick the view plane (xy = Cartesian, motor =
    2D motor space, per Show2DPoints), color by cluster id, draw the legend,
    write <path>.png (+ <path>.legend.txt). Returns the png path."""
    labels = np.asarray(labels)
    if view == "motor":
        xy = np.asarray(motor)[:, :2]
    else:
        xy = np.asarray(xyz)[:, :2]
    if valid is not None:
        m = np.asarray(valid)
        xy = xy[m]
        labels = labels[m]
    img = rasterize_points(xy, label_colors(labels), width, height,
                           point_size=point_size)
    entries = legend_entries(labels, counts=counts, names=names)
    if with_legend:
        img = draw_legend(img, entries)
    png = path if path.endswith(".png") else path + ".png"
    write_png(png, img)
    save_legend(png[:-4] + ".legend.txt", entries)
    return png
