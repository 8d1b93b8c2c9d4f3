"""A small PNG writer and the raster pieces the experiment artifacts use.

numpy, ``zlib`` and ``struct`` only: the card's machine has no plotting
library, and the sweep's skip-if-done resume needs every artifact file
written where the chains ran. Images are (H, W, 3) uint8 RGB arrays.

The colour maps are matplotlib's: ``jet``, a piecewise-linear segment
table sampled into 256 entries, and ``tab20``, a list of 20 colours; a
value in [0, 1] picks entry ``min(floor(x * N), N - 1)``, as matplotlib's
colormap call does.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# matplotlib's _jet_data: (x, y) breakpoints per channel
_JET_SEGMENTS = (
    ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
    ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0),
     (1.0, 0.0)),
    ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)),
)
_TAB20_HEX = ("1f77b4", "aec7e8", "ff7f0e", "ffbb78", "2ca02c", "98df8a",
              "d62728", "ff9896", "9467bd", "c5b0d5", "8c564b", "c49c94",
              "e377c2", "f7b6d2", "7f7f7f", "c7c7c7", "bcbd22", "dbdb8d",
              "17becf", "9edae5")


def _jet_table(n: int = 256) -> np.ndarray:
    x = np.linspace(0.0, 1.0, n)
    return np.stack([np.interp(x, [p[0] for p in seg], [p[1] for p in seg])
                     for seg in _JET_SEGMENTS], axis=1)


CMAPS = {
    "jet": _jet_table(),
    "tab20": np.array([[int(h[i:i + 2], 16) / 255.0 for i in (0, 2, 4)]
                       for h in _TAB20_HEX]),
}
WHITE = np.array([255, 255, 255], np.uint8)
BLACK = np.array([0, 0, 0], np.uint8)
LINE_BLUE = np.array([0x1F, 0x77, 0xB4], np.uint8)   # matplotlib's C0


def cmap_float(name: str, x) -> np.ndarray:
    """RGB floats in [0, 1] of values ``x`` in [0, 1] under a colour map."""
    table = CMAPS[name]
    n = table.shape[0]
    idx = np.clip(np.floor(np.asarray(x, np.float64) * n), 0, n - 1)
    return table[idx.astype(np.int64)]


def normalize(values) -> np.ndarray:
    """Min-max normalisation to [0, 1]; all zeros when every value is
    equal (matplotlib's ``Normalize`` with vmin == vmax)."""
    v = np.asarray(values, np.float64)
    lo, hi = v.min(), v.max()
    if hi > lo:
        return (v - lo) / (hi - lo)
    return np.zeros_like(v)


def colorize(values, cmap: str) -> np.ndarray:
    """(..., 3) uint8 colours of ``values`` under ``cmap`` after min-max
    normalisation."""
    return to_uint8(cmap_float(cmap, normalize(values)))


def to_uint8(rgb) -> np.ndarray:
    return np.round(np.asarray(rgb) * 255.0).astype(np.uint8)


def blank(h: int, w: int) -> np.ndarray:
    img = np.empty((h, w, 3), np.uint8)
    img[...] = WHITE
    return img


def fill_blocks(img, rows, cols, half: int, colors) -> None:
    """Squares of side ``2 * half + 1`` centred at (rows[i], cols[i]) in
    colour colors[i], drawn in order."""
    d = np.arange(-half, half + 1)
    rr = (np.asarray(rows)[:, None, None] + d[None, :, None])
    cc = (np.asarray(cols)[:, None, None] + d[None, None, :])
    rr, cc = np.broadcast_arrays(rr, cc)
    col = np.broadcast_to(np.asarray(colors)[:, None, None, :],
                          rr.shape + (3,))
    img[rr.reshape(-1), cc.reshape(-1)] = col.reshape(-1, 3)


def draw_segments(img, r0, c0, r1, c1, colors, half: int = 1) -> None:
    """Straight segments from (r0, c0) to (r1, c1), ``2 * half + 1``
    pixels thick, each in its colour, drawn in order."""
    r0, c0, r1, c1 = (np.asarray(a, np.float64) for a in (r0, c0, r1, c1))
    steps = int(np.ceil(np.max(np.maximum(np.abs(r1 - r0),
                                          np.abs(c1 - c0)), initial=0))) + 1
    t = np.linspace(0.0, 1.0, steps)[None, :]
    rr = np.rint(r0[:, None] + (r1 - r0)[:, None] * t).astype(np.int64)
    cc = np.rint(c0[:, None] + (c1 - c0)[:, None] * t).astype(np.int64)
    cols = np.repeat(np.asarray(colors), steps, axis=0)
    fill_blocks(img, rr.reshape(-1), cc.reshape(-1), half, cols)


def draw_box(img, top: int, left: int, bottom: int, right: int) -> None:
    """A one-pixel black rectangle outline."""
    img[top, left:right + 1] = BLACK
    img[bottom, left:right + 1] = BLACK
    img[top:bottom + 1, left] = BLACK
    img[top:bottom + 1, right] = BLACK


def draw_series(img, px, py, color=LINE_BLUE) -> None:
    """A polyline through pixel points (px[i] columns, py[i] rows, float,
    NaN where the series has no finite value), two pixels thick. Each
    pixel column is filled between the least and the largest row any
    segment reaches in it, so a series of far more points than columns
    costs one pass (min-max decimation) and keeps its extremes."""
    px = np.asarray(px, np.float64)
    py = np.asarray(py, np.float64)
    ok = np.isfinite(px) & np.isfinite(py)
    lo = np.full(img.shape[1], np.inf)
    hi = np.full(img.shape[1], -np.inf)
    alone = ok.copy()
    seg = ok[:-1] & ok[1:]
    alone[:-1] &= ~seg
    alone[1:] &= ~seg
    if seg.any():
        a, b = np.nonzero(seg)[0], np.nonzero(seg)[0] + 1
        ca, cb = np.rint(px[a]).astype(np.int64), np.rint(px[b]).astype(
            np.int64)
        n_cols = np.abs(cb - ca) + 1
        rep = np.repeat(np.arange(a.size), n_cols)
        off = np.arange(rep.size) - np.repeat(np.cumsum(n_cols) - n_cols,
                                              n_cols)
        step = np.sign(cb - ca)[rep]
        col = ca[rep] + step * off
        # the segment's rows at the two edges of this column
        span = np.where(cb == ca, 1.0, np.abs(px[b] - px[a]))[rep]
        f0 = np.clip((np.abs(col - px[a][rep]) - 0.5) / span, 0.0, 1.0)
        f1 = np.clip((np.abs(col - px[a][rep]) + 0.5) / span, 0.0, 1.0)
        f0 = np.where(cb[rep] == ca[rep], 0.0, f0)
        f1 = np.where(cb[rep] == ca[rep], 1.0, f1)
        y0 = py[a][rep] + (py[b] - py[a])[rep] * f0
        y1 = py[a][rep] + (py[b] - py[a])[rep] * f1
        np.minimum.at(lo, col, np.minimum(y0, y1))
        np.maximum.at(hi, col, np.maximum(y0, y1))
    if alone.any():
        c = np.rint(px[alone]).astype(np.int64)
        np.minimum.at(lo, c, py[alone])
        np.maximum.at(hi, c, py[alone])
    for c in np.nonzero(np.isfinite(lo))[0]:
        r0 = max(int(np.floor(lo[c])), 0)
        r1 = min(int(np.ceil(hi[c])), img.shape[0] - 1)
        img[r0:r1 + 1, c:c + 2] = color


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (filter 0 on
    every row), through a temporary file and a rename, so a file that
    exists under ``path`` is whole."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
