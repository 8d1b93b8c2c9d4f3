"""The per-config artifacts, with the reference's file names.

Port of ``flipcomplexityempirical_tpu/experiments/artifacts.py`` for every
family: for sec11 and the Frankengraph, per config {tag}start / edges /
end / end2 / wca / wca2 / slope / angle / flip / flip2 / logflip /
logflip2 .png and {tag}wait.txt (grid_chain_sec11.py:321-324,410-411,
427-528; Frankenstein_chain.py:349-352,438-439,455-556); for the kpair,
tri, hex and temper families their subsets of ``FAMILY_ARTIFACTS``
(``render_generic``; kpair's imshow maps on the grid's bounding box), with
the temper family's per-rung plot (``render_rungs``); for the dual family
its node and edge maps at the precincts' centroids (the driver writes
its compactness.json and partisan.json, and temper's swapstats.json).

The images are drawn with the package's own PNG writer (``png.py``), not
matplotlib, so they show what the reference's show without its pixels:

- node maps (start, end, wca, flip, logflip): one square block per node
  at its integer label, x to the right and y up, coloured by matplotlib's
  ``tab20`` (the district maps) or ``jet`` after min-max normalisation;
- ``edges.png``: a segment between the centres of each edge's nodes,
  coloured by its cut count under ``jet``, the nodes as small blocks in
  ``jet``'s lowest colour (the reference draws them with colour 0);
- the ``*2.png`` images: the reference's ``imshow`` array
  (``imshow_grid``: sec11 ``A2[40, 40]`` at ``[x, y]``, the Frankengraph
  ``A2[20, 40]`` at ``[x, y + 19]``, zero where no node lies) as blocks
  of ``PITCH`` pixels, row i down and column j right, under ``jet``
  normalised over the whole array, with a colour bar (maximum on top);
- ``slope.png`` / ``angle.png``: the series as a line inside an axes box,
  the x range the series' index with 5 % margins, the y range the finite
  values' with 5 % margins, or 0 to 6.3 for the angle as in the
  reference; non-finite values break the line.

No title or tick text is drawn: there is no font renderer, and the title
is in the file name. ``wait.txt`` is written exactly as the reference
writes it.
"""

from __future__ import annotations

import os

import numpy as np

from ..graphs.lattice import LatticeGraph
from . import png

PITCH = 12            # pixels per label unit and per imshow cell
MARGIN = 16
NODE_HALF = 5         # a node block is 11 pixels wide
EDGE_HALF = 1         # an edge is 3 pixels wide
BAR_GAP, BAR_WIDTH = 10, 12
LINE_SIZE = (480, 640)                 # (height, width) of a line plot
LINE_BOX = (58, 80, 427, 576)          # top, left, bottom, right
ANGLE_YLIM = (0.0, 6.3)


def node_pixels(graph: LatticeGraph, pos=None):
    """(rows, cols, (height, width)): each node's block centre in a node
    map and the image's size. Labels are integer (x, y) pairs, or
    ``pos`` gives each node's planar position (the dual graphs'
    centroids), rounded to the nearest pixel at ``PITCH`` a unit."""
    if pos is not None:
        p = np.asarray(pos, np.float64)
        x = np.rint((p[:, 0] - p[:, 0].min()) * PITCH).astype(np.int64)
        y = np.rint((p[:, 1] - p[:, 1].min()) * PITCH).astype(np.int64)
        base = MARGIN + PITCH // 2
        return (base + y.max() - y, base + x,
                (2 * MARGIN + y.max() + PITCH, 2 * MARGIN + x.max() + PITCH))
    lab = np.asarray(graph.labels, np.int64)
    x, y = lab[:, 0], lab[:, 1]
    base = MARGIN + PITCH // 2
    rows = base + (y.max() - y) * PITCH
    cols = base + (x - x.min()) * PITCH
    size = (2 * MARGIN + (y.max() - y.min() + 1) * PITCH,
            2 * MARGIN + (x.max() - x.min() + 1) * PITCH)
    return rows, cols, size


def node_image(graph: LatticeGraph, values, cmap: str,
               pos=None) -> np.ndarray:
    rows, cols, (h, w) = node_pixels(graph, pos)
    img = png.blank(h, w)
    png.fill_blocks(img, rows, cols, NODE_HALF, png.colorize(values, cmap))
    return img


def edge_image(graph: LatticeGraph, edge_values, pos=None) -> np.ndarray:
    rows, cols, (h, w) = node_pixels(graph, pos)
    img = png.blank(h, w)
    u, v = graph.edges[:, 0], graph.edges[:, 1]
    png.draw_segments(img, rows[u], cols[u], rows[v], cols[v],
                      png.colorize(edge_values, "jet"), EDGE_HALF)
    png.fill_blocks(img, rows, cols, EDGE_HALF,
                    png.colorize(np.zeros(graph.n_nodes), "jet"))
    return img


def imshow_grid(graph: LatticeGraph, family: str, values) -> np.ndarray:
    """The reference's imshow array: sec11 A2[40, 40] with A2[x, y]
    (grid_chain_sec11.py:440-443), the Frankengraph A2[20, 40] with
    A2[x, y + 19] (Frankenstein_chain.py:468-471); another family with
    integer-pair labels (kpair's rook grid) the labels' bounding box, as
    the JAX package draws it."""
    if family == "frank":
        a2 = np.zeros([20, 40])
        xoff, yoff = 0, 19
    elif family == "sec11":
        a2 = np.zeros([40, 40])
        xoff, yoff = 0, 0
    else:
        xs = [lab[0] for lab in graph.labels]
        ys = [lab[1] for lab in graph.labels]
        a2 = np.zeros([max(xs) - min(xs) + 1, max(ys) - min(ys) + 1])
        xoff, yoff = -min(xs), -min(ys)
    for i, (x, y) in enumerate(graph.labels):
        a2[x + xoff, y + yoff] = values[i]
    return a2


def cell_pixel(i: int, j: int):
    """The (row, col) of the centre of imshow cell [i, j]."""
    return MARGIN + i * PITCH + PITCH // 2, MARGIN + j * PITCH + PITCH // 2


def grid_image(a2: np.ndarray) -> np.ndarray:
    rows, cols = a2.shape
    h, w = rows * PITCH, cols * PITCH
    img = png.blank(2 * MARGIN + h, 2 * MARGIN + w + BAR_GAP + BAR_WIDTH)
    cells = png.colorize(a2, "jet")
    img[MARGIN:MARGIN + h, MARGIN:MARGIN + w] = np.repeat(
        np.repeat(cells, PITCH, axis=0), PITCH, axis=1)
    bar_left = MARGIN + w + BAR_GAP
    bar = png.to_uint8(png.cmap_float("jet", np.linspace(1.0, 0.0, h)))
    img[MARGIN:MARGIN + h, bar_left:bar_left + BAR_WIDTH] = bar[:, None]
    png.draw_box(img, MARGIN - 1, MARGIN - 1, MARGIN + h, MARGIN + w)
    png.draw_box(img, MARGIN - 1, bar_left - 1, MARGIN + h,
                 bar_left + BAR_WIDTH)
    return img


def series_pixels(series, ylim=None):
    """(px, py): pixel column and row of each point of a line plot, NaN
    where the value is not finite."""
    y = np.asarray(series, np.float64)
    n = y.size
    top, left, bottom, right = LINE_BOX
    x0, x1 = (-0.05 * (n - 1), 1.05 * (n - 1)) if n > 1 else (-0.5, 0.5)
    if ylim is None:
        fin = y[np.isfinite(y)]
        lo, hi = (float(fin.min()), float(fin.max())) if fin.size else (0, 1)
        pad = 0.05 * (hi - lo) if hi > lo else max(abs(lo) * 0.05, 0.05)
        ylim = (lo - pad, hi + pad)
    y0, y1 = ylim
    px = left + (np.arange(n) - x0) / (x1 - x0) * (right - left)
    py = bottom - (y - y0) / (y1 - y0) * (bottom - top)
    py = np.where(np.isfinite(y), np.clip(py, top, bottom), np.nan)
    return px, py


def line_image(series, ylim=None) -> np.ndarray:
    img = png.blank(*LINE_SIZE)
    png.draw_series(img, *series_pixels(series, ylim))
    png.draw_box(img, *LINE_BOX)
    return img


def render_start(graph, outdir, tag, start_signed, pos=None) -> None:
    os.makedirs(outdir, exist_ok=True)
    png.write_png(os.path.join(outdir, tag + "start.png"),
                  node_image(graph, start_signed, "tab20", pos))


def render_all(graph: LatticeGraph, family: str, outdir: str, tag: str, *,
               end_signed, cut_times, part_sum, num_flips, slopes, angles,
               waits_sum) -> None:
    """Render the 12 post-run artifacts and wait.txt (start.png is
    rendered before the run, as the reference does at
    grid_chain_sec11.py:321-324)."""
    os.makedirs(outdir, exist_ok=True)
    j = lambda kind: os.path.join(outdir, tag + kind)

    with open(j("wait.txt"), "w") as f:
        f.write(str(int(round(waits_sum))))

    lognum = np.log(np.asarray(num_flips, np.float64) + 1.0)
    png.write_png(j("edges.png"), edge_image(graph, cut_times))
    png.write_png(j("end.png"), node_image(graph, end_signed, "tab20"))
    for kind, values in (("wca", part_sum), ("flip", num_flips),
                         ("logflip", lognum)):
        png.write_png(j(kind + ".png"), node_image(graph, values, "jet"))
    for kind, values in (("end2", end_signed), ("wca2", part_sum),
                         ("flip2", num_flips), ("logflip2", lognum)):
        png.write_png(j(kind + ".png"),
                      grid_image(imshow_grid(graph, family, values)))
    png.write_png(j("slope.png"), line_image(slopes))
    png.write_png(j("angle.png"), line_image(angles, ANGLE_YLIM))


ARTIFACT_KINDS = ["start.png", "edges.png", "end.png", "end2.png",
                  "wca.png", "wca2.png", "slope.png", "angle.png",
                  "flip.png", "flip2.png", "logflip.png", "logflip2.png",
                  "wait.txt"]

# Per-family artifact manifests, the JAX package's: sec11/frank keep the
# reference's 13-artifact set; the other families emit the subset their
# walk defines plus family-specific diagnostics.
FAMILY_ARTIFACTS = {
    "sec11": ARTIFACT_KINDS,
    "frank": ARTIFACT_KINDS,
    "kpair": ["start.png", "edges.png", "end.png", "end2.png",
              "flip.png", "flip2.png", "logflip.png", "logflip2.png",
              "wait.txt"],
    "tri": ["start.png", "edges.png", "end.png", "wca.png", "flip.png",
            "logflip.png", "wait.txt"],
    "hex": ["start.png", "edges.png", "end.png", "wca.png", "flip.png",
            "logflip.png", "wait.txt"],
    "temper": ["start.png", "edges.png", "end.png", "rungs.png",
               "swapstats.json", "wait.txt"],
    "dual": ["start.png", "edges.png", "end.png", "flip.png",
             "logflip.png", "compactness.json", "partisan.json",
             "wait.txt"],
}


def artifact_kinds(family: str):
    return FAMILY_ARTIFACTS[family]


def render_generic(graph: LatticeGraph, outdir: str, tag: str, *, kinds,
                   end_signed, cut_times, num_flips, waits_sum,
                   part_sum=None, pos=None, family: str = "") -> None:
    """The widened families' post-run artifacts: the node maps, the edge
    map, the imshow maps (kpair's ``*2.png``, on ``family``'s layout) and
    wait.txt among ``kinds`` (start.png is rendered before the run; the
    dual family's json files and the temper family's rungs.png and
    swapstats.json are the driver's; ``pos`` places the nodes)."""
    os.makedirs(outdir, exist_ok=True)
    j = lambda kind: os.path.join(outdir, tag + kind)
    lognum = np.log(np.asarray(num_flips, np.float64) + 1.0)
    maps = {"end.png": (end_signed, "tab20"), "wca.png": (part_sum, "jet"),
            "flip.png": (num_flips, "jet"), "logflip.png": (lognum, "jet")}
    grids = {"end2.png": end_signed, "wca2.png": part_sum,
             "flip2.png": num_flips, "logflip2.png": lognum}
    for kind in kinds:
        if kind in ("start.png", "compactness.json", "partisan.json",
                    "rungs.png", "swapstats.json"):
            continue
        if kind == "wait.txt":
            with open(j(kind), "w") as f:
                f.write(str(int(round(waits_sum))))
        elif kind == "edges.png":
            png.write_png(j(kind), edge_image(graph, cut_times, pos))
        elif kind in maps:
            values, cmap = maps[kind]
            png.write_png(j(kind), node_image(graph, values, cmap, pos))
        elif kind in grids:
            png.write_png(j(kind), grid_image(
                imshow_grid(graph, family, grids[kind])))
        else:
            raise ValueError(f"artifact {kind!r} is not ported here")


def rungs_image(rung_cut, betas) -> np.ndarray:
    """The temper family's per-rung |cut| trajectories of ladder 0 in one
    line plot: one series a rung, coloured along ``jet`` from the first
    rung to the last, on the y range of all of them with 5 % margins."""
    series = np.asarray(rung_cut, np.float64)
    img = png.blank(*LINE_SIZE)
    fin = series[np.isfinite(series)]
    lo, hi = (float(fin.min()), float(fin.max())) if fin.size else (0, 1)
    pad = 0.05 * (hi - lo) if hi > lo else max(abs(lo) * 0.05, 0.05)
    n = len(betas)
    colors = png.to_uint8(png.cmap_float(
        "jet", np.arange(n) / max(n - 1, 1)))
    for r in range(n):
        png.draw_series(img, *series_pixels(series[r], (lo - pad, hi + pad)),
                        color=colors[r])
    png.draw_box(img, *LINE_BOX)
    return img


def render_rungs(path: str, rung_cut, betas) -> None:
    """temper: the per-rung reconstructed cut-count trajectories of ladder
    0 (after a swap the physical rung hops between chains, which the
    per-chain plots cannot show)."""
    png.write_png(path, rungs_image(rung_cut, betas))
