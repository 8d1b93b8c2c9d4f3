"""Lattice builders and starting plans of the rook-grid board path.

The port's copies of ``square_grid`` (rook adjacency only) and
``stripes_plan`` from ``flipcomplexityempirical_tpu/graphs/builders.py``.
"""

from __future__ import annotations

import numpy as np

from .lattice import LatticeGraph, build_lattice


def square_grid(nx_: int, ny_: int | None = None, *,
                name: str | None = None) -> LatticeGraph:
    """Rook-adjacency nx_ x ny_ grid; node (x, y) has flat index x*ny_ + y."""
    ny_ = nx_ if ny_ is None else ny_
    nodes = [(x, y) for x in range(nx_) for y in range(ny_)]
    adjacency = {nd: [] for nd in nodes}
    for (x, y) in nodes:
        for (dx, dy) in ((1, 0), (0, 1)):
            m = (x + dx, y + dy)
            if m[0] < nx_ and m[1] < ny_:
                adjacency[(x, y)].append(m)
                adjacency[m].append((x, y))
    return build_lattice(adjacency, name=name or f"grid{nx_}x{ny_}")


def stripes_plan(graph: LatticeGraph, k: int, axis: int = 0) -> np.ndarray:
    """k vertical (axis=0) or horizontal (axis=1) bands of near-equal
    population."""
    coords = graph.coords[:, axis]
    order = np.argsort(coords, kind="stable")
    csum = np.cumsum(graph.pop[order])
    total = csum[-1]
    out = np.empty(graph.n_nodes, dtype=np.int8)
    bounds = total * (np.arange(1, k + 1) / k)
    dist = np.searchsorted(bounds, csum, side="left").clip(0, k - 1)
    out[order] = dist.astype(np.int8)
    return out
