"""Host-side graph: the numpy fields the rook-grid board path reads.

The port's copy of ``LatticeGraph`` / ``build_lattice``
(``flipcomplexityempirical_tpu/graphs/lattice.py``), cut to what the board
path needs: node labels in index order, the canonical (sorted) edge list,
degrees, populations and planar coordinates. The padded neighbor table,
patch bitsets and wall ids serve the general kernel and the lowered
stencil, which this package has not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class LatticeGraph:
    name: str
    labels: tuple           # node labels, index order
    edges: np.ndarray       # int32[E, 2] canonical (lexicographically sorted)
    deg: np.ndarray         # int32[N]
    pop: np.ndarray         # int32[N] node population weights
    coords: np.ndarray      # float64[N, 2] planar positions

    @property
    def n_nodes(self) -> int:
        return len(self.labels)

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])


def build_lattice(adjacency: dict, *, name: str = "graph",
                  coords: Optional[dict] = None, pop: Optional[dict] = None,
                  node_order: Optional[Sequence] = None) -> LatticeGraph:
    """Build a LatticeGraph from an adjacency dict {label: iterable}, with
    the reference package's canonical order: nodes sorted by label (unless
    ``node_order`` is given), edges as sorted (min, max) index pairs."""
    labels = list(node_order) if node_order is not None else sorted(adjacency)
    index = {lab: i for i, lab in enumerate(labels)}
    edge_set = set()
    for u, nbrs in adjacency.items():
        iu = index[u]
        for v in nbrs:
            iv = index[v]
            if iu != iv:
                edge_set.add((min(iu, iv), max(iu, iv)))
    edges = np.array(sorted(edge_set), dtype=np.int32).reshape(-1, 2)
    n = len(labels)
    deg = np.bincount(edges.ravel(), minlength=n).astype(np.int32)

    coords_arr = np.zeros((n, 2), dtype=np.float64)
    if coords is not None:
        for lab, xy in coords.items():
            coords_arr[index[lab]] = xy
    else:
        for lab in labels:
            if isinstance(lab, tuple) and len(lab) == 2:
                coords_arr[index[lab]] = lab

    pop_arr = np.ones(n, dtype=np.int32)
    if pop is not None:
        for lab, v in pop.items():
            pop_arr[index[lab]] = v
    return LatticeGraph(name=name, labels=tuple(labels), edges=edges,
                        deg=deg, pop=pop_arr, coords=coords_arr)
