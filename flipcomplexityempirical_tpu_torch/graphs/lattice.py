"""Host-side graph: the numpy fields the board paths read.

The port's copy of ``LatticeGraph`` / ``build_lattice``
(``flipcomplexityempirical_tpu/graphs/lattice.py``), numpy part only: node
labels in index order, the canonical (sorted) edge list, degrees,
populations, planar coordinates, and what the lowering pass
(``lower/stencil.py``) reads besides: the frame mask, wall ids, the
radius-r patch tables and the angle-metric center. The padded neighbor
table and the device view serve the JAX package's general kernel, which
this package has not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np

# Patch bitsets are uint32 words: a patch ball larger than 32 nodes cannot
# be encoded, and such a graph has no local contiguity tables.
MAX_PATCH = 32


@dataclasses.dataclass(frozen=True, eq=False)
class LatticeGraph:
    name: str
    labels: tuple           # node labels, index order
    edges: np.ndarray       # int32[E, 2] canonical (lexicographically sorted)
    deg: np.ndarray         # int32[N]
    pop: np.ndarray         # int32[N] node population weights
    coords: np.ndarray      # float64[N, 2] planar positions
    frame_mask: np.ndarray  # bool[N] the reference's "boundary_node"
    wall_id: np.ndarray     # int8[E] -1 none, 0..3 walls, 4 corner diagonal
    patch_nodes: np.ndarray  # int32[N, P] radius-r ball, neighbors first
    patch_adj: np.ndarray   # uint32[N, P] bitset adjacency within the patch
    patch_size: np.ndarray  # int32[N]
    patch_ok: bool          # False => no patch fits in 32 bits
    center: tuple = (20.0, 20.0)  # angle-metric center

    @property
    def n_nodes(self) -> int:
        return len(self.labels)

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])


def _patch_tables(n: int, adj_idx: list, patch_radius: int):
    """Radius-r balls without the center, neighbors first in edge order,
    as padded node tables with bitset adjacency (JAX ``build_lattice``)."""
    patch_lists = []
    for i in range(n):
        first = [j for (j, _) in adj_idx[i]]
        seen = {i, *first}
        ordered = list(first)
        frontier = first
        for _ in range(patch_radius - 1):
            nxt = []
            for j in frontier:
                for (k2, _) in adj_idx[j]:
                    if k2 not in seen:
                        seen.add(k2)
                        nxt.append(k2)
            ordered.extend(nxt)
            frontier = nxt
        patch_lists.append(ordered)
    p = max((len(pl) for pl in patch_lists), default=0)
    patch_ok = p <= MAX_PATCH
    if not patch_ok:
        p = 1
    patch_nodes = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, p))
    patch_adj = np.zeros((n, p), dtype=np.uint32)
    patch_size = np.zeros(n, dtype=np.int32)
    if patch_ok:
        nbrsets = [set(j for (j, _) in a) for a in adj_idx]
        for i in range(n):
            pl = patch_lists[i]
            patch_size[i] = len(pl)
            pos = {j: s for s, j in enumerate(pl)}
            for s, j in enumerate(pl):
                patch_nodes[i, s] = j
                word = 0
                for k2 in nbrsets[j]:
                    t = pos.get(k2)
                    if t is not None:
                        word |= 1 << t
                patch_adj[i, s] = word
    return patch_nodes, patch_adj, patch_size, patch_ok


def build_lattice(adjacency: dict, *, name: str = "graph",
                  coords: Optional[dict] = None, pop: Optional[dict] = None,
                  frame: Optional[Callable[[Any], bool]] = None,
                  wall: Optional[Callable[[Any, Any], int]] = None,
                  center: tuple = (20.0, 20.0),
                  node_order: Optional[Sequence] = None,
                  patch_radius: int = 2) -> LatticeGraph:
    """Build a LatticeGraph from an adjacency dict {label: iterable}, with
    the reference package's canonical order: nodes sorted by label (unless
    ``node_order`` is given), edges as sorted (min, max) index pairs.
    Every derived table depends on the edge set only, not on the order in
    which ``adjacency`` lists it."""
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
    e = edges.shape[0]
    adj_idx: list = [[] for _ in range(n)]
    for ei in range(e):
        a, b = int(edges[ei, 0]), int(edges[ei, 1])
        adj_idx[a].append((b, ei))
        adj_idx[b].append((a, ei))
    deg = np.array([len(a) for a in adj_idx], dtype=np.int32)
    patch_nodes, patch_adj, patch_size, patch_ok = _patch_tables(
        n, adj_idx, patch_radius)

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

    frame_mask = np.zeros(n, dtype=bool)
    if frame is not None:
        for lab in labels:
            frame_mask[index[lab]] = bool(frame(lab))

    wall_arr = np.full(e, -1, dtype=np.int8)
    if wall is not None:
        for ei in range(e):
            wall_arr[ei] = wall(labels[edges[ei, 0]], labels[edges[ei, 1]])

    return LatticeGraph(name=name, labels=tuple(labels), edges=edges,
                        deg=deg, pop=pop_arr, coords=coords_arr,
                        frame_mask=frame_mask, wall_id=wall_arr,
                        patch_nodes=patch_nodes, patch_adj=patch_adj,
                        patch_size=patch_size, patch_ok=patch_ok,
                        center=center)
