"""Host-side graph and its device view.

The port's copy of ``LatticeGraph`` / ``build_lattice`` / ``DeviceGraph``
(``flipcomplexityempirical_tpu/graphs/lattice.py``): node labels in index
order, the canonical (sorted) edge list, the padded neighbor table
(pad = the node itself), degrees, populations, planar coordinates, the
frame mask, wall ids, boundary-length weights, the radius-r patch tables
and the angle-metric center. ``LatticeGraph.device(device)`` is the
general path's static view: the same tables as tensors on a device,
index tables as int64 and the uint32 patch bitsets held in int64 (the
convention of ``rng.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

# Patch bitsets are uint32 words: a patch ball larger than 32 nodes cannot
# be encoded, and such a graph has no local contiguity tables.
MAX_PATCH = 32


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceGraph:
    """The static view of a graph on one device: N nodes, E edges, D max
    degree, P max patch size. Everything a general-path kernel reads."""

    edges: torch.Tensor        # int64 (E, 2)
    nbr: torch.Tensor          # int64 (N, D), pad = self
    nbr_mask: torch.Tensor     # bool (N, D)
    nbr_edge: torch.Tensor     # int64 (N, D), pad = 0 (mask before use)
    deg: torch.Tensor          # int64 (N,)
    pop: torch.Tensor          # int32 (N,)
    coords: torch.Tensor       # float32 (N, 2)
    frame_mask: torch.Tensor   # bool (N,)
    frame_idx: torch.Tensor    # int64 (F,)
    wall_id: torch.Tensor      # int8 (E,)
    edge_len: torch.Tensor     # float32 (E,)
    patch_nodes: torch.Tensor  # int64 (N, P), pad = self
    patch_adj: torch.Tensor    # int64 (N, P), uint32 bitsets
    patch_size: torch.Tensor   # int64 (N,)
    center: torch.Tensor       # float32 (2,)
    patch_ok: bool = True      # False => no patch fits in 32 bits

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    @property
    def n_nodes(self) -> int:
        return int(self.nbr.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def max_deg(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def max_patch(self) -> int:
        return int(self.patch_nodes.shape[1])


@dataclasses.dataclass(frozen=True, eq=False)
class LatticeGraph:
    name: str
    labels: tuple           # node labels, index order
    edges: np.ndarray       # int32[E, 2] canonical (lexicographically sorted)
    nbr: np.ndarray         # int32[N, D], pad = self
    nbr_mask: np.ndarray    # bool[N, D]
    nbr_edge: np.ndarray    # int32[N, D], pad 0
    deg: np.ndarray         # int32[N]
    pop: np.ndarray         # int32[N] node population weights
    coords: np.ndarray      # float64[N, 2] planar positions
    frame_mask: np.ndarray  # bool[N] the reference's "boundary_node"
    wall_id: np.ndarray     # int8[E] -1 none, 0..3 walls, 4 corner diagonal
    edge_len: np.ndarray    # f32[E] boundary-length weights (1 = count)
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

    @property
    def max_deg(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def index(self) -> dict:
        """label -> node index (built once)."""
        idx = self.__dict__.get("_index")
        if idx is None:
            idx = {lab: i for i, lab in enumerate(self.labels)}
            object.__setattr__(self, "_index", idx)
        return idx

    def device(self, device="cuda") -> DeviceGraph:
        """The tables as tensors on ``device`` (one view a device, built
        once)."""
        dev = resolve_device(device)
        views = self.__dict__.setdefault("_device", {})
        dg = views.get(str(dev))
        if dg is None:
            def t(x, dtype):
                return torch.as_tensor(np.asarray(x)).to(device=dev,
                                                         dtype=dtype)
            i64 = torch.int64
            dg = DeviceGraph(
                edges=t(self.edges, i64), nbr=t(self.nbr, i64),
                nbr_mask=t(self.nbr_mask, torch.bool),
                nbr_edge=t(self.nbr_edge, i64), deg=t(self.deg, i64),
                pop=t(self.pop, torch.int32),
                coords=t(self.coords, torch.float32),
                frame_mask=t(self.frame_mask, torch.bool),
                frame_idx=t(np.nonzero(self.frame_mask)[0], i64),
                wall_id=t(self.wall_id, torch.int8),
                edge_len=t(self.edge_len, torch.float32),
                patch_nodes=t(self.patch_nodes, i64),
                patch_adj=t(self.patch_adj.astype(np.int64), i64),
                patch_size=t(self.patch_size, i64),
                center=t(np.asarray(self.center, np.float64),
                         torch.float32),
                patch_ok=bool(self.patch_ok))
            views[str(dev)] = dg
        return dg


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
    d = int(deg.max()) if n else 0
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, d))
    nbr_mask = np.zeros((n, d), dtype=bool)
    nbr_edge = np.zeros((n, d), dtype=np.int32)
    for i in range(n):
        for s, (j, ei) in enumerate(adj_idx[i]):
            nbr[i, s] = j
            nbr_mask[i, s] = True
            nbr_edge[i, s] = ei
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
                        nbr=nbr, nbr_mask=nbr_mask, nbr_edge=nbr_edge,
                        deg=deg, pop=pop_arr, coords=coords_arr,
                        frame_mask=frame_mask, wall_id=wall_arr,
                        edge_len=np.ones(e, dtype=np.float32),
                        patch_nodes=patch_nodes, patch_adj=patch_adj,
                        patch_size=patch_size, patch_ok=patch_ok,
                        center=center)
