"""Stencil IR + lowering pass: compile near-grid graphs onto the board path.

The port's copy of ``flipcomplexityempirical_tpu/lower/stencil.py``
(numpy only, unchanged in substance). In this package the lowered planes
feed ``kernel/board.py``'s stencil helpers and the ``lowered_chunk``
kernel (``kernel/cuda_lowered.py``, ``csrc/lowered_chunk.cu``).

The board kernel (kernel/board.py) executes a *stencil program*: every
per-step quantity is an elementwise combination of shifted copies of one
flat (C, N) plane. Historically its compile target was hardcoded — a full
HxW rook grid — which excluded the two graphs the source paper actually
studies: the sec11 corner-surgery grid (4 corner nodes removed, 4 diagonal
bypass edges) and the Frankengraph square+triangular composite (a seam of
diagonal edges). Both are *near-grid*: integer 2-tuple labels whose every
edge is a king move on the label lattice.

``lower_to_stencil`` embeds any such graph into an HxW canvas and emits a
``StencilSpec`` — the static plane set the generalized kernel bodies
consume:

- ``node_mask`` / ``cell_of_node``: the canvas embedding (holes = removed
  nodes and padding cells; hole cells carry district -1, population 0,
  degree 0, and are excluded from every count and from selection);
- ``adj``: 8 per-direction neighbor-existence planes in the kernel's ring
  order E, SE, S, SW, W, NW, N, NE — masked stencil reads replace the
  rook row-wrap masks, and diagonal edges are just two more planes;
- B2-window contiguity tables (``b2_offsets`` / ``b2_in`` / ``b2_adj`` /
  ``nbr_bits``): the general path's radius-2 ``patch_connected`` check
  re-expressed over *static flat canvas offsets* with per-cell membership
  masks, so the kernel can run the exact bitset label propagation with no
  gathers (see kernel/board.py::_stencil_patch_ok). Keying the tables by
  flat offset (not (dr, dc)) makes small-width aliasing impossible by
  construction: the offset IS the target cell. The ring's 8 direction
  planes do need distinct flat offsets, hence the h, w >= 3 requirement.
  On plain rook grids the kernel keeps its cheaper ring criterion (proven
  equivalent there); with diagonal edges the ring shortcut is *wrong*
  (a diagonal can bridge ring-nonadjacent neighbors), so the lowered body
  always uses the B2 propagation.
- wall/interface planes (``iface_key``): for ``record_interface`` specs,
  each wall edge's canonical index and doubled midpoint coordinates are
  packed into one int32 key per (forward direction, cell); the kernel
  min-reduces keys over the cut planes and decodes the two lowest —
  reproducing kernel/step.py::interface_metrics' deterministic
  "two smallest-index wall-cut edges" selection with no per-step gather.

``lower_to_stencil`` returns None for anything it cannot embed exactly
(non-integer labels, non-king edges, tiny or wasteful canvases, oversized
B2 windows); callers fall back to the general kernel. ``stencil_for``
caches per graph identity. This module is pure numpy — it imports no
kernel code, so the kernel layer can import it without cycles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from ..graphs.lattice import LatticeGraph

# ring order shared with kernel/board.py::same_planes: (dx, dy) label
# deltas; canvas row = x - xmin, col = y - ymin, flat = row * W + col
RING_DELTAS = ((0, 1), (1, 1), (1, 0), (1, -1),
               (0, -1), (-1, -1), (-1, 0), (-1, 1))
# forward (canonical, smaller-endpoint-first) directions: E, SE, S, SW
N_FWD = 4
# composite interface keys must stay positive int32 below the sentinel
IFACE_BIG = np.int32(2 ** 30)
_MAX_B2_OFFSETS = 30       # bitset lives in a signed int32 plane
_MAX_CANVAS_WASTE = 4.0    # reject canvases > 4x the node count


@dataclasses.dataclass(frozen=True, eq=False)
class StencilSpec:
    """Static lowering artifact: everything the board kernel needs to run
    a near-grid graph, as numpy planes over the HxW canvas (N = H*W).
    K = number of distinct B2-window flat offsets; E = graph edge count."""

    name: str
    h: int
    w: int
    origin: tuple                 # (xmin, ymin) label of canvas cell 0
    n_real: int                   # real node count (== graph.n_nodes)
    plain: bool                   # full rook grid (no surgery)
    uniform_pop: bool
    node_mask: np.ndarray         # bool[N] cell holds a real node
    cell_of_node: np.ndarray      # int32[n_real] canvas cell of node i
    pop: np.ndarray               # int32[N] node population (0 at holes)
    deg: np.ndarray               # int32[N] graph degree (0 at holes)
    adj: np.ndarray               # bool[8, N] ring-order edge existence
    # --- B2-window contiguity tables (patch_connected, offset-keyed) ---
    b2_offsets: tuple             # K static flat canvas offsets
    b2_in: np.ndarray             # bool[K, N] offset k in patch(cell)
    b2_adj: np.ndarray            # int32[K, N] bitset: offsets adjacent
                                  #   to cell+offset_k within patch(cell)
    nbr_bits: np.ndarray          # int32[N] bitset of direct-nbr offsets
    b2_disp: Optional[tuple]      # K (dr, dc) label displacements, one per
                                  #   b2_offset; None when a flat offset is
                                  #   realized by two distinct (dr, dc)
                                  #   pairs (only possible at w <= 4) —
                                  #   packed bodies need the 2-D form
    b2_iters: int                 # propagation rounds (max patch size - 1)
    patch_exact: bool             # B2 tables == graph patch tables
    # --- canonical edge mapping (cut_times in LatticeGraph edge order) ---
    edge_plane: np.ndarray        # int8[E] forward ring dir (0..3)
    edge_cell: np.ndarray         # int32[E] cell of the smaller endpoint
    # --- interface (wall) planes for record_interface ---
    iface_ok: bool
    iface_key: Optional[np.ndarray]   # int32[4, N], IFACE_BIG = no wall
    iface_decode: tuple               # (qx_off, qy_off, bx, by)
    center: tuple                 # (cx, cy) float

    @property
    def surgical(self) -> bool:
        """Anything beyond a plain full rook grid (holes, diagonals)."""
        return not self.plain

    @property
    def n(self) -> int:
        return self.h * self.w


def _int_label(lab) -> bool:
    return (isinstance(lab, tuple) and len(lab) == 2
            and all(isinstance(v, (int, np.integer)) for v in lab))


def _radius2_patches(n: int, nbr_lists) -> list[list[int]]:
    """Radius-2 BFS balls excluding the center, neighbors first — the
    same construction (and member order) as graphs/lattice.py's patch
    tables at patch_radius=2."""
    patches = []
    for v in range(n):
        first = list(nbr_lists[v])
        seen = {v, *first}
        ordered = list(first)
        for j in first:
            for k2 in nbr_lists[j]:
                if k2 not in seen:
                    seen.add(k2)
                    ordered.append(k2)
        patches.append(ordered)
    return patches


def lower_to_stencil(graph: LatticeGraph) -> Optional[StencilSpec]:
    """Embed ``graph`` into the board kernel's stencil representation, or
    return None when no exact embedding exists (caller falls back to the
    general kernel). Accepts any graph whose labels are integer 2-tuples
    and whose every edge is a king move on the label lattice: full rook
    grids, grids with removed nodes, extra diagonal/queen edges, and
    seamed composites like the Frankengraph."""
    labs = list(graph.labels)
    n_real = graph.n_nodes
    if n_real == 0 or not all(_int_label(l) for l in labs):
        return None
    xs = np.array([l[0] for l in labs], np.int64)
    ys = np.array([l[1] for l in labs], np.int64)
    xmin, ymin = int(xs.min()), int(ys.min())
    h = int(xs.max()) - xmin + 1
    w = int(ys.max()) - ymin + 1
    # the 8 ring directions must map to 8 DISTINCT flat offsets
    if h < 3 or w < 3:
        return None
    n = h * w
    if n > max(64, _MAX_CANVAS_WASTE * n_real):
        return None
    cell_of_node = ((xs - xmin) * w + (ys - ymin)).astype(np.int32)
    # canonical node order must be canvas row-major order (sorted lex
    # labels guarantee it; a custom node_order may not)
    if not bool(np.all(np.diff(cell_of_node) > 0)):
        return None

    fwd_of_delta = {d: i for i, d in enumerate(RING_DELTAS[:N_FWD])}
    edges = np.asarray(graph.edges, np.int64)
    e = edges.shape[0]
    edge_plane = np.empty(e, np.int8)
    edge_cell = np.empty(e, np.int32)
    for ei in range(e):
        a, b = int(edges[ei, 0]), int(edges[ei, 1])
        delta = (int(xs[b] - xs[a]), int(ys[b] - ys[a]))
        d = fwd_of_delta.get(delta)
        if d is None:         # not a king move (a < b => forward delta)
            return None
        edge_plane[ei] = d
        edge_cell[ei] = cell_of_node[a]

    node_mask = np.zeros(n, bool)
    node_mask[cell_of_node] = True
    pop = np.zeros(n, np.int32)
    pop[cell_of_node] = np.asarray(graph.pop, np.int32)
    adj = np.zeros((8, n), bool)
    for ei in range(e):
        d = int(edge_plane[ei])
        ca = int(edge_cell[ei])
        dx, dy = RING_DELTAS[d]
        cb = ca + dx * w + dy
        adj[d, ca] = True
        adj[(d + 4) % 8, cb] = True
    deg = adj.sum(axis=0).astype(np.int32)

    rook = h * (w - 1) + (h - 1) * w
    plain = (n == n_real and e == rook
             and bool(np.all(edge_plane % 2 == 0)))

    # --- B2 contiguity tables: radius-2 patches keyed by flat offset ---
    nbr_lists: list[list[int]] = [[] for _ in range(n_real)]
    for a, b in edges:
        nbr_lists[a].append(int(b))
        nbr_lists[b].append(int(a))
    patches = _radius2_patches(n_real, nbr_lists)
    max_patch = max((len(p) for p in patches), default=0)
    offset_set: set[int] = set()
    for v, pl in enumerate(patches):
        cv = int(cell_of_node[v])
        offset_set.update(int(cell_of_node[u]) - cv for u in pl)
    b2_offsets = tuple(sorted(offset_set))
    k = len(b2_offsets)
    if k > _MAX_B2_OFFSETS:
        return None
    off_idx = {o: i for i, o in enumerate(b2_offsets)}
    b2_in = np.zeros((k, n), bool)
    b2_adj = np.zeros((k, n), np.int32)
    nbr_bits = np.zeros(n, np.int32)
    nbrsets = [set(nl) for nl in nbr_lists]
    # 2-D displacement behind each flat offset: packed (bit-board) bodies
    # shift rows and columns separately, so they need (dr, dc), not dr*w+dc.
    # A flat offset realized by two distinct (dr, dc) pairs (needs
    # |dc|, |dc'| <= 2 with (dr - dr') * w == dc' - dc, i.e. w <= 4) makes
    # the 2-D form ill-defined — record None and let dispatch skip packing.
    disp_of_off: dict[int, tuple] = {}
    disp_ambiguous = False
    for v, pl in enumerate(patches):
        cv = int(cell_of_node[v])
        slot = {u: off_idx[int(cell_of_node[u]) - cv] for u in pl}
        for u in pl:
            o = int(cell_of_node[u]) - cv
            d2 = (int(xs[u] - xs[v]), int(ys[u] - ys[v]))
            if disp_of_off.setdefault(o, d2) != d2:
                disp_ambiguous = True
        for u, ku in slot.items():
            b2_in[ku, cv] = True
            word = 0
            for u2 in nbrsets[u]:
                k2 = slot.get(u2)
                if k2 is not None:
                    word |= 1 << k2
            b2_adj[ku, cv] = word
        for u in nbr_lists[v]:
            nbr_bits[cv] |= 1 << slot[u]
    b2_disp = (None if disp_ambiguous
               else tuple(disp_of_off[o] for o in b2_offsets))
    b2_iters = max(max_patch - 1, 0)
    patch_exact = bool(graph.patch_ok) and all(
        set(np.asarray(graph.patch_nodes[v, :graph.patch_size[v]]).tolist())
        == set(patches[v]) for v in range(n_real))

    # --- interface planes (two smallest-index wall-cut edges) ----------
    wall_id = np.asarray(graph.wall_id, np.int64)
    wall = wall_id >= 0
    coords = np.asarray(graph.coords, np.float64)
    iface_ok = False
    iface_key = None
    iface_decode = (0, 0, 0, 0)
    if bool(wall.any()):
        we = np.nonzero(wall)[0]
        q = coords[edges[we, 0]] + coords[edges[we, 1]]   # 2 * midpoint
        if bool(np.all(q == np.round(q))):
            qi = q.astype(np.int64)
            qx_off, qy_off = int(qi[:, 0].min()), int(qi[:, 1].min())
            bx = max(int(qi[:, 0].max()) - qx_off, 1).bit_length()
            by = max(int(qi[:, 1].max()) - qy_off, 1).bit_length()
            ebits = max(int(we.max()), 1).bit_length()
            if ebits + bx + by <= 30:
                iface_key = np.full((N_FWD, n), IFACE_BIG, np.int32)
                for j, ei in enumerate(we):
                    key = ((int(ei) << (bx + by))
                           | ((int(qi[j, 0]) - qx_off) << by)
                           | (int(qi[j, 1]) - qy_off))
                    iface_key[edge_plane[ei], edge_cell[ei]] = key
                iface_decode = (qx_off, qy_off, bx, by)
                iface_ok = True

    pops = np.asarray(graph.pop)
    return StencilSpec(
        name=graph.name, h=h, w=w, origin=(xmin, ymin), n_real=n_real,
        plain=plain,
        uniform_pop=bool(pops.size) and bool((pops == pops[0]).all()),
        node_mask=node_mask, cell_of_node=cell_of_node, pop=pop, deg=deg,
        adj=adj, b2_offsets=b2_offsets, b2_in=b2_in, b2_adj=b2_adj,
        nbr_bits=nbr_bits, b2_disp=b2_disp, b2_iters=b2_iters,
        patch_exact=patch_exact,
        edge_plane=edge_plane, edge_cell=edge_cell,
        iface_ok=iface_ok, iface_key=iface_key, iface_decode=iface_decode,
        center=(float(graph.center[0]), float(graph.center[1])))


@functools.lru_cache(maxsize=16)
def stencil_for(graph: LatticeGraph) -> Optional[StencilSpec]:
    """Cached ``lower_to_stencil`` (LatticeGraph is frozen with eq=False,
    so the cache keys on object identity — builders return fresh objects,
    but every layer of one run shares the same graph instance)."""
    return lower_to_stencil(graph)
