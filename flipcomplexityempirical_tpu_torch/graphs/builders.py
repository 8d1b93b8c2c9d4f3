"""Lattice builders and starting plans.

The port's copies of ``square_grid`` (with edge and node surgery, queen
diagonals, walls, frame and center), ``grid_sec11``, ``frankengraph``,
``triangular_lattice``, ``hex_lattice``, ``sec11_plan``, ``frank_plan``,
``stripes_plan`` and ``PARITY_LABELS`` from
``flipcomplexityempirical_tpu/graphs/builders.py``.

The JAX package builds the triangular and hexagonal lattices (and the
Frankengraph's two halves) with networkx's generators. This package draws
the same node labels and edges by hand (``_triangular_lattice``,
``_hexagonal_lattice``), so it does not need networkx; ``build_lattice``
canonicalises the order, so the result equals the JAX package's graph
field for field.
"""

from __future__ import annotations

import numpy as np

from .lattice import LatticeGraph, build_lattice

# The four corner-bypass diagonal edges the sec11 script adds
# (grid_chain_sec11.py:236) and the corner nodes it removes (line 252).
_SEC11_DIAGONALS = [((0, 1), (1, 0)), ((0, 38), (1, 39)),
                    ((38, 0), (39, 1)), ((38, 39), (39, 38))]
_SEC11_CORNERS = [(0, 0), (0, 39), (39, 0), (39, 39)]

# district index -> the reference's +1/-1 label (district 0 <-> +1)
PARITY_LABELS = np.array([1, -1], dtype=np.int32)


def square_grid(nx_: int, ny_: int | None = None, *, name: str | None = None,
                extra_edges=(), remove_nodes=(), wall=None, frame=None,
                center=None, queen: bool = False) -> LatticeGraph:
    """Rook-adjacency nx_ x ny_ grid with optional edge/node surgery;
    ``queen=True`` adds both diagonals of every unit cell. Node (x, y)
    has flat index x*ny_ + y on a full grid."""
    ny_ = nx_ if ny_ is None else ny_
    removed = set(remove_nodes)
    nodes = [(x, y) for x in range(nx_) for y in range(ny_)
             if (x, y) not in removed]
    nodeset = set(nodes)
    adjacency = {nd: [] for nd in nodes}
    offsets = (((1, 0), (0, 1), (1, 1), (1, -1)) if queen
               else ((1, 0), (0, 1)))
    for (x, y) in nodes:
        for (dx, dy) in offsets:
            m = (x + dx, y + dy)
            if m in nodeset:
                adjacency[(x, y)].append(m)
                adjacency[m].append((x, y))
    for (u, v) in extra_edges:
        if u in nodeset and v in nodeset:
            adjacency[u].append(v)
            adjacency[v].append(u)
    if frame is None:
        frame = lambda nd: nd[0] in (0, nx_ - 1) or nd[1] in (0, ny_ - 1)
    if center is None:
        center = (nx_ / 2.0, ny_ / 2.0)
    return build_lattice(
        adjacency,
        name=name or f"{'queen' if queen else 'grid'}{nx_}x{ny_}",
        frame=frame, wall=wall, center=center)


def grid_sec11() -> LatticeGraph:
    """The sec11 experiment graph: 1596 nodes, 3116 edges. Wall ids: 0
    both x==0; 1 both y==0; 2 both x==39; 3 both y==39; 4 the four corner
    diagonal edges (grid_chain_sec11.py:63-75)."""
    diag = {frozenset(e) for e in _SEC11_DIAGONALS}

    def wall(u, v):
        if u[0] == 0 and v[0] == 0:
            return 0
        if u[1] == 0 and v[1] == 0:
            return 1
        if u[0] == 39 and v[0] == 39:
            return 2
        if u[1] == 39 and v[1] == 39:
            return 3
        if frozenset((u, v)) in diag:
            return 4
        return -1

    return square_grid(
        40, 40, name="grid_sec11",
        extra_edges=_SEC11_DIAGONALS, remove_nodes=_SEC11_CORNERS,
        wall=wall, frame=lambda nd: 0 in nd or 39 in nd, center=(20.0, 20.0))


def _triangular_lattice(m: int, n: int) -> list:
    """Edge list of networkx's ``triangular_lattice_graph(m, n)``
    (non-periodic): nodes (i, j) with j in [0, m] and i in [0, N],
    N = (n + 1) // 2; row edges, column edges and one diagonal per cell,
    leaning by row parity; for odd n the nodes (N, j) of odd rows j are
    removed with their edges."""
    big_n = (n + 1) // 2
    rows, cols = range(m + 1), range(big_n + 1)
    edges = [((i, j), (i + 1, j)) for j in rows for i in cols[:big_n]]
    edges += [((i, j), (i, j + 1)) for j in rows[:m] for i in cols]
    edges += [((i, j), (i + 1, j + 1)) for j in rows[1:m:2]
              for i in cols[:big_n]]
    edges += [((i + 1, j), (i, j + 1)) for j in rows[:m:2]
              for i in cols[:big_n]]
    if n % 2:
        gone = {(big_n, j) for j in rows[1::2]}
        edges = [e for e in edges if e[0] not in gone and e[1] not in gone]
    return edges


def _hexagonal_lattice(m: int, n: int) -> list:
    """Edge list of networkx's ``hexagonal_lattice_graph(m, n)``
    (non-periodic): nodes (i, j) with i in [0, n] and j in [0, 2m + 1];
    column edges (i, j)-(i, j + 1), row edges (i, j)-(i + 1, j) where i
    and j have the same parity; the corner nodes (0, 2m + 1) and
    (n, (2m + 1) * (n % 2)) are removed with their edges."""
    big_m = 2 * m
    rows, cols = range(big_m + 2), range(n + 1)
    edges = [((i, j), (i, j + 1)) for i in cols for j in rows[:big_m + 1]]
    edges += [((i, j), (i + 1, j)) for i in cols[:n] for j in rows
              if i % 2 == j % 2]
    gone = {(0, big_m + 1), (n, (big_m + 1) * (n % 2))}
    return [e for e in edges if e[0] not in gone and e[1] not in gone]


def _label_center(labels) -> tuple:
    xs = [x for (x, _) in labels]
    ys = [y for (_, y) in labels]
    return ((min(xs) + max(xs)) / 2.0, (min(ys) + max(ys)) / 2.0)


def _from_edges(edges, **kwargs) -> LatticeGraph:
    adjacency: dict = {}
    for u, v in edges:
        adjacency.setdefault(u, []).append(v)
        adjacency.setdefault(v, []).append(u)
    center = kwargs.pop("center", None) or _label_center(adjacency)
    return build_lattice(adjacency, center=center, **kwargs)


def triangular_lattice(m: int, n: int, *, name: str | None = None,
                       frame=None, wall=None, center=None) -> LatticeGraph:
    """networkx's ``triangular_lattice_graph(m, n)`` (the reference's
    generator, Frankenstein_chain.py:188), coordinates = labels, center
    the labels' bounding-box middle."""
    return _from_edges(_triangular_lattice(m, n), name=name or f"tri{m}x{n}",
                       frame=frame, wall=wall, center=center)


def hex_lattice(m: int, n: int, *, name: str | None = None,
                frame=None, wall=None, center=None) -> LatticeGraph:
    """networkx's ``hexagonal_lattice_graph(m, n)`` (degree <= 3), with
    radius-3 patches: neighbours of a flipped node reconnect around a
    hexagonal face through distance-3 nodes."""
    return _from_edges(_hexagonal_lattice(m, n), name=name or f"hex{m}x{n}",
                       frame=frame, wall=wall, center=center,
                       patch_radius=3)


def frankengraph(m: int = 20) -> LatticeGraph:
    """Square-grid + triangular-lattice hybrid (Frankenstein_chain.py:
    186-195): an m x m rook grid relabeled to y in [-(m-1), 0], composed
    with ``triangular_lattice_graph(m, 2m-2)`` spanning y in [0, m]; the
    m nodes of the y==0 row are shared. For m=20: 800 nodes, 1920 edges.
    Wall ids (Frankenstein_chain.py:64-71): 0 both x==0; 1 both
    y==-(m-1); 2 both x==m-1; 3 both y==m."""
    adjacency: dict = {}

    def link(u, v):
        adjacency.setdefault(u, set()).add(v)
        adjacency.setdefault(v, set()).add(u)

    for x in range(m):
        for y in range(m):
            lab = (x, y - m + 1)
            adjacency.setdefault(lab, set())
            if x + 1 < m:
                link(lab, (x + 1, y - m + 1))
            if y + 1 < m:
                link(lab, (x, y - m + 2))
    for u, v in _triangular_lattice(m, 2 * m - 2):
        link(u, v)
    y_lo, y_hi = -(m - 1), m

    def wall(u, v):
        if u[0] == 0 and v[0] == 0:
            return 0
        if u[1] == y_lo and v[1] == y_lo:
            return 1
        if u[0] == m - 1 and v[0] == m - 1:
            return 2
        if u[1] == y_hi and v[1] == y_hi:
            return 3
        return -1

    return build_lattice(
        adjacency, name=f"frankengraph{m}",
        frame=lambda nd: nd[0] in (0, m - 1) or nd[1] in (y_hi, y_lo),
        wall=wall, center=(float(m), float(m)))


# ---------------------------------------------------------------------------
# Initial plans (the reference's alignment-indexed starting assignments).
# Districts are 0..K-1; district 0 is the reference's +1 side.
# ---------------------------------------------------------------------------

def sec11_plan(graph: LatticeGraph, alignment: int) -> np.ndarray:
    """grid_chain_sec11.py:197-214 — 0: vertical split at x>19; 1:
    horizontal at y>19; 2: diagonal x>y with the x==y tie broken at
    x>19."""
    out = np.empty(graph.n_nodes, dtype=np.int8)
    for i, (x, y) in enumerate(graph.labels):
        if alignment == 0:
            plus = x > 19
        elif alignment == 1:
            plus = y > 19
        elif alignment == 2:
            plus = (x > y) or (x == y and x > 19)
        else:
            raise ValueError(f"alignment {alignment}")
        out[i] = 0 if plus else 1
    return out


def frank_plan(graph: LatticeGraph, alignment: int, m: int = 20) -> np.ndarray:
    """Frankenstein_chain.py:207-246 — start_plans = [diagonal, vertical,
    horizontal][alignment]; members of the plan get district 0 (+1)."""
    out = np.empty(graph.n_nodes, dtype=np.int8)
    for i, (x, y) in enumerate(graph.labels):
        if alignment == 0:
            plus = 2 * x - y <= m - 3
        elif alignment == 1:
            plus = x < m / 2
        elif alignment == 2:
            plus = y < 0
        else:
            raise ValueError(f"alignment {alignment}")
        out[i] = 0 if plus else 1
    return out


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
