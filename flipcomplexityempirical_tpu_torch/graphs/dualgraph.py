"""Real-geometry dual graphs: precinct polygons -> LatticeGraph.

The port's copy of ``flipcomplexityempirical_tpu/graphs/dualgraph.py``,
numpy alone (``voronoi_precincts`` takes scipy): the same features give
the same graph, geometry attributes and boundary-length weights in both
packages.

BASELINE config 5 ("real precinct dual graph (small-state shapefile), k
districts with compactness score"). The reference imports geopandas but
never uses it (grid_chain_sec11.py:4, a dead capability breadcrumb); this
module supplies the live capability without depending on it:

- ``from_geojson``: pure-Python importer for a GeoJSON FeatureCollection of
  Polygon/MultiPolygon precincts. Adjacency is computed from shared
  geometry: rook = the polygons share a full boundary segment, queen = they
  share at least a vertex. Per-node area (shoelace), perimeter, centroid
  and per-adjacent-pair shared-boundary length are attached so the
  compactness scores (stats/compactness.py) and boundary-length-weighted
  chain targets work on top.
- ``from_shapefile``: thin gated wrapper that uses geopandas when it is
  installed to convert a .shp to the same feature-dict form.
- ``synthetic_precincts``: a jittered-quadrilateral "state" generator used
  by tests and demos, so the geometry path is exercised without shipping
  shapefile fixtures.

Coordinates are rounded to ``snap`` decimals when keying shared geometry —
the standard tolerance trick for topologically clean precinct files.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Optional

import numpy as np

from .lattice import build_lattice


@dataclasses.dataclass(frozen=True)
class GeoAttributes:
    """Per-node / per-edge geometry riding along with a dual LatticeGraph.

    ``shared_perim[e]`` is the total boundary length shared by the two
    endpoint precincts of graph edge e (edge order matches graph.edges);
    ``exterior_perim[v]`` is the part of v's perimeter shared with no other
    precinct (the map's outer boundary or holes)."""

    area: np.ndarray            # f64[N]
    perimeter: np.ndarray       # f64[N]
    centroid: np.ndarray        # f64[N, 2]
    shared_perim: np.ndarray    # f64[E]
    exterior_perim: np.ndarray  # f64[N]


def _rings(geometry: dict):
    """Yield the exterior + hole rings of a Polygon/MultiPolygon as
    (closed) coordinate lists."""
    t = geometry["type"]
    if t == "Polygon":
        for ring in geometry["coordinates"]:
            yield ring
    elif t == "MultiPolygon":
        for poly in geometry["coordinates"]:
            for ring in poly:
                yield ring
    else:
        raise ValueError(f"unsupported geometry type {t!r}")


def _ring_area_centroid(ring: np.ndarray):
    """Signed shoelace area and area-weighted centroid of one ring."""
    x, y = ring[:, 0], ring[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y1 - x1 * y
    a = cross.sum() / 2.0
    if a == 0:
        return 0.0, ring[:-1].mean(axis=0)
    cx = ((x + x1) * cross).sum() / (6.0 * a)
    cy = ((y + y1) * cross).sum() / (6.0 * a)
    return a, np.array([cx, cy])


def from_geojson(src, *, pop_property: Optional[str] = None,
                 name_property: Optional[str] = None,
                 adjacency: str = "rook", snap: int = 9,
                 pop_scale: float = 1.0, name: str = "dualgraph"):
    """Build (LatticeGraph, GeoAttributes) from a GeoJSON FeatureCollection.

    ``src`` is a path, a JSON string, or an already-parsed dict.
    ``pop_property`` names the feature property holding population
    (default: population 1 per precinct, like the reference's unit weights,
    grid_chain_sec11.py:218); ``pop_scale`` divides it (graph populations
    are integers). ``adjacency`` is 'rook' (shared boundary segment) or
    'queen' (shared vertex).
    """
    if isinstance(src, dict):
        gj = src
    elif isinstance(src, str) and src.lstrip().startswith("{"):
        gj = json.loads(src)
    else:
        with open(src) as f:
            gj = json.load(f)
    feats = gj["features"]
    n = len(feats)

    areas = np.zeros(n)
    perims = np.zeros(n)
    cents = np.zeros((n, 2))
    pops = np.ones(n, dtype=np.int64)
    labels = []

    # segment/vertex keys -> owning precincts, with lengths for segments
    seg_owner: dict = defaultdict(list)   # seg key -> [(node, length)]
    vert_owner: dict = defaultdict(set)   # vertex key -> {nodes}

    for i, feat in enumerate(feats):
        props = feat.get("properties") or {}
        if name_property and name_property in props:
            labels.append(props[name_property])
        else:
            labels.append(i)
        if pop_property:
            pops[i] = max(0, round(float(props[pop_property]) / pop_scale))
        area_i = 0.0
        cent_i = np.zeros(2)
        for ring in _rings(feat["geometry"]):
            r = np.asarray(ring, dtype=np.float64)
            if np.allclose(r[0], r[-1]):
                r_closed = r
            else:
                r_closed = np.vstack([r, r[:1]])
            a, c = _ring_area_centroid(r_closed)
            area_i += a
            cent_i += c * a
            pts = np.round(r_closed, snap)
            seglen = np.linalg.norm(np.diff(r_closed, axis=0), axis=1)
            perims[i] += seglen.sum()
            for s in range(len(pts) - 1):
                pa, pb = tuple(pts[s]), tuple(pts[s + 1])
                if pa == pb:
                    continue
                key = (pa, pb) if pa <= pb else (pb, pa)
                seg_owner[key].append((i, seglen[s]))
                vert_owner[pa].add(i)
            vert_owner[tuple(pts[-1])].add(i)
        if area_i == 0:
            raise ValueError(f"feature {labels[-1]!r} has zero area")
        areas[i] = abs(area_i)
        cents[i] = cent_i / area_i

    # rook adjacency + shared lengths from co-owned segments
    pair_len: dict = defaultdict(float)
    for key, owners in seg_owner.items():
        if len(owners) < 2:
            continue
        nodes = sorted({o for o, _ in owners})
        length = owners[0][1]
        for ai in range(len(nodes)):
            for bi in range(ai + 1, len(nodes)):
                pair_len[(nodes[ai], nodes[bi])] += length

    adj: dict = {i: set() for i in range(n)}
    if adjacency == "rook":
        for (u, v) in pair_len:
            adj[u].add(v)
            adj[v].add(u)
    elif adjacency == "queen":
        for owners in vert_owner.values():
            owners = sorted(owners)
            for ai in range(len(owners)):
                for bi in range(ai + 1, len(owners)):
                    adj[owners[ai]].add(owners[bi])
                    adj[owners[bi]].add(owners[ai])
    else:
        raise ValueError(f"adjacency {adjacency!r}")

    if len(set(labels)) != n:
        # label-keyed maps would silently collapse duplicates into one node
        from collections import Counter
        dupes = [lab for lab, c in Counter(labels).items() if c > 1][:5]
        raise ValueError(
            f"{name_property!r} values are not unique across features "
            f"(e.g. {dupes}); pass a unique name_property or None to key "
            "precincts by feature index")

    label_adj = {labels[i]: [labels[j] for j in sorted(adj[i])]
                 for i in range(n)}
    coords = {labels[i]: tuple(cents[i]) for i in range(n)}
    popd = {labels[i]: int(pops[i]) for i in range(n)}

    graph = build_lattice(
        label_adj, name=name, coords=coords, pop=popd,
        center=tuple(cents.mean(axis=0)), node_order=labels)

    # per-graph-edge shared perimeter, exterior perimeter per node
    shared = np.zeros(graph.n_edges)
    for ei in range(graph.n_edges):
        u, v = int(graph.edges[ei, 0]), int(graph.edges[ei, 1])
        shared[ei] = pair_len.get((min(u, v), max(u, v)), 0.0)
    shared_per_node = np.zeros(n)
    for (u, v), length in pair_len.items():
        shared_per_node[u] += length
        shared_per_node[v] += length
    exterior = np.maximum(perims - shared_per_node, 0.0)

    geo = GeoAttributes(area=areas, perimeter=perims, centroid=cents,
                        shared_perim=shared, exterior_perim=exterior)
    graph = dataclasses.replace(graph, edge_len=shared.astype(np.float32))
    return graph, geo


def from_shapefile(path, **kwargs):
    """Read a polygon shapefile (.shp + sidecar .dbf attribute table)
    with the NATIVE reader (graphs/shapefile.py — no geopandas/fiona
    dependency; pure numpy/struct parsing of the ESRI format) and
    delegate to from_geojson. tests/test_dualgraph.py proves the round
    trip write_shapefile -> from_shapefile == from_geojson on the same
    features, dual graph and geometry attributes identical."""
    from .shapefile import read_shapefile
    return from_geojson(read_shapefile(path), **kwargs)


def voronoi_precincts(n: int, *, seed: int = 0, width: float = None,
                      height: float = None,
                      pop_range: tuple = (50, 200)) -> dict:
    """An irregular Voronoi-tessellated 'state' as a GeoJSON dict — the
    realistic-topology counterpart to ``synthetic_precincts``: precinct
    degrees vary (real precinct dual graphs are not 4-regular), cells are
    convex irregular polygons, and shared boundaries have genuine varied
    lengths for the boundary-length-weighted chain target.

    Seeds are a jittered sqrt(n)-ish grid (no near-coincident generators);
    the diagram is clipped EXACTLY to the bounding box by the standard
    mirror trick (reflect the generators across all four box edges and
    tessellate the 5n points — each interior cell's clipped boundary then
    falls out of the tessellation itself, so neighboring cells share
    bit-identical vertex coordinates and from_geojson's snap-keyed rook
    adjacency is watertight). No real shapefile ships in this offline
    environment (README documents the limitation); this generator is the
    honest stand-in exercising the same code path real files take.
    """
    from scipy.spatial import Voronoi

    rng = np.random.default_rng(seed)
    nx_ = int(np.ceil(np.sqrt(n)))
    ny_ = int(np.ceil(n / nx_))
    w = float(width if width is not None else nx_)
    h = float(height if height is not None else ny_)
    gx = (np.arange(nx_) + 0.5) * (w / nx_)
    gy = (np.arange(ny_) + 0.5) * (h / ny_)
    pts = np.stack(np.meshgrid(gx, gy, indexing="ij"),
                   axis=-1).reshape(-1, 2)[:n]
    pts = pts + rng.uniform(-0.35, 0.35, pts.shape) * [w / nx_, h / ny_]

    mirrored = [pts]
    for axis, bound in ((0, 0.0), (0, w), (1, 0.0), (1, h)):
        m = pts.copy()
        m[:, axis] = 2 * bound - m[:, axis]
        mirrored.append(m)
    vor = Voronoi(np.vstack(mirrored))

    feats = []
    for i in range(n):
        region = vor.regions[vor.point_region[i]]
        if -1 in region or not region:       # cannot happen post-mirror
            raise RuntimeError(f"unbounded Voronoi cell {i}")
        verts = vor.vertices[region]
        # convex cell: exact CCW order = angular order about the mean
        ang = np.arctan2(verts[:, 1] - verts[:, 1].mean(),
                         verts[:, 0] - verts[:, 0].mean())
        verts = verts[np.argsort(ang)]
        ring = np.vstack([verts, verts[:1]]).tolist()
        feats.append({
            "type": "Feature",
            "properties": {"NAME": f"v{i}",
                           "POP": int(rng.integers(*pop_range))},
            "geometry": {"type": "Polygon", "coordinates": [ring]},
        })
    return {"type": "FeatureCollection", "features": feats}


def synthetic_precincts(nx_: int, ny_: int, *, seed: int = 0,
                        jitter: float = 0.25,
                        pop_range: tuple = (80, 120)) -> dict:
    """A jittered nx x ny quadrilateral 'state' as a GeoJSON dict: interior
    lattice vertices are perturbed (consistently for all four incident
    quads, keeping the planar subdivision topologically clean), and each
    precinct gets a POP property. Dual graph = rook grid."""
    rng = np.random.default_rng(seed)
    vx = np.tile(np.arange(nx_ + 1, dtype=np.float64)[:, None], (1, ny_ + 1))
    vy = np.tile(np.arange(ny_ + 1, dtype=np.float64)[None, :], (nx_ + 1, 1))
    interior = np.zeros((nx_ + 1, ny_ + 1), dtype=bool)
    interior[1:-1, 1:-1] = True
    vx = vx + np.where(interior, rng.uniform(-jitter, jitter,
                                             vx.shape), 0.0)
    vy = vy + np.where(interior, rng.uniform(-jitter, jitter,
                                             vy.shape), 0.0)
    feats = []
    for i in range(nx_):
        for j in range(ny_):
            ring = [
                [vx[i, j], vy[i, j]],
                [vx[i + 1, j], vy[i + 1, j]],
                [vx[i + 1, j + 1], vy[i + 1, j + 1]],
                [vx[i, j + 1], vy[i, j + 1]],
                [vx[i, j], vy[i, j]],
            ]
            feats.append({
                "type": "Feature",
                "properties": {
                    "NAME": f"p{i}_{j}",
                    "POP": int(rng.integers(*pop_range)),
                },
                "geometry": {"type": "Polygon", "coordinates": [ring]},
            })
    return {"type": "FeatureCollection", "features": feats}
