"""District compactness scores (BASELINE config 5: "k districts with
compactness score").

Discrete scores work on any graph via edge counts; geometric scores
(Polsby-Popper) need per-node areas and per-edge shared-boundary lengths,
which the dual-graph importer (graphs/dualgraph.py) attaches from real
precinct geometry.

The port's copy of ``flipcomplexityempirical_tpu/stats/compactness.py``.
"""

from __future__ import annotations

import numpy as np


def cut_edge_count(assignment, edges) -> np.ndarray:
    """Cut edges per chain: (C,) from assignment (C, N) | (N,) and edge list
    (E, 2) — the discrete compactness score the reference's target
    pi ∝ base^(-|cut|) penalizes."""
    a = np.asarray(assignment)
    if a.ndim == 1:
        a = a[None, :]
    e = np.asarray(edges)
    return (a[:, e[:, 0]] != a[:, e[:, 1]]).sum(axis=1)


def perimeter_area(assignment, k: int, *, edges, shared_perim, node_area,
                   node_exterior_perim=None):
    """Per-district perimeter and area: two (C, K) arrays.

    District perimeter = sum of shared-boundary lengths of cut edges
    incident to the district + its nodes' exterior (map-edge) perimeter;
    area = sum of member node areas.
    """
    a = np.asarray(assignment)
    if a.ndim == 1:
        a = a[None, :]
    c, n = a.shape
    e = np.asarray(edges)
    sp = np.asarray(shared_perim, dtype=np.float64)
    area = np.asarray(node_area, dtype=np.float64)
    ext = (np.zeros(n) if node_exterior_perim is None
           else np.asarray(node_exterior_perim, dtype=np.float64))

    au, av = a[:, e[:, 0]], a[:, e[:, 1]]
    cut = au != av
    perim = np.zeros((c, k))
    areas = np.zeros((c, k))
    for d in range(k):
        member = a == d
        perim[:, d] = ((cut & (au == d)) * sp).sum(axis=1) \
            + ((cut & (av == d)) * sp).sum(axis=1) \
            + member @ ext
        areas[:, d] = member @ area
    return perim, areas


def polsby_popper(assignment, k: int, *, edges, shared_perim, node_area,
                  node_exterior_perim=None) -> np.ndarray:
    """Polsby-Popper score 4*pi*A / P^2 per district: (C, K) in (0, 1],
    1 = disc. NaN for empty districts."""
    perim, area = perimeter_area(
        assignment, k, edges=edges, shared_perim=shared_perim,
        node_area=node_area, node_exterior_perim=node_exterior_perim)
    out = np.full(perim.shape, np.nan)
    ok = perim > 0
    out[ok] = 4.0 * np.pi * area[ok] / perim[ok] ** 2
    return out
