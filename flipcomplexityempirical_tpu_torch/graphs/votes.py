"""Random vote attributes: the reference's pink/purple node columns.

The port's copy of ``flipcomplexityempirical_tpu/graphs/votes.py``.
grid_chain_sec11.py:223-228 seeds every node with Bernoulli(1/2) party
membership (``pink``/``purple``, exactly one of the two set to 1) for the
commented-out ``Election("Pink-Purple", ...)`` updater (line 307). Here the
columns are a dense (N, 2) array aligned with LatticeGraph node order, the
shape ``stats.partisan`` consumes directly.
"""

from __future__ import annotations

import numpy as np

from .lattice import LatticeGraph

PARTIES = ("pink", "purple")


class VoteAlignmentError(ValueError):
    """Typed mismatch between a vote array and the graph it scores,
    raised before any tally: votes that do not follow LatticeGraph node
    order would silently mis-attribute votes to districts."""


def validate_votes(graph: LatticeGraph, votes) -> np.ndarray:
    """Validate ``votes`` against ``graph``: 2-D (N, P) with one row per
    graph node in LatticeGraph node order, P >= 2 party columns, finite
    non-negative counts. Returns the array as numpy; raises
    VoteAlignmentError on any mismatch."""
    v = np.asarray(votes)
    name = getattr(graph, "name", None) or "graph"
    if v.ndim != 2:
        raise VoteAlignmentError(
            f"votes for {name!r} must be 2-D (nodes, parties); "
            f"got shape {v.shape}")
    if v.shape[0] != graph.n_nodes:
        raise VoteAlignmentError(
            f"votes rows ({v.shape[0]}) != nodes ({graph.n_nodes}) of "
            f"{name!r}: vote columns must align with LatticeGraph node "
            f"order")
    if v.shape[1] < 2:
        raise VoteAlignmentError(
            f"votes for {name!r} needs >= 2 party columns; "
            f"got {v.shape[1]}")
    vf = v.astype(np.float64)
    if not np.isfinite(vf).all() or (vf < 0).any():
        raise VoteAlignmentError(
            f"votes for {name!r} must be finite and non-negative")
    return v


def seed_votes(graph: LatticeGraph, seed: int, p: float = 0.5) -> np.ndarray:
    """(N, 2) int8: column 0 = pink, column 1 = purple; one vote per node
    (the reference's one-person-one-party attribute pair)."""
    rng = np.random.default_rng(seed)
    pink = (rng.random(graph.n_nodes) < p).astype(np.int8)
    return np.stack([pink, 1 - pink], axis=1)
