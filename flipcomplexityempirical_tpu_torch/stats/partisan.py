"""Partisan metrics: the gerrychain surface the reference imports but never
calls (``Election``, ``mean_median``, ``efficiency_gap`` at
grid_chain_sec11.py:20-30 — dead capability breadcrumbs, SURVEY.md section
2.2) — implemented batched over the (C, N) assignment array so a whole
chain ensemble is scored in one pass. The port's copy of
``flipcomplexityempirical_tpu/stats/partisan.py``.

Vote columns correspond to the reference's random ``pink``/``purple`` node
attributes (grid_chain_sec11.py:223-228).
"""

from __future__ import annotations

import numpy as np


def district_vote_tallies(assignment, votes, k: int) -> np.ndarray:
    """Sum per-node ``votes`` (N, P) into districts: returns (C, K, P).
    ``assignment`` is (C, N) or (N,) of district indices (the ``Election``
    updater's tally, vectorized over the chain batch)."""
    a = np.asarray(assignment)
    if a.ndim == 1:
        a = a[None, :]
    votes = np.asarray(votes, dtype=np.float64)
    c, n = a.shape
    p = votes.shape[1]
    out = np.zeros((c, k, p))
    for d in range(k):  # K is small; one masked matmul per district
        out[:, d, :] = (a == d) @ votes
    return out


def _shares(tallies) -> np.ndarray:
    """Party-0 vote share per district: (C, K) from (C, K, 2)."""
    tallies = np.asarray(tallies, dtype=np.float64)
    tot = tallies.sum(axis=-1)
    return np.divide(tallies[..., 0], tot, out=np.full(tot.shape, 0.5),
                     where=tot > 0)


def mean_median(tallies) -> np.ndarray:
    """median - mean of party-0 district vote shares, per chain: positive
    means party 0's median district exceeds its mean — an advantage for
    party 0 (gerrychain sign convention). (C,) from (C, K, 2)."""
    s = _shares(tallies)
    return np.median(s, axis=-1) - s.mean(axis=-1)


def efficiency_gap(tallies) -> np.ndarray:
    """(wasted_1 - wasted_0) / total votes, per chain. Wasted = losing
    party's full count + winner's surplus over 50%."""
    tallies = np.asarray(tallies, dtype=np.float64)
    v0, v1 = tallies[..., 0], tallies[..., 1]
    tot = v0 + v1
    need = tot / 2.0
    w0 = np.where(v0 > v1, v0 - need, v0)
    w1 = np.where(v1 >= v0, v1 - need, v1)
    total = tot.sum(axis=-1)
    return np.divide((w1 - w0).sum(axis=-1), total,
                     out=np.zeros(total.shape), where=total > 0)


def seats_won(tallies) -> np.ndarray:
    """Districts carried by party 0, per chain: (C,) int."""
    tallies = np.asarray(tallies)
    return (tallies[..., 0] > tallies[..., 1]).sum(axis=-1)
