"""Bottleneck-ratio (conductance) estimation from chain trajectories.

The paper's central objects are bottleneck ratios: for a set S of states,
Phi(S) = Q(S, S^c) / pi(S) where Q is the edge measure of the chain. A small
Phi(S) certifies slow mixing (Cheeger: t_mix >= 1/(4 Phi)). Exact state-space
enumeration is exponential, but along a scalar observable f (cut count,
signed imbalance, ...) the level sets S_r = {x : f(x) <= r} have empirically
estimable conductance: pi(S_r) from occupation frequencies and Q(S_r, S_r^c)
from observed boundary crossings. The minimum over r is the trajectory
bottleneck ratio — the "CPU bottleneck-ratio estimates" the BASELINE.json
north star says must be reproduced, now fed by (C, T) batched histories.

The port's copy of ``flipcomplexityempirical_tpu/stats/bottleneck.py``.
"""

from __future__ import annotations

import numpy as np


def conductance_profile(x, thresholds=None):
    """Estimate Phi(S_r) for level sets S_r = {f <= r} of observable ``x``
    shaped (C, T) (or (T,)).

    Pools transitions across chains (each chain contributes T-1 transitions).
    Returns ``(thresholds, phi)`` with ``phi[i] = (crossings out of S_r /
    n_transitions) / min(occupancy, 1 - occupancy)`` — the symmetric form
    Phi(S) = Q(S, S^c) / min(pi(S), pi(S^c)), NaN where the level set (or
    its complement) is never visited.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    c, t = x.shape
    if t < 2:
        raise ValueError("need T >= 2 transitions")
    if thresholds is None:
        uniq = np.unique(x)
        thresholds = uniq if len(uniq) <= 256 else \
            np.linspace(uniq[0], uniq[-1], 257)
    thresholds = np.sort(np.asarray(thresholds, dtype=np.float64))

    cur, nxt = x[:, :-1].ravel(), x[:, 1:].ravel()
    n_trans = cur.size
    nb = len(thresholds)
    # Bin once instead of scanning per threshold (O(C*T + B)):
    # b(v) = index of the first threshold >= v, so v <= thresholds[i]
    # iff b(v) <= i.
    bc = np.searchsorted(thresholds, cur, side="left")
    bn = np.searchsorted(thresholds, nxt, side="left")
    # occupancy of S_i = fraction with b(cur) <= i
    occ = np.cumsum(np.bincount(bc, minlength=nb + 1)[:nb]) / n_trans
    # a transition crosses out of S_i iff b(cur) <= i < b(nxt): contributes
    # to i in [b(cur), b(nxt)); accumulate via a difference array
    out = bc < bn
    diff = (np.bincount(bc[out], minlength=nb + 1)
            - np.bincount(bn[out], minlength=nb + 1))
    crossings = np.cumsum(diff[:nb])
    two_sided = (occ > 0.0) & (occ < 1.0)
    phi = np.full(nb, np.nan)
    denom = np.minimum(occ, 1.0 - occ)
    phi[two_sided] = (crossings[two_sided] / n_trans) / denom[two_sided]
    return thresholds, phi


def bottleneck_ratio(x, thresholds=None) -> tuple[float, float]:
    """The trajectory bottleneck ratio: ``min_r Phi(S_r)`` over the observed
    level sets, with the minimizing threshold. Returns ``(phi_star, r_star)``;
    ``(nan, nan)`` when no level set is two-sided (frozen observable)."""
    thresholds, phi = conductance_profile(x, thresholds)
    if np.all(np.isnan(phi)):
        return float("nan"), float("nan")
    i = int(np.nanargmin(phi))
    return float(phi[i]), float(thresholds[i])
