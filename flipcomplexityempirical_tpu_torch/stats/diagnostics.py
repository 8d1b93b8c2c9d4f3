"""Autocorrelation / ESS / R-hat / mixing-time estimators over (C, T)
batched histories.

All functions take ``x`` shaped ``(n_chains, T)`` (a single chain may pass
``(T,)``; it is promoted) as numpy arrays (or host tensors) and compute
with float64 numpy on host — these are O(C T log T) post-processing steps, far off the
device hot path, and float32 autocorrelations of 1e5-step trajectories lose
meaningful precision.

The port's copy of ``flipcomplexityempirical_tpu/stats/diagnostics.py``.
"""

from __future__ import annotations

import numpy as np


def _chains(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"expected (C, T) or (T,), got shape {x.shape}")
    return x


def autocorrelation(x, max_lag: int | None = None) -> np.ndarray:
    """Per-chain normalized autocorrelation function via FFT.

    Returns ``rho`` shaped (C, max_lag + 1), ``rho[:, 0] == 1``. Chains with
    zero variance (a frozen observable) return rho = [1, 0, 0, ...].
    """
    x = _chains(x)
    c, t = x.shape
    if max_lag is None:
        max_lag = t - 1
    max_lag = min(max_lag, t - 1)
    xc = x - x.mean(axis=1, keepdims=True)
    n_fft = 1
    while n_fft < 2 * t:
        n_fft *= 2
    f = np.fft.rfft(xc, n=n_fft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=n_fft, axis=1)[:, :max_lag + 1]
    acov /= t  # biased estimator (stable tails)
    var = acov[:, :1]
    rho = np.divide(acov, var, out=np.zeros_like(acov), where=var > 0)
    rho[:, 0] = 1.0
    return rho


def integrated_autocorr_time(x, c: float = 5.0) -> np.ndarray:
    """Per-chain integrated autocorrelation time tau via Sokal's adaptive
    windowing on the chain-averaged ACF: the window M is the smallest lag
    with M >= c * tau(M). Returns tau shaped (C,); tau >= 1; for iid data
    tau ~= 1.
    """
    x = _chains(x)
    if x.shape[1] < 4:
        # shorter than any meaningful autocorrelation window (a short
        # first segment under a small checkpoint_every): tau = 1, i.e.
        # every sample counts — ess degrades gracefully to T per chain
        # instead of dividing by a window the data cannot support
        # (device twin: stats/device.ess_device, parity-tested at tiny T)
        return np.ones(x.shape[0])
    rho = autocorrelation(x)
    # chain-averaged ACF gives a lower-variance window choice, but tau is
    # reported per chain from its own ACF with the shared window
    rho_mean = rho.mean(axis=0)
    taus_run = 2.0 * np.cumsum(rho_mean) - 1.0
    lags = np.arange(len(rho_mean))
    ok = lags >= c * taus_run
    m = int(np.argmax(ok)) if ok.any() else len(rho_mean) - 1
    m = max(m, 1)
    tau = 2.0 * rho[:, :m + 1].sum(axis=1) - 1.0
    return np.maximum(tau, 1.0)


def ess(x, c: float = 5.0):
    """Effective sample size. Returns ``(ess_per_chain, ess_total)`` where
    ``ess_total = sum_i T / tau_i`` — independent chains' effective samples
    add, each discounted by its own autocorrelation time."""
    x = _chains(x)
    tau = integrated_autocorr_time(x, c=c)
    per = x.shape[1] / tau
    return per, float(per.sum())


def gelman_rubin(x) -> float:
    """Split-R-hat across chains (each chain halved, so a single chain still
    yields a diagnostic). ~1.0 at convergence; > 1.1 signals poor mixing —
    on flip walks with small ``base`` this flags exactly the bottleneck
    phases the paper studies."""
    x = _chains(x)
    c, t = x.shape
    half = t // 2
    if half < 2:
        raise ValueError("need T >= 4 for split R-hat")
    halves = np.concatenate([x[:, :half], x[:, t - half:]], axis=0)
    m, n = halves.shape
    means = halves.mean(axis=1)
    variances = halves.var(axis=1, ddof=1)
    w = variances.mean()
    b = n * means.var(ddof=1)
    if w == 0:
        # zero within-chain variance: converged only if the chains also
        # agree; chains frozen at DIFFERENT values are maximally diverged
        # (the metastable regime this diagnostic exists to flag)
        return 1.0 if b == 0 else float("inf")
    var_plus = (n - 1) / n * w + b / n
    return float(np.sqrt(var_plus / w))


def autocorr_mixing_time(x, threshold: float = np.exp(-1.0)) -> float:
    """Exponential-autocorrelation-time estimate of mixing: the first lag at
    which the chain-averaged ACF of the observable drops below ``threshold``
    (default 1/e). This is the observable-relaxation proxy for the mixing
    time the paper bounds via bottleneck ratios; ``np.inf`` when the ACF
    never crosses within the recorded horizon.
    """
    rho = autocorrelation(_chains(x)).mean(axis=0)
    below = rho < threshold
    if not below.any():
        return float("inf")
    return float(np.argmax(below))


def well_crossings(x, lo: float, hi: float) -> np.ndarray:
    """Per-chain count of well-to-well transitions of a (C, T) trajectory
    between the metastable wells ``x < lo`` and ``x > hi``.

    Samples are classified low (-1) / high (+1) / transit (0); transit
    samples are dropped; each alternation of the remaining sign sequence
    is one crossing. This is the mode-mixing observable behind
    REPLICATION.md's plain-vs-tempered comparison on the bimodal FRANK
    B333 cell (wells |cut| < 40 and |cut| > 60, where that section's
    "round trips per chain" counted exactly these crossings — a chain
    whose only crossing is the one-way initial relaxation scores 1).
    """
    x = _chains(x)
    out = np.zeros(x.shape[0], dtype=np.int64)
    for c, row in enumerate(x):
        sign = np.where(row < lo, -1, np.where(row > hi, 1, 0))
        sign = sign[sign != 0]
        if sign.size < 2:
            continue
        out[c] = int((np.diff(sign) != 0).sum())
    return out


def round_trips(x, lo: float, hi: float) -> np.ndarray:
    """Per-chain COMPLETED round trips between the wells ``x < lo`` and
    ``x > hi``: two consecutive crossings (low->high->low or
    high->low->high) make one trip, so this is ``well_crossings // 2``
    and the one-way initial relaxation scores 0 — the stricter of the
    two mode-mixing counts (see ``well_crossings``)."""
    return well_crossings(x, lo, hi) // 2
