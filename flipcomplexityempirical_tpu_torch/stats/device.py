"""On-device diagnostics of a (C, T) history tensor: ESS, split R-hat and
the bottleneck ratio, without copying the history to the host.

Port of ``flipcomplexityempirical_tpu/stats/device.py``, as torch ops on
the history's own device (they run at a diagnostics refresh or at a run's
end, never a step, so no kernel of their own). Each function is the twin
of a host estimator of ``diagnostics.py`` / ``bottleneck.py`` in float32:

- ``ess_device``: the Sokal-windowed integrated-autocorrelation ESS
  (FFT autocovariance at the host's ``n_fft``, biased normalisation,
  chain-averaged ACF choosing the window M = min{m : m >= c * tau(m)},
  per-chain tau over the shared window, tau >= 1), the window applied as
  a masked sum;
- ``conductance_profile_device`` / ``bottleneck_ratio_device``: Phi(S_r)
  over the level sets S_r = {f <= r}, the occupancy and crossing counts
  exact in integers and one final float32 division;
- ``gelman_rubin_device``: split R-hat, centred on the grand mean before
  halving, with the JAX twin's two frozen floors;
- ``integer_thresholds``: the integer level-set grid spanning a history,
  from one readback of its minimum and maximum.
"""

from __future__ import annotations

import math

import torch


def _chains(x) -> torch.Tensor:
    x = torch.as_tensor(x).to(torch.float32)
    return x[None, :] if x.ndim == 1 else x


def ess_device(x, c: float = 5.0):
    """Effective sample size of a (C, T) history on its device:
    ``(ess_per_chain (C,), ess_total ())`` as tensors, matching
    ``diagnostics.ess`` (independent chains add, each discounted by its
    own integrated autocorrelation time)."""
    x = _chains(x)
    ch, t = x.shape
    if t < 4:
        # the host's tiny-T rule: tau = 1, ess = T per chain
        per = torch.full((ch,), float(t), dtype=torch.float32,
                         device=x.device)
        return per, per.sum()
    xc = x - x.mean(dim=1, keepdim=True)
    n_fft = 1
    while n_fft < 2 * t:
        n_fft *= 2
    f = torch.fft.rfft(xc, n=n_fft, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=1)[:, :t] / t
    var = acov[:, :1]
    pos = var > 0
    rho = torch.where(pos, acov / torch.where(pos, var, torch.ones_like(var)),
                      torch.zeros_like(acov))
    rho[:, 0] = 1.0

    rho_mean = rho.mean(dim=0)
    taus_run = 2.0 * torch.cumsum(rho_mean, dim=0) - 1.0
    lags = torch.arange(t, dtype=torch.float32, device=x.device)
    ok = lags >= c * taus_run
    # argmax of the 0/1 mask is its first True
    m = torch.where(ok.any(), ok.to(torch.uint8).argmax(),
                    torch.tensor(t - 1, device=x.device))
    m = torch.clamp(m, min=1)
    window = (torch.arange(t, device=x.device) <= m).to(torch.float32)
    tau = torch.clamp(2.0 * (rho * window[None, :]).sum(dim=1) - 1.0,
                      min=1.0)
    per = t / tau
    return per, per.sum()


def conductance_profile_device(x, thresholds):
    """Twin of ``bottleneck.conductance_profile`` on a (C, T) history's
    device: ``(sorted thresholds, phi)``, phi NaN where the level set is
    not two-sided. ``thresholds`` is a concrete grid (``integer_thresholds``
    for cut counts), sorted here as the host twin sorts it."""
    x = _chains(x)
    if x.shape[1] < 2:
        raise ValueError("need T >= 2 transitions")
    thresholds = torch.sort(torch.as_tensor(thresholds).to(
        device=x.device, dtype=torch.float32)).values
    nb = thresholds.shape[0]
    cur = x[:, :-1].reshape(-1)
    nxt = x[:, 1:].reshape(-1)
    n_trans = cur.shape[0]
    # b(v) = first threshold index >= v, so v <= thresholds[i] iff b(v) <= i
    bc = torch.searchsorted(thresholds, cur, side="left")
    bn = torch.searchsorted(thresholds, nxt, side="left")
    counts = torch.cumsum(torch.bincount(bc, minlength=nb + 1)[:nb], dim=0)
    # transitions crossing out of S_i (b(cur) <= i < b(nxt)), by a
    # difference array; the others park in the dropped slot nb
    out = bc < bn
    parked = torch.full_like(bc, nb)
    diff = (torch.bincount(torch.where(out, bc, parked), minlength=nb + 1)
            - torch.bincount(torch.where(out, bn, parked), minlength=nb + 1))
    crossings = torch.cumsum(diff[:nb], dim=0)
    # exact integers up to the one final float32 division
    two_sided = (counts > 0) & (counts < n_trans)
    min_count = torch.minimum(counts, n_trans - counts)
    phi = torch.where(
        two_sided,
        crossings.to(torch.float32)
        / torch.where(two_sided, min_count,
                      torch.ones_like(min_count)).to(torch.float32),
        torch.full_like(thresholds, math.nan))
    return thresholds, phi


def bottleneck_ratio_device(x, thresholds):
    """Twin of ``bottleneck.bottleneck_ratio``: ``(phi_star, r_star)``
    tensors, the least Phi(S_r) and its threshold (the first at a tie),
    both NaN when no level set is two-sided."""
    thresholds, phi = conductance_profile_device(x, thresholds)
    filled = torch.where(torch.isnan(phi), torch.full_like(phi, math.inf),
                         phi)
    i = torch.argmin(filled)
    bad = torch.isinf(filled[i])
    nan = torch.tensor(math.nan, device=phi.device)
    return torch.where(bad, nan, phi[i]), torch.where(bad, nan,
                                                      thresholds[i])


def gelman_rubin_device(x):
    """Twin of ``diagnostics.gelman_rubin`` (split R-hat) on the
    history's device, a 0-d tensor: 1.0 when every half-chain is constant
    and they agree, inf when constant halves disagree."""
    x = _chains(x)
    t = x.shape[1]
    half = t // 2
    if half < 2:
        raise ValueError("need T >= 4 for split R-hat")
    # centred on the grand mean before halving: the float32 residue of
    # the variance then scales with the centred magnitude
    scale = x.abs().max()
    x = x - x.mean()
    halves = torch.cat([x[:, :half], x[:, t - half:]], dim=0)
    n = halves.shape[1]
    means = halves.mean(dim=1)
    variances = halves.var(dim=1, correction=1)
    w = variances.mean()
    b = n * means.var(correction=1)
    var_plus = (n - 1) / n * w + b / n
    # the frozen floors, scale-relative against the raw scale
    frozen = w <= 1e-10 * scale * scale + 1e-30
    spread = means.max() - means.min()
    one = torch.ones_like(w)
    return torch.where(
        ~frozen, torch.sqrt(var_plus / torch.where(frozen, one, w)),
        torch.where(spread > 1e-6 * scale, torch.full_like(w, math.inf),
                    one))


def integer_thresholds(x):
    """The integer level-set grid spanning a history's range, on its
    device: one readback of its minimum and maximum."""
    x = torch.as_tensor(x)
    lo, hi = (float(v) for v in
              torch.stack([x.min(), x.max()]).to(torch.float32).cpu())
    return torch.arange(math.floor(lo), math.ceil(hi) + 1.0,
                        dtype=torch.float32, device=x.device)
