"""Device-resident analytics: the summary accumulator that a run folds its
rows into on the card, so a sweep never copies its (C, T) history to the
host.

Port of ``flipcomplexityempirical_tpu/stats/accumulators.py``. A
:class:`SummaryAcc` holds, per chain, Welford moments of the observable
(``n``/``mean``/``m2``), the lazy-uniform weighted moments (weight
``1 + wait``: ``wsum``/``wmean``/``wm2``), the cumulative accepts and
waits, a stride-doubling thinning buffer (``buf``/``kept``/``stride``:
keep when ``n % stride == 0``, decimate ``[::2]`` and double the stride
at ``cap``) for split R-hat and ESS, and optional full-length chain-0
series (the interface ``slope``/``angle`` the artifacts render), written
by global step index.

The runners fold each chunk's (T, C) rows after the chunk kernel with
``kernel.cuda_summary.summary_fold``: on the card the hand-written kernel
of ``csrc/summary_fold.cu``, on the host ``fold_block`` here, the plain
version. ``fold_block`` computes ``fold_out`` of the JAX package step by
step in its float32 order; ``fold_out`` is ``fold_block`` of one row.
Both update the accumulator's tensors in place (the buffer and series
included) and return it with fresh ``n``/``kept``/``stride`` scalars.

``BufferMirror`` replays the buffer's schedule on the host from step
counts alone, so ``DeviceAnalytics`` knows ``kept``/``stride`` without a
readback and refreshes R-hat/ESS when the kept count doubles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import ess_device, gelman_rubin_device

# the summary() fields, in emission order
SUMMARY_FIELDS = ("n", "mean", "m2", "wsum", "wmean", "wm2", "accepts",
                  "waits", "kept", "stride")


@dataclasses.dataclass
class SummaryAcc:
    """The summary accumulator of one run, on the run's device."""

    n: torch.Tensor        # () int32   samples folded
    mean: torch.Tensor     # (C,) f32   per-chain running mean
    m2: torch.Tensor       # (C,) f32   per-chain sum of squared deviations
    wsum: torch.Tensor     # (C,) f32   lazy-uniform total weight
    wmean: torch.Tensor    # (C,) f32   lazy-uniform weighted mean
    wm2: torch.Tensor      # (C,) f32   lazy-uniform weighted M2
    accepts: torch.Tensor  # (C,) i32   cumulative accepts at the last fold
    waits: torch.Tensor    # (C,) f32   cumulative waits folded
    buf: torch.Tensor      # (C, cap) f32 stride-doubling thinning buffer
    kept: torch.Tensor     # () int32   live columns of ``buf``
    stride: torch.Tensor   # () int32   current keep-stride
    series: dict           # name -> (series_cap,) f32 chain-0 series
    observable: str = "cut_count"

    def replace(self, **kw) -> "SummaryAcc":
        return dataclasses.replace(self, **kw)

    def clone(self) -> "SummaryAcc":
        """A copy with tensors of its own (the folds update in place)."""
        return self.replace(
            **{f.name: getattr(self, f.name).clone()
               for f in dataclasses.fields(self)
               if isinstance(getattr(self, f.name), torch.Tensor)},
            series={k: v.clone() for k, v in self.series.items()})


def init_summary(n_chains: int, *, cap: int = 4096,
                 observable: str = "cut_count", series_keys=(),
                 series_cap: int = 0, device="cpu") -> SummaryAcc:
    """A fresh accumulator for ``n_chains`` chains on ``device``. ``cap``
    (even, >= 8) bounds the thinning buffer; ``series_keys`` asks for
    full-length chain-0 series of ``series_cap`` entries each (the run's
    total recorded steps)."""
    cap = int(cap)
    if cap < 8 or cap % 2:
        raise ValueError("summary buffer cap must be even and >= 8")
    if series_keys and series_cap <= 0:
        raise ValueError("series_keys needs a positive series_cap")

    def zc():
        return torch.zeros((n_chains,), dtype=torch.float32, device=device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=device)

    return SummaryAcc(
        n=scalar(0), mean=zc(), m2=zc(), wsum=zc(), wmean=zc(), wm2=zc(),
        accepts=torch.zeros((n_chains,), dtype=torch.int32, device=device),
        waits=zc(),
        buf=torch.zeros((n_chains, cap), dtype=torch.float32,
                        device=device),
        kept=scalar(0), stride=scalar(1),
        series={k: torch.zeros((int(series_cap),), dtype=torch.float32,
                               device=device) for k in series_keys},
        observable=observable)


def fold_block(acc: SummaryAcc, rows: dict) -> SummaryAcc:
    """The plain version of the fold kernel: fold the (T, C) ``rows`` (the
    chunk's history rows: the observable, ``wait`` where present, the
    ``accepts`` and the series keys) one step at a time, in the JAX
    package's ``fold_out`` float32 order. The schedule of the buffer
    (keep, decimate) follows from ``n``/``kept``/``stride``, read once."""
    x_all = rows[acc.observable]
    t_len = x_all.shape[0]
    n, kept, stride = (int(v) for v in
                       torch.stack([acc.n, acc.kept, acc.stride]).tolist())
    if t_len == 0:
        return acc
    dev = acc.mean.device
    cap = acc.buf.shape[1]
    x_all = x_all.to(torch.float32)
    # (n + 1) as int32, then float32, as the JAX fold computes it
    n1_all = torch.arange(n + 1, n + t_len + 1, dtype=torch.int32,
                          device=dev).to(torch.float32)
    wait = rows.get("wait")
    if wait is not None:
        wait = wait.to(torch.float32)
        w_all = 1.0 + wait
    mean, m2, wsum, wmean, wm2, waits, buf = (
        acc.mean, acc.m2, acc.wsum, acc.wmean, acc.wm2, acc.waits, acc.buf)
    src = {k: rows[k] for k in acc.series}
    scap = {k: v.shape[0] for k, v in acc.series.items()}
    for t in range(t_len):
        x = x_all[t]
        delta = x - mean
        new_mean = mean + delta / n1_all[t]
        m2.add_(delta * (x - new_mean))
        mean.copy_(new_mean)
        w = w_all[t] if wait is not None else torch.ones_like(x)
        wsum.add_(w)
        wd = x - wmean
        wmean.add_(wd * (w / wsum))
        wm2.add_(w * wd * (x - wmean))
        if wait is not None:
            waits.add_(wait[t])
        if n % stride == 0:
            if kept >= cap:
                # decimate-then-append equals the host's append-then-
                # decimate because cap is even
                buf[:, :cap // 2] = buf[:, ::2].clone()
                buf[:, cap // 2:] = 0.0
                kept, stride = cap // 2, stride * 2
            buf[:, kept] = x
            kept += 1
        for k, s in acc.series.items():
            # the JAX write clamps its start index to series_cap - 1
            s[min(n, scap[k] - 1)] = src[k][t, 0].to(torch.float32)
        n += 1
    if "accepts" in rows:
        acc.accepts.copy_(rows["accepts"][-1].to(torch.int32))
    nks = torch.tensor([n, kept, stride], dtype=torch.int32, device=dev)
    return acc.replace(n=nks[0], kept=nks[1], stride=nks[2])


def fold_out(acc: SummaryAcc, out: dict) -> SummaryAcc:
    """Fold one yield's record ``out`` ({name: (C,)}): ``fold_block`` of
    one row."""
    keys = {acc.observable, "wait", "accepts", *acc.series}
    return fold_block(acc, {k: v[None] for k, v in out.items()
                            if k in keys})


def summary(acc: SummaryAcc) -> dict:
    """The small summary: every field O(C) or a scalar (the buffer and
    series stay on the device), in SUMMARY_FIELDS order."""
    return {k: getattr(acc, k) for k in SUMMARY_FIELDS}


def summary_nbytes(acc_or_summary) -> int:
    """The bytes of one summary's readback."""
    s = (summary(acc_or_summary) if isinstance(acc_or_summary, SummaryAcc)
         else acc_or_summary)
    return int(sum(v.numel() * v.element_size() for v in s.values()))


def summary_host(acc_or_summary) -> dict:
    """The summary copied to the host (numpy arrays)."""
    s = (summary(acc_or_summary) if isinstance(acc_or_summary, SummaryAcc)
         else acc_or_summary)
    return {k: v.cpu().numpy() for k, v in s.items()}


def summary_diagnostics(acc: SummaryAcc, filled: int):
    """Split R-hat and Sokal ESS over the buffer's live prefix on its
    device: ``(rhat (), ess_total ())`` tensors. ``filled`` (>= 4) comes
    from the host's BufferMirror; the caller scales the ESS by the
    mirrored stride."""
    if filled < 4:
        raise ValueError("summary_diagnostics needs >= 4 kept samples")
    window = acc.buf[:, :int(filled)]
    rhat = gelman_rubin_device(window)
    _, ess_total = ess_device(window)
    return rhat, ess_total


def summary_allreduce(s: dict, axis_name: str) -> dict:
    """The mesh form of a summary waits for ROADMAP.md A10."""
    raise ValueError("summary_allreduce: summaries across cards wait for "
                     "ROADMAP.md A10 (multiple GPUs)")


class BufferMirror:
    """Host replay of the buffer's schedule: ``kept``/``stride``/``n``
    follow from the samples seen and the cap alone."""

    def __init__(self, cap: int = 4096):
        self.cap = int(cap)
        self.n = 0
        self.kept = 0
        self.stride = 1

    def advance(self, steps: int) -> None:
        for _ in range(int(steps)):
            if self.n % self.stride == 0:
                if self.kept >= self.cap:
                    self.kept = self.cap // 2
                    self.stride *= 2
                self.kept += 1
            self.n += 1


class DeviceAnalytics:
    """Host coordinator of one run's device-resident analytics: the
    accumulator (replaced by each fold's result), the host
    :class:`BufferMirror`, and the diagnostics refresh (when the kept
    count has doubled, and at a forced refresh). Nothing here reads the
    device implicitly: ``summary_to_host``, ``maybe_diagnostics`` and
    ``series_host`` are the readbacks, counted in ``readback_bytes``."""

    def __init__(self, n_chains: int, *, cap: int = 4096,
                 observable: str = "cut_count", series_keys=(),
                 series_cap: int = 0, device="cpu"):
        self.acc = init_summary(n_chains, cap=cap, observable=observable,
                                series_keys=series_keys,
                                series_cap=series_cap, device=device)
        self.mirror = BufferMirror(cap)
        self.rhat = None          # the latest diagnostics (host floats)
        self.ess = None
        self._diag_at = 0         # kept count at the last refresh
        self.readback_bytes = 0   # cumulative explicit readback

    def update(self, acc: SummaryAcc, steps: int) -> None:
        """Adopt the accumulator after a fold of ``steps`` rows."""
        self.acc = acc
        self.mirror.advance(steps)

    def summary_refs(self) -> dict:
        """The small summary's tensors on the device, no copy."""
        return summary(self.acc)

    def chunk_readback_bytes(self) -> int:
        return summary_nbytes(self.acc)

    def summary_to_host(self) -> dict:
        s = summary_host(self.acc)
        self.readback_bytes += summary_nbytes(self.acc)
        return s

    def maybe_diagnostics(self, force: bool = False):
        """Refresh (rhat, ess) from the device buffer when the kept count
        has doubled since the last refresh (or ``force``). Returns the
        current, possibly stale, values."""
        filled = self.mirror.kept
        if filled >= 4 and (force or filled >= 2 * max(self._diag_at, 2)):
            rhat_d, ess_d = summary_diagnostics(self.acc, filled)
            rhat = float(rhat_d)
            ess = float(ess_d) * self.mirror.stride
            self.rhat = rhat if np.isfinite(rhat) else None
            self.ess = ess if np.isfinite(ess) else None
            self._diag_at = filled
            self.readback_bytes += 8
        return self.rhat, self.ess

    def series_host(self) -> dict:
        """The chain-0 series copied to the host once, trimmed to the
        folded length."""
        t = self.mirror.n
        out = {}
        for k, v in self.acc.series.items():
            out[k] = v.cpu().numpy()[:t]
            self.readback_bytes += out[k].nbytes
        return out
