"""The port's analytics modules against the JAX package's, on the CPU: the
numpy estimators (copies), the on-device twins (``stats/device.py``), the
summary fold (``stats/accumulators.py``: ``fold_out`` / ``fold_block``,
the plain version of ``csrc/summary_fold.cu``), ``BufferMirror``, the
diagnostics of ``DeviceAnalytics`` and the fold's wrapper
(``kernel/cuda_summary.py``) on CPU tensors. Inputs are made from a seed
with numpy and handed to both packages.

Tolerance: the numpy copies and ``integer_thresholds`` exact;
``ess_device`` within a relative 1e-3 of the JAX twin and 1 % of the host
float64 ``ess`` (the JAX tests' bar); ``gelman_rubin_device`` rtol 1e-5
with both frozen contracts exact; ``conductance_profile_device`` /
``bottleneck_ratio_device`` phi rtol 1e-6 with NaN where the JAX value is
NaN (the integer counts are exact, one float32 division); the fold's
n, kept, stride, accepts, waits, buffer and series bit-equal, mean and
wmean rtol 1e-6, m2 and wm2 rtol 1e-5 (``tests/test_accumulators.py``'s
bars: XLA may fuse the float32 fold).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flipcomplexityempirical_tpu import stats as jstats
from flipcomplexityempirical_tpu.stats import accumulators as jacc
from flipcomplexityempirical_tpu.stats import bottleneck as jbot
from flipcomplexityempirical_tpu.stats import compactness as jcomp
from flipcomplexityempirical_tpu.stats import device as jdev
from flipcomplexityempirical_tpu.stats import diagnostics as jdiag
from flipcomplexityempirical_tpu_torch import stats as tstats
from flipcomplexityempirical_tpu_torch.kernel import cuda_summary
from flipcomplexityempirical_tpu_torch.stats import accumulators as tacc
from flipcomplexityempirical_tpu_torch.stats import bottleneck as tbot
from flipcomplexityempirical_tpu_torch.stats import compactness as tcomp
from flipcomplexityempirical_tpu_torch.stats import device as tdev
from flipcomplexityempirical_tpu_torch.stats import diagnostics as tdiag


def ar1(rng, c, t, phi=0.9, offset=30.0):
    """(C, T) AR(1) trajectories, rounded to integers like cut counts."""
    x = np.zeros((c, t))
    e = rng.normal(size=(c, t))
    for i in range(1, t):
        x[:, i] = phi * x[:, i - 1] + e[:, i]
    return np.round(offset + 3 * x).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the numpy copies, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, args", [
    ("autocorrelation", ()), ("integrated_autocorr_time", ()),
    ("ess", ()), ("gelman_rubin", ()), ("autocorr_mixing_time", ()),
    ("round_trips", (27.0, 33.0)), ("well_crossings", (27.0, 33.0))],
    ids=lambda v: v if isinstance(v, str) else "")
def test_diagnostics_copy_equals_jax(name, args):
    x = ar1(np.random.default_rng(1), 4, 300)
    got = getattr(tdiag, name)(x, *args)
    want = getattr(jdiag, name)(x, *args)
    got, want = ((got, want) if isinstance(want, tuple)
                 else ((got,), (want,)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bottleneck_copy_equals_jax():
    x = ar1(np.random.default_rng(2), 3, 200)
    for fn in ("conductance_profile", "bottleneck_ratio"):
        for g, w in zip(getattr(tbot, fn)(x), getattr(jbot, fn)(x)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_compactness_copy_equals_jax():
    from flipcomplexityempirical_tpu import graphs as jgraphs
    g = jgraphs.square_grid(6)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 3, (4, g.n_nodes))
    np.testing.assert_array_equal(tcomp.cut_edge_count(a, g.edges),
                                  jcomp.cut_edge_count(a, g.edges))
    area = rng.uniform(1, 2, g.n_nodes)
    blen = rng.uniform(0.5, 1, g.edges.shape[0])
    outer = rng.uniform(0, 1, g.n_nodes)
    kw = dict(edges=g.edges, shared_perim=blen, node_area=area,
              node_exterior_perim=outer)
    for fn in ("perimeter_area", "polsby_popper"):
        got = getattr(tcomp, fn)(a, 3, **kw)
        want = getattr(jcomp, fn)(a, 3, **kw)
        for x, y in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# (a) the on-device twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,t", [(4, 1), (4, 3), (4, 4), (3, 257),
                                 (6, 1000)])
def test_ess_device_matches_jax_and_host(c, t):
    x = ar1(np.random.default_rng(c * t), c, t)
    per, total = tdev.ess_device(torch.as_tensor(x))
    jper, jtotal = jdev.ess_device(jnp.asarray(x))
    np.testing.assert_allclose(per.numpy(), np.asarray(jper), rtol=1e-3)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-3)
    _, host = jdiag.ess(x.astype(np.float64))
    assert abs(float(total) - host) <= 0.01 * host


def test_gelman_rubin_device_matches_jax():
    x = ar1(np.random.default_rng(4), 6, 400)
    x[3] += 2.0                          # one chain off, R-hat above 1
    got = float(tdev.gelman_rubin_device(torch.as_tensor(x)))
    want = float(jdev.gelman_rubin_device(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    big = x + 1e4                        # centring before halving
    np.testing.assert_allclose(
        float(tdev.gelman_rubin_device(torch.as_tensor(big))),
        float(jdev.gelman_rubin_device(jnp.asarray(big))), rtol=1e-5)


@pytest.mark.parametrize("rows, want", [
    ([[5.0] * 8, [5.0] * 8], 1.0),
    ([[5.0] * 8, [7.0] * 8], float("inf"))], ids=["agree", "disagree"])
def test_gelman_rubin_device_frozen_contracts(rows, want):
    x = np.asarray(rows, np.float32)
    assert float(tdev.gelman_rubin_device(torch.as_tensor(x))) == want
    assert float(jdev.gelman_rubin_device(jnp.asarray(x))) == want


def test_gelman_rubin_device_needs_four_steps():
    with pytest.raises(ValueError, match="T >= 4"):
        tdev.gelman_rubin_device(torch.zeros((2, 3)))


@pytest.mark.parametrize("frozen", [False, True])
def test_bottleneck_device_matches_jax(frozen):
    x = ar1(np.random.default_rng(5), 4, 300)
    if frozen:
        x[:] = 12.0
    th = tdev.integer_thresholds(torch.as_tensor(x))
    jth = jdev.integer_thresholds(jnp.asarray(x))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jth))
    # an unsorted grid is sorted, as both twins do
    perm = np.random.default_rng(6).permutation(th.numel())
    t_th, t_phi = tdev.conductance_profile_device(torch.as_tensor(x),
                                                  th[perm])
    j_th, j_phi = jdev.conductance_profile_device(jnp.asarray(x),
                                                  jth[perm])
    np.testing.assert_array_equal(t_th.numpy(), np.asarray(j_th))
    np.testing.assert_array_equal(np.isnan(t_phi.numpy()),
                                  np.isnan(np.asarray(j_phi)))
    np.testing.assert_allclose(t_phi.numpy(), np.asarray(j_phi), rtol=1e-6)
    phi, r = tdev.bottleneck_ratio_device(torch.as_tensor(x), th)
    jphi, jr = jdev.bottleneck_ratio_device(jnp.asarray(x), jth)
    if frozen:
        assert np.isnan(float(phi)) and np.isnan(float(jphi))
        assert np.isnan(float(r)) and np.isnan(float(jr))
    else:
        np.testing.assert_allclose(float(phi), float(jphi), rtol=1e-6)
        assert float(r) == float(jr)
    with pytest.raises(ValueError, match="T >= 2"):
        tdev.conductance_profile_device(torch.zeros((2, 1)), th)


# ---------------------------------------------------------------------------
# (b) the summary fold against the JAX fold
# ---------------------------------------------------------------------------

def block(seed, t, c, integer=True, nan_every=0):
    rng = np.random.default_rng(seed)
    x = (rng.integers(5, 60, (t, c)).astype(np.int32) if integer
         else rng.normal(20.0, 3.0, (t, c)).astype(np.float32))
    rows = {"cut_count": x,
            "wait": rng.integers(0, 4, (t, c)).astype(np.float32),
            "accepts": np.cumsum(rng.integers(0, 2, (t, c)),
                                 axis=0).astype(np.int32),
            "slope": rng.normal(size=(t, c)).astype(np.float32),
            "angle": rng.normal(size=(t, c)).astype(np.float32)}
    if nan_every:
        rows["slope"][::nan_every] = np.nan
        rows["angle"][1::nan_every] = np.nan
    return rows


def assert_acc_matches(got, want):
    for k in ("n", "kept", "stride", "accepts", "waits", "wsum"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(got.buf.numpy(), np.asarray(want.buf))
    for k, rtol in (("mean", 1e-6), ("wmean", 1e-6), ("m2", 1e-5),
                    ("wm2", 1e-5)):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=rtol,
                                   err_msg=k)
    assert sorted(got.series) == sorted(want.series)
    for k in got.series:
        np.testing.assert_array_equal(got.series[k].numpy(),
                                      np.asarray(want.series[k]),
                                      err_msg=k)


@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("integer", [True, False], ids=["cut", "float"])
@pytest.mark.parametrize("keys", ["all", "no_wait", "observable"])
def test_fold_block_matches_jax(cap, integer, keys):
    """Two blocks in turn, so the second starts mid-schedule; the buffer
    decimates several times within each; the series cap (250) is below
    the rows folded (300), so the clamped write is exercised."""
    rows = block(7, 150, 5, integer=integer, nan_every=7)
    if keys == "no_wait":
        del rows["wait"]
    elif keys == "observable":
        rows = {"cut_count": rows["cut_count"]}
    series = ("slope", "angle") if "slope" in rows else ()
    j = jacc.init_summary(5, cap=cap, series_keys=series, series_cap=250)
    t = tacc.init_summary(5, cap=cap, series_keys=series, series_cap=250)
    for half in (slice(0, 150), slice(0, 150)):
        part = {k: v[half] for k, v in rows.items()}
        j = jacc.fold_block(j, {k: jnp.asarray(v) for k, v in part.items()})
        t = tacc.fold_block(t, {k: torch.as_tensor(v)
                                for k, v in part.items()})
    assert int(t.n) == 300
    assert_acc_matches(t, j)


def test_fold_out_matches_jax_step_by_step():
    rows = block(8, 40, 3, nan_every=5)
    j = jacc.init_summary(3, cap=8, series_keys=("slope",), series_cap=40)
    t = tacc.init_summary(3, cap=8, series_keys=("slope",), series_cap=40)
    for i in range(40):
        j = jacc.fold_out(j, {k: jnp.asarray(v[i]) for k, v in rows.items()})
        t = tacc.fold_out(t, {k: torch.as_tensor(v[i])
                              for k, v in rows.items()})
    assert_acc_matches(t, j)


@pytest.mark.parametrize("cap", [8, 16, 4096])
def test_buffer_mirror_matches_jax_and_fold(cap):
    for steps in range(301):
        jm, tm = jacc.BufferMirror(cap), tacc.BufferMirror(cap)
        jm.advance(steps)
        tm.advance(steps)
        assert (tm.n, tm.kept, tm.stride) == (jm.n, jm.kept, jm.stride)
    x = block(9, 300, 2)["cut_count"]
    acc = tacc.fold_block(tacc.init_summary(2, cap=cap),
                          {"cut_count": torch.as_tensor(x)})
    assert (int(acc.n), int(acc.kept), int(acc.stride)) == (
        tm.n, tm.kept, tm.stride)


def test_summary_readbacks_and_diagnostics_match_jax():
    x = ar1(np.random.default_rng(10), 4, 200).T.copy()       # (T, C)
    jana, tana = jacc.DeviceAnalytics(4, cap=64), tacc.DeviceAnalytics(
        4, cap=64)
    jana.update(jacc.fold_block(jana.acc, {"cut_count": jnp.asarray(x)}),
                200)
    tana.update(tacc.fold_block(tana.acc, {"cut_count": torch.as_tensor(x)}),
                200)
    assert tacc.summary_nbytes(tana.acc) == jacc.summary_nbytes(jana.acc)
    got, want = tana.summary_to_host(), jana.summary_to_host()
    assert list(got) == list(want) == list(tacc.SUMMARY_FIELDS)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
    rhat, ess = tana.maybe_diagnostics(force=True)
    jrhat, jess = jana.maybe_diagnostics(force=True)
    np.testing.assert_allclose(rhat, jrhat, rtol=1e-5)
    np.testing.assert_allclose(ess, jess, rtol=1e-3)
    assert tana.readback_bytes == jana.readback_bytes
    assert tana.chunk_readback_bytes() == jana.chunk_readback_bytes()
    with pytest.raises(ValueError, match=">= 4 kept"):
        tacc.summary_diagnostics(tacc.init_summary(2), 3)


def test_series_host_trims_and_counts():
    rows = block(11, 30, 2)
    ana = tacc.DeviceAnalytics(2, series_keys=("slope", "angle"),
                               series_cap=50)
    ana.update(tacc.fold_block(ana.acc, {k: torch.as_tensor(v)
                                         for k, v in rows.items()}), 30)
    s = ana.series_host()
    np.testing.assert_array_equal(s["slope"], rows["slope"][:, 0])
    assert ana.readback_bytes == 2 * 30 * 4


@pytest.mark.parametrize("kw, words", [
    (dict(cap=6), "even and >= 8"), (dict(cap=9), "even and >= 8"),
    (dict(series_keys=("slope",)), "positive series_cap")])
def test_init_summary_checks(kw, words):
    with pytest.raises(ValueError, match=words):
        tacc.init_summary(2, **kw)
    with pytest.raises(ValueError, match=words):
        jacc.init_summary(2, **kw)


def test_summary_allreduce_waits_for_multiple_gpus():
    with pytest.raises(ValueError, match="A10"):
        tacc.summary_allreduce({}, "chains")


def test_stats_names_match_jax():
    assert set(jstats.__all__) <= set(tstats.__all__)


# ---------------------------------------------------------------------------
# the fold's wrapper on the host
# ---------------------------------------------------------------------------

def test_summary_fold_on_cpu_is_the_plain_version():
    rows = {k: torch.as_tensor(v) for k, v in block(12, 64, 4,
                                                    nan_every=3).items()}
    launches = cuda_summary.summary_fold.launches
    a = tacc.init_summary(4, cap=8, series_keys=("slope", "angle"),
                          series_cap=64)
    b = a.clone()
    a = cuda_summary.summary_fold(a, rows)
    b = tacc.fold_block(b, rows)
    assert cuda_summary.summary_fold.launches == launches
    for k in tacc.SUMMARY_FIELDS + ("buf",):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    for k in a.series:
        assert torch.equal(a.series[k].view(torch.int32),
                           b.series[k].view(torch.int32)), k


@pytest.mark.parametrize("bad, words", [
    (dict(cut_count=torch.zeros((5, 3), dtype=torch.int64)), "dtype"),
    (dict(cut_count=torch.zeros((5, 2), dtype=torch.int32)), "chains"),
    (dict(wait=torch.zeros((5, 3), dtype=torch.float64)), "'wait'"),
    (dict(slope=None), "series 'slope'"),
    (dict(cut_count=None), "observable")])
def test_summary_fold_refuses_what_the_kernel_does_not_take(bad, words):
    rows = {"cut_count": torch.zeros((5, 3), dtype=torch.int32),
            "wait": torch.zeros((5, 3)), "slope": torch.zeros((5, 3))}
    rows.update(bad)
    rows = {k: v for k, v in rows.items() if v is not None}
    acc = tacc.init_summary(3, series_keys=("slope",), series_cap=5)
    with pytest.raises(ValueError, match=words):
        cuda_summary.summary_fold(acc, rows)
