"""Summary mode in the port's runners against the JAX package's runners in
summary mode, on the CPU: twins of ``tests/test_accumulators.py``'s
``test_board_runner_summary_parity``, ``test_general_runner_summary_parity``
(both kernel paths) and ``test_lowered_bits_series_parity`` (sec11 with the
interface). Both packages start from the same seed; the JAX package runs
its int8 board bodies (``bits=False``, bit-identical to the packed ones
and quick to compile) with its history kept beside the fold, the port
the bodies its kernels equal.

Within the port the trajectory is bit-identical with the fold on or off,
and the accumulator equals ``fold_block`` of the history-mode rows bit
for bit: on the CPU a chunk kernel's fused fold (``acc=`` on
``cuda_lowered.run_chunk`` and ``cuda_dense.run_general_dense_chunk_cuda``)
is the plain chunk and then ``fold_block``, so these runs hold it too,
with small buffer caps that halve inside a chunk and end a chunk in the
middle of a stride, and two series keys. Against the JAX runners (tolerance of
``test_torch_analytics.py``): n, kept, stride, accepts and the buffer
bit-equal, mean rtol 1e-6 and m2 rtol 1e-5, the wait-weighted fields the
same where no wait differs (``_parity``'s log-tie rule), the series
within 4 ulp with NaN where the JAX value is NaN.
"""

import numpy as np
import pytest
import torch
from _parity import assert_ulps_close, assert_waits_close

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.stats import accumulators as jacc
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch import sampling
from flipcomplexityempirical_tpu_torch.stats import accumulators as tacc

from _torch_parity import spec_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows_of(history, keys=("cut_count", "wait", "accepts")):
    """A history's (C, T) keys as the fold's (T, C) rows."""
    return {k: torch.as_tensor(np.asarray(history[k])).T.contiguous()
            for k in keys if k in history}


def assert_acc_equal(got, want):
    """Two of the port's accumulators, bit for bit."""
    for k in tacc.SUMMARY_FIELDS + ("buf",):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in want.series:
        assert torch.equal(got.series[k].view(torch.int32),
                           want.series[k].view(torch.int32)), k


def assert_acc_close_to_jax(got, want, n_bad):
    for k in ("n", "kept", "stride", "accepts", "buf"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-6)
    np.testing.assert_allclose(got.m2.numpy(), np.asarray(want.m2),
                               rtol=1e-5)
    if n_bad == 0:
        for k in ("waits", "wsum"):
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)),
                                          err_msg=k)
        np.testing.assert_allclose(got.wmean.numpy(),
                                   np.asarray(want.wmean), rtol=1e-6)
        np.testing.assert_allclose(got.wm2.numpy(), np.asarray(want.wm2),
                                   rtol=1e-5)


def board_pair(interface=False, chains=4):
    if interface:
        g, tg = fce.graphs.grid_sec11(), tgraphs.grid_sec11()
        plan = fce.graphs.sec11_plan(g, alignment=0)
        spec = fce.Spec(n_districts=2, proposal="bi", contiguity="patch",
                        invalid="repropose", accept="cut",
                        parity_metrics=True, geom_waits=True,
                        record_interface=True)
    else:
        g, tg = fce.graphs.square_grid(8), tgraphs.square_grid(8)
        plan = fce.graphs.stripes_plan(g, 2)
        spec = fce.Spec(contiguity="patch")
    want = fce.sampling.init_board(g, plan, n_chains=chains, seed=11,
                                   spec=spec, base=1.4, pop_tol=0.3)
    got = sampling.init_board(tg, plan, n_chains=chains, seed=11,
                              spec=spec_port(spec), base=1.4, pop_tol=0.3,
                              device="cpu")
    return spec, want, got


@pytest.mark.parametrize("cap,chunk", [(4096, 8), (8, 6)])
def test_board_runner_summary_parity(cap, chunk):
    """29 yields in chunks of 8 or 6 (a partial final chunk); at cap 8 the
    buffer halves inside the second and third chunks (n=8, 16) and the
    third ends in the middle of a stride of 4."""
    spec, (bg, st, params), (tbg, tst, tpar) = board_pair()
    tspec = spec_port(spec)
    jana = jacc.DeviceAnalytics(4, cap=cap)
    jhist = fce.sampling.run_board(bg, spec, params, st, n_steps=29,
                                   chunk=chunk, bits=False, analytics=jana)
    hist = sampling.run_board(tbg, tspec, tpar, tst, n_steps=29,
                              chunk=chunk, device="cpu")
    ana = tacc.DeviceAnalytics(4, cap=cap)
    summ = sampling.run_board(tbg, tspec, tpar, tst, n_steps=29,
                              chunk=chunk,
                              record_history=False, device="cpu",
                              analytics=ana)
    assert summ.history == {}
    assert torch.equal(summ.state.board, hist.state.board)
    np.testing.assert_array_equal(summ.waits_total, hist.waits_total)
    assert ana.mirror.n == int(ana.acc.n) == 29
    assert int(ana.acc.stride) == (1 if cap == 4096 else 4)
    assert_acc_equal(ana.acc, tacc.fold_block(tacc.init_summary(4, cap=cap),
                                              rows_of(hist.history)))
    n_bad = assert_waits_close(hist.history["wait"],
                               jhist.history["wait"]).sum()
    assert_acc_close_to_jax(ana.acc, jana.acc, n_bad)


def general_pair(kernel_path, chains=6, **spec_kw):
    if kernel_path == "general_dense":
        g, tg = fce.graphs.hex_lattice(4, 4), tgraphs.hex_lattice(4, 4)
        spec = fce.Spec(n_districts=2, proposal="bi", contiguity="patch",
                        geom_waits=True, parity_metrics=False, **spec_kw)
    else:
        g, tg = fce.graphs.square_grid(6), tgraphs.square_grid(6)
        spec = fce.Spec(contiguity="patch")
    plan = fce.graphs.stripes_plan(g, 2)
    want = fce.init_batch(g, plan, n_chains=chains, seed=3, spec=spec,
                          base=1.4, pop_tol=0.35)
    got = sampling.init_batch(tg, plan, n_chains=chains, seed=3,
                              spec=spec_port(spec), base=1.4, pop_tol=0.35,
                              device="cpu")
    return spec, want, got


@pytest.mark.parametrize("kernel_path,cap,keys", [
    ("general", 4096, ()),
    ("general_dense", 4096, ()),
    ("general_dense", 8, ("wait", "weight")),
])
def test_general_runner_summary_parity(kernel_path, cap, keys):
    """41 yields in chunks of 16 (a partial final chunk), the initial
    record folded; at cap 8 (under lazy_uniform, which records the
    weight) the buffer halves inside the first two chunks (n=8, 16, 32),
    the second starts in the middle of a stride, and chain 0's series of
    two keys is kept."""
    spec, (dg, st, params), (tdg, tst, tpar) = general_pair(
        kernel_path, **({"lazy_uniform": True} if keys else {}))
    tspec = spec_port(spec)
    jana = jacc.DeviceAnalytics(6, cap=cap, series_keys=keys,
                                series_cap=41)
    jhist = fce.run_chains(dg, spec, params, st, n_steps=41, chunk=16,
                           kernel_path=kernel_path, analytics=jana)
    hist = sampling.run_chains(tdg, tspec, tpar, tst, n_steps=41, chunk=16,
                               kernel_path=kernel_path)
    ana = tacc.DeviceAnalytics(6, cap=cap, series_keys=keys, series_cap=41)
    summ = sampling.run_chains(tdg, tspec, tpar, tst, n_steps=41, chunk=16,
                               record_history=False,
                               kernel_path=kernel_path, analytics=ana)
    assert summ.history == {}
    assert torch.equal(summ.state.assignment, hist.state.assignment)
    assert torch.equal(ana.acc.accepts, summ.state.accept_count)
    assert int(ana.acc.n) == 41
    assert_acc_equal(ana.acc, tacc.fold_block(
        tacc.init_summary(6, cap=cap, series_keys=keys, series_cap=41),
        rows_of(hist.history, ("cut_count", "wait", "accepts") + keys)))
    n_bad = assert_waits_close(hist.history["wait"],
                               jhist.history["wait"]).sum()
    assert_acc_close_to_jax(ana.acc, jana.acc, n_bad)
    series, jseries = ana.series_host(), jana.series_host()
    for k in keys:
        np.testing.assert_array_equal(series[k], jseries[k], err_msg=k)


def test_lowered_series_parity():
    """sec11 with the interface: chain 0's series read back at the end
    equal the history rows (NaN for NaN) and the JAX package's series."""
    spec, (bg, st, params), (tbg, tst, tpar) = board_pair(interface=True)
    tspec = spec_port(spec)
    keys = ("slope", "angle")
    jana = jacc.DeviceAnalytics(4, series_keys=keys, series_cap=24)
    jhist = fce.sampling.run_board(bg, spec, params, st, n_steps=24,
                                   chunk=8, bits=False, analytics=jana)
    hist = sampling.run_board(tbg, tspec, tpar, tst, n_steps=24, chunk=8,
                              device="cpu")
    ana = tacc.DeviceAnalytics(4, series_keys=keys, series_cap=24)
    sampling.run_board(tbg, tspec, tpar, tst, n_steps=24, chunk=8,
                       record_history=False, device="cpu", analytics=ana)
    series, jseries = ana.series_host(), jana.series_host()
    for k in keys:
        np.testing.assert_array_equal(series[k].view(np.int32),
                                      hist.history[k][0].view(np.int32))
        assert_ulps_close(series[k], jseries[k], name=k)
    assert_acc_equal(ana.acc, tacc.fold_block(
        tacc.init_summary(4, series_keys=keys, series_cap=24),
        rows_of(hist.history, ("cut_count", "wait", "accepts") + keys)))
    n_bad = assert_waits_close(hist.history["wait"],
                               jhist.history["wait"]).sum()
    assert_acc_close_to_jax(ana.acc, jana.acc, n_bad)


def test_fold_sees_every_step_under_thinning():
    """record_every thins the history, never the fold."""
    spec, _, (tbg, tst, tpar) = board_pair()
    tspec = spec_port(spec)
    full = sampling.run_board(tbg, tspec, tpar, tst, n_steps=25, chunk=8,
                              device="cpu")
    ana = tacc.DeviceAnalytics(4)
    thin = sampling.run_board(tbg, tspec, tpar, tst, n_steps=25, chunk=8,
                              record_every=3, device="cpu", analytics=ana)
    assert thin.history["cut_count"].shape[1] == 9
    assert_acc_equal(ana.acc, tacc.fold_block(tacc.init_summary(4),
                                              rows_of(full.history)))
