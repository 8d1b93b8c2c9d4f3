"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. The file imports
only the port (no JAX), so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: every output bit-equal (kernel and plain version share CUDA's
``logf``, ``log1pf`` and ``acosf`` and round every float step alike;
NaN interface metrics compare equal).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _parity import assert_chain_run_matches, general_fixture_inputs

import flipcomplexityempirical_tpu_torch as port
from flipcomplexityempirical_tpu_torch import (convert, graphs, init_board,
                                               Spec)
from flipcomplexityempirical_tpu_torch.kernel import cuda_board as cb
from flipcomplexityempirical_tpu_torch.kernel import cuda_dense as cd
from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl
from flipcomplexityempirical_tpu_torch.kernel import probes
from flipcomplexityempirical_tpu_torch.sampling import (init_batch,
                                                        run_board,
                                                        run_board_cuda,
                                                        run_chains)
from flipcomplexityempirical_tpu_torch.sampling.recom import (
    recom_chunk_reference)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _chunk_inputs(h, w, chains, tol, dev, pop_seed=None):
    g = graphs.square_grid(h, w)
    spec = Spec(contiguity="patch")
    bg, st, params = init_board(g, graphs.stripes_plan(g, 2), n_chains=chains,
                                seed=0, spec=spec, base=1.4, pop_tol=tol,
                                device=dev)
    pop, deg = cb.make_static_inputs(bg)
    dp, scal, ints = cb.pack_state(st, params)
    if pop_seed is not None:
        # a random population plane, with the state and bounds to match
        r = np.random.default_rng(pop_seed)
        pop = torch.as_tensor(r.integers(1, 20, h * w), dtype=torch.int32,
                              device=dev)
        p1 = (st.board.long() * pop).sum(dim=1)
        dp = torch.stack([pop.sum() - p1, p1]).to(torch.int32)
        ideal = float(pop.sum()) / 2
        scal = scal.clone()
        scal[2], scal[3] = ideal * (1 - tol), ideal * (1 + tol)
    return spec, bg, st, (pop, deg, dp, scal, ints)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,chains,tol,t_len,pop_seed", [
    (8, 16, 16, 0.3, 40, None),
    (8, 16, 8, 0.0, 40, None),       # empty valid set: every chain stays
    (13, 7, 5, 0.05, 40, None),
    (64, 64, 32, 0.1, 40, None),
    (64, 64, 16, 0.1, 500, None),    # the main path's chunk length
    (24, 24, 12, 0.05, 120, 3),      # a non-uniform population plane
    (10, 31, 6, 0.2, 60, None),      # widths whose neighbour rows
    (9, 33, 6, 0.2, 60, None),       # straddle 32-cell words
    (6, 65, 4, 0.2, 60, None),
    (80, 96, 4, 0.1, 20, None),      # larger boards: 8 and 16 words a
    (100, 150, 3, 0.1, 20, None),    # lane, near the 16384-cell bound
])
def test_kernel_matches_plain_version(card, h, w, chains, tol, t_len,
                                      pop_seed):
    spec, bg, st, (pop, deg, dp, scal, ints) = _chunk_inputs(
        h, w, chains, tol, card, pop_seed)
    rng = np.random.default_rng(h * w + chains)
    bits = (cb.bits_tensor(rng.integers(0, 2 ** 32, (t_len, chains, h * w),
                                        dtype=np.uint32), card),
            cb.bits_tensor(rng.integers(0, 2 ** 32, (t_len, 2, chains),
                                        dtype=np.uint32), card))
    for mode in (bits, (None, None)):
        args = (spec, h, w, t_len, 7, 3, st.board, pop, deg, dp, scal, ints,
                *mode)
        launches = cb.run_board_chunk_cuda.launches
        got = cb.run_board_chunk_cuda(*args)
        assert cb.run_board_chunk_cuda.launches == launches + 1
        want = cb.board_chunk_reference(*args)
        torch.cuda.synchronize()
        for k, (g_arr, w_arr) in enumerate(zip(got, want)):
            assert torch.equal(g_arr, w_arr.to(g_arr.dtype)), k


@pytest.mark.cuda
def test_runner_goes_through_the_kernel(card):
    spec, bg, st, _ = _chunk_inputs(8, 16, 8, 0.2, card)
    g = graphs.square_grid(8, 16)
    _, _, params = init_board(g, graphs.stripes_plan(g, 2), n_chains=8,
                              seed=0, spec=spec, base=1.4, pop_tol=0.2,
                              device=card)
    launches = cb.run_board_chunk_cuda.launches
    res = run_board_cuda(bg, spec, params, st, n_steps=121, chunk=40,
                         device=card)
    assert cb.run_board_chunk_cuda.launches == launches + 3
    assert (res.state.t_yield == 121).all()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["a", "b"])
def test_probe_kernels_match_plain_version(card, which):
    r = np.random.default_rng(5)
    x = r.integers(-2, 3, (probes.ROWS, probes.COLS)).astype(np.int32)
    x[::4] = 0
    x = torch.as_tensor(x, device=card)
    bits = torch.as_tensor(r.integers(0, 2 ** 32, (probes.STEPS, *x.shape),
                                      dtype=np.uint32).view(np.int32),
                           device=card)
    fn = probes.probe_a if which == "a" else probes.probe_b
    for mode in (bits, None):
        launches = fn.launches
        got = fn(x, probes.STEPS, probes.SEED, mode)
        assert fn.launches == launches + 1
        want = probes.probe_reference(which, x, probes.STEPS, probes.SEED,
                                      mode)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _lowered_inputs(which, chains, tol, card, random_start=False,
                    **spec_kw):
    """The family's start or, with ``random_start``, a seeded random
    assignment, where most cells are candidates."""
    g = graphs.grid_sec11() if which == "sec11" else graphs.frankengraph()
    if random_start:
        plan = np.random.default_rng(chains).integers(0, 2, g.n_nodes)
    else:
        plan = (graphs.sec11_plan(g, 0) if which == "sec11"
                else graphs.frank_plan(g, 0))
    spec = Spec(**{"contiguity": "patch", "record_interface": True,
                   **spec_kw})
    bg, st, params = init_board(g, plan, n_chains=chains, seed=2, spec=spec,
                                base=2.63815853 if which == "sec11" else 0.3,
                                pop_tol=tol, device=card)
    return spec, bg, st, params


@pytest.mark.cuda
@pytest.mark.parametrize("which,chains,tol,t_len,spec_kw", [
    ("sec11", 32, 0.1, 64, {}),
    ("frankengraph", 32, 0.1, 64, {}),
    ("sec11", 16, 0.0, 20, {}),                     # empty valid set
    ("sec11", 16, 0.1, 40, {"contiguity": "none"}),
    ("frankengraph", 16, 0.1, 40, {"accept": "always"}),
    ("sec11", 16, 0.1, 40, {"record_interface": False}),
    # the resident planes brought up to date after every step
    ("sec11", 16, 0.1, 40, {"accept": "always"}),
    ("frankengraph", 8, 0.1, 500, {"accept": "always"}),
    # most cells candidates: random starts
    ("sec11", 16, 0.1, 40, {"random_start": True}),
    ("frankengraph", 16, 0.1, 40, {"random_start": True,
                                   "accept": "always"}),
])
def test_lowered_kernel_matches_plain_version(card, which, chains, tol,
                                              t_len, spec_kw):
    spec, bg, st, params = _lowered_inputs(which, chains, tol, card,
                                           **spec_kw)
    static = cl.make_static_inputs(bg, spec, params)
    args = (bg, static, spec, t_len, st.board, *cl.pack_state(st, params))
    launches = cl.run_lowered_chunk_cuda.launches
    got = cl.run_lowered_chunk_cuda(*args)
    assert cl.run_lowered_chunk_cuda.launches == launches + 1
    want = cl.lowered_chunk_reference(*args)
    torch.cuda.synchronize()
    for name, g_arr, w_arr in zip(cl.OUT_NAMES, got, want):
        w_arr = w_arr.to(g_arr.dtype)
        same = g_arr == w_arr
        if g_arr.dtype.is_floating_point:
            same |= torch.isnan(g_arr) & torch.isnan(w_arr)
        assert bool(same.all()), name


@pytest.mark.cuda
def test_lowered_runner_goes_through_the_kernel(card):
    spec, bg, st, params = _lowered_inputs("sec11", 8, 0.1, card)
    launches = cl.run_lowered_chunk_cuda.launches
    res = run_board(bg, spec, params, st, n_steps=121, chunk=40,
                    device=card)
    assert cl.run_lowered_chunk_cuda.launches == launches + 3
    assert (res.state.t_yield == 121).all()
    assert res.history["slope"].shape == (8, 121)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,chains,t_len,spec_kw", [
    (64, 64, 32, 64, {}),
    (40, 65, 16, 64, {}),                 # a width that straddles words
    (3, 4, 64, 64, {}),                   # the enumeration grid
    (12, 13, 16, 40, {"contiguity": "none"}),
])
def test_rook_route_matches_plain_version(card, h, w, chains, t_len,
                                          spec_kw):
    """Plain rook grids through the lowered kernel (the route of the JAX
    package's ``_scan_bits``): every output bit-equal to the plain
    version, the diagonal cut planes zero, and ``run_board`` launching
    the kernel once a chunk with the state's diagonal planes left None."""
    g = graphs.square_grid(h, w)
    spec = Spec(**{"contiguity": "patch", **spec_kw})
    bg, st, params = init_board(g, graphs.stripes_plan(g, 2),
                                n_chains=chains, seed=0, spec=spec, base=1.4,
                                pop_tol=0.2, device=card)
    static = cl.make_static_inputs(bg, spec, params)
    args = (bg, static, spec, t_len, st.board, *cl.pack_state(st, params))
    got = cl.run_lowered_chunk_cuda(*args)
    want = cl.lowered_chunk_reference(*args)
    torch.cuda.synchronize()
    for name, g_arr, w_arr in zip(cl.OUT_NAMES, got, want):
        w_arr = w_arr.to(g_arr.dtype)
        same = g_arr == w_arr
        if g_arr.dtype.is_floating_point:
            same |= torch.isnan(g_arr) & torch.isnan(w_arr)
        assert bool(same.all()), name
    assert not bool(got[13][1].any()) and not bool(got[13][3].any())
    launches = cl.run_lowered_chunk_cuda.launches
    res = run_board(bg, spec, params, st, n_steps=81, chunk=40, device=card)
    assert cl.run_lowered_chunk_cuda.launches == launches + 2
    assert res.state.cut_times_se is None and res.state.cut_times_sw is None


def _dense_inputs(name, m, n, chains, tol, dev, pop_seed=None, **spec_kw):
    g = getattr(graphs, name)(m, n)
    if pop_seed is not None:
        # a random population plane: the kernel's per-node gate
        g = dataclasses.replace(g, pop=np.random.default_rng(
            pop_seed).integers(1, 10, g.n_nodes).astype(np.int32))
    spec = Spec(**spec_kw)
    dg, st, params = init_batch(g, graphs.stripes_plan(g, 2),
                                n_chains=chains, seed=4, spec=spec,
                                base=1 / 0.3, pop_tol=tol, device=dev)
    return spec, dg, st, params


def _same_states(got, want):
    for f in got.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert torch.equal(a, b.to(a.dtype)), f


@pytest.mark.cuda
@pytest.mark.parametrize("name,m,n,chains,tol,t_len,spec_kw,pop_seed", [
    ("hex_lattice", 14, 28, 8, 0.1, 369, {}, None),
    ("hex_lattice", 64, 64, 32, 0.1, 100, {}, None),    # tables through L1
    ("triangular_lattice", 14, 28, 16, 0.1, 100, {"nobacktrack": True},
     None),
    ("hex_lattice", 14, 28, 16, 0.1, 100, {"lazy_uniform": True}, None),
    ("hex_lattice", 14, 28, 16, 0.1, 100, {"contiguity": "none"}, None),
    ("hex_lattice", 14, 28, 16, 0.0, 50, {}, None),     # no valid move
    ("hex_lattice", 14, 28, 16, 0.02, 200, {}, 5),      # random population
    ("hex_lattice", 14, 28, 256, 0.1, 100, {}, None),   # 2 chains a block
    ("hex_lattice", 14, 28, 1088, 0.1, 100, {}, None),  # 8 chains a block
])
def test_general_dense_kernel_matches_plain_version(card, name, m, n, chains,
                                                    tol, t_len, spec_kw,
                                                    pop_seed):
    """Every state field (the conn planes filled by the kernel on entry
    included) and every history row bit-equal, in two chunks."""
    spec, dg, st, params = _dense_inputs(name, m, n, chains, tol, card,
                                         pop_seed, **spec_kw)
    static = cd.make_static_inputs(dg)
    for _ in range(2):
        launches = cd.run_general_dense_chunk_cuda.launches
        got, rows = cd.run_general_dense_chunk_cuda(dg, static, spec, params,
                                                    st, t_len)
        assert cd.run_general_dense_chunk_cuda.launches == launches + 1
        want, wrows = cd.general_dense_chunk_reference(dg, spec, params, st,
                                                       t_len)
        torch.cuda.synchronize()
        _same_states(got, want)
        assert sorted(rows) == sorted(wrows)
        for k in rows:
            assert torch.equal(rows[k], wrows[k]), k
        st = got


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,chains,staged,producer,per_block", [
    (14, 28, 8, True, True, 1),
    (64, 64, 32, False, True, 1),
    (14, 28, 1088, True, False, 8),
    (64, 64, 4096, False, False, 8),
])
def test_general_dense_launch_forms(card, m, n, chains, staged, producer,
                                    per_block):
    """The kernel's four forms (tables staged or read through L1; one chain
    a block with a draws warp or several chains a block), each reached by
    a case of the test above or of chip_smoke.py."""
    _, dg, _, _ = _dense_inputs("hex_lattice", m, n, 1, 0.1, card, None)
    shape = cd.launch_shape(dg, chains)
    assert (shape["staged"], shape["producer"],
            shape["chains_per_block"]) == (staged, producer, per_block)


@pytest.mark.cuda
def test_general_runner_goes_through_the_kernel(card):
    spec, dg, st, params = _dense_inputs("hex_lattice", 6, 10, 8, 0.1, card)
    launches = cd.run_general_dense_chunk_cuda.launches
    res = run_chains(dg, spec, params, st, n_steps=121, chunk=40)
    assert cd.run_general_dense_chunk_cuda.launches == launches + 3
    assert res.state.conn_bits is None and (res.state.t_yield == 121).all()
    with pytest.raises(ValueError, match="B4"):
        run_chains(dg, Spec(accept="corrected"), params, st, n_steps=3)


@pytest.mark.cuda
def test_general_dense_kernel_matches_jax_fixture(card):
    import pathlib
    path = (pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
            / "general_dense_hex.npz")
    want = dict(np.load(path))
    g = port.graphs.hex_lattice(*want["graph"])
    dg, state, params = general_fixture_inputs(port, convert, g, want, card)
    res = run_chains(dg, Spec(), params, state, n_steps=int(want["steps"]),
                     chunk=int(want["chunk"]), kernel_path="general_dense")
    assert_chain_run_matches(
        convert.to_numpy(res.state), res.history, res.waits_total,
        {k[6:]: v for k, v in want.items() if k.startswith("state_")},
        {k[5:]: v for k, v in want.items() if k.startswith("hist_")},
        want["waits_total"])


# ---------------------------------------------------------------------------
# The summary fold (csrc/summary_fold.cu)
# ---------------------------------------------------------------------------

def _fold_rows(t_len, chains, dev, seed, integer=True, wait=True,
               series=True):
    r = np.random.default_rng(seed)
    x = (r.integers(5, 600, (t_len, chains)).astype(np.int32) if integer
         else r.normal(40.0, 9.0, (t_len, chains)).astype(np.float32))
    rows = {"cut_count": x,
            "accepts": np.cumsum(r.integers(0, 2, (t_len, chains)),
                                 axis=0).astype(np.int32)}
    if wait:
        rows["wait"] = r.geometric(0.3, (t_len, chains)).astype(
            np.float32) - 1
    if series:
        for k in ("slope", "angle"):
            v = r.normal(size=(t_len, chains)).astype(np.float32)
            v[r.random(t_len) < 0.2] = np.nan
            rows[k] = v
    return {k: torch.as_tensor(v, device=dev) for k, v in rows.items()}


def _same_acc(got, want):
    for k in ("n", "kept", "stride", "accepts", "mean", "m2", "wsum",
              "wmean", "wm2", "waits", "buf"):
        a, b = getattr(got, k), getattr(want, k)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), k
    for k in want.series:
        assert torch.equal(got.series[k].view(torch.int32),
                           want.series[k].view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("t_len,chains,cap,integer,wait,series", [
    (500, 4096, 4096, True, True, True),      # the lowered main path
    (369, 8, 4096, True, True, True),          # the experiment path
    (2439, 32, 4096, True, True, False),       # the hex batch's dense rows
    (369, 8, 8, True, True, True),             # decimates inside a chunk
    (200, 130, 16, False, False, False),       # float data, no waits
])
def test_summary_fold_matches_plain_version(card, t_len, chains, cap,
                                            integer, wait, series):
    from flipcomplexityempirical_tpu_torch.kernel import cuda_summary
    from flipcomplexityempirical_tpu_torch.stats import accumulators as sacc
    keys = ("slope", "angle") if series else ()
    rows = _fold_rows(t_len, chains, card, t_len + chains, integer, wait,
                      series)
    got = sacc.init_summary(chains, cap=cap, series_keys=keys,
                            series_cap=t_len + 100, device=card)
    want = got.clone()
    n0 = cuda_summary.summary_fold.launches
    for _ in range(2):          # the second fold starts mid-schedule
        got = cuda_summary.summary_fold(got, rows)
        want = sacc.fold_block(want, rows)
    torch.cuda.synchronize()
    assert cuda_summary.summary_fold.launches == n0 + 2
    assert int(got.n) == 2 * t_len
    _same_acc(got, want)


@pytest.mark.cuda
def test_summary_runs_go_through_the_fold_kernel(card):
    from flipcomplexityempirical_tpu_torch.kernel import cuda_summary
    from flipcomplexityempirical_tpu_torch.stats import accumulators as sacc
    g = graphs.grid_sec11()
    spec = Spec(contiguity="patch", record_interface=True)
    bg, st, params = init_board(g, graphs.sec11_plan(g, 0), n_chains=8,
                                seed=0, spec=spec, base=1.4, pop_tol=0.1,
                                device=card)
    hist = run_board(bg, spec, params, st, n_steps=101, chunk=25,
                     device=card)
    ana = sacc.DeviceAnalytics(8, series_keys=("slope", "angle"),
                               series_cap=101, device=card)
    n0 = cuda_summary.summary_fold.launches
    f0 = cuda_summary.fused_fold.launches
    summ = run_board(bg, spec, params, st, n_steps=101, chunk=25,
                     record_history=False, device=card, analytics=ana)
    # the 4 chunks fold their own records; the final record is the one
    # standalone launch
    assert cuda_summary.summary_fold.launches == n0 + 1
    assert cuda_summary.fused_fold.launches == f0 + 4
    assert torch.equal(summ.state.board, hist.state.board)
    rows = {k: torch.as_tensor(hist.history[k], device=card).T.contiguous()
            for k in ("cut_count", "wait", "accepts", "slope", "angle")}
    want = sacc.fold_block(sacc.init_summary(
        8, series_keys=("slope", "angle"), series_cap=101, device=card),
        rows)
    _same_acc(ana.acc, want)
    # the general runner: the initial record is its one standalone launch
    dspec, dg, dst, dpar = _dense_inputs("hex_lattice", 14, 28, 8, 0.1, card)
    dhist = run_chains(dg, dspec, dpar, dst, n_steps=121, chunk=40)
    ana = sacc.DeviceAnalytics(8, device=card)
    n0 = cuda_summary.summary_fold.launches
    f0 = cuda_summary.fused_fold.launches
    run_chains(dg, dspec, dpar, dst, n_steps=121, chunk=40,
               record_history=False, analytics=ana)
    assert cuda_summary.summary_fold.launches == n0 + 1
    assert cuda_summary.fused_fold.launches == f0 + 3
    rows = {k: torch.as_tensor(dhist.history[k], device=card).T.contiguous()
            for k in ("cut_count", "wait", "accepts")}
    _same_acc(ana.acc, sacc.fold_block(sacc.init_summary(8, device=card),
                                       rows))


# ---------------------------------------------------------------------------
# The fold inside the chunk kernels (csrc/summary_fold.cuh)
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    """Bit for bit, NaN for NaN."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("chains,t_len,cap,keep_rows", [
    (8, 369, 4096, False),     # the experiment path
    (8, 369, 8, True),         # halvings in a chunk, with the rows
    (12, 100, 8, False),       # a block of 4 chains
    (2048, 64, 8, False),      # 256 blocks, past the SMs
])
def test_lowered_fused_fold_matches_history_launch(card, chains, t_len, cap,
                                                   keep_rows):
    """Two chunks of sec11 with the interface: the fused launch's state,
    flip log and rows bit-equal to the history-mode launch's, the rows
    only the fold reads left out without a history, and its accumulator
    bit-equal to the standalone fold of the history-mode rows."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_summary
    from flipcomplexityempirical_tpu_torch.stats import accumulators as sacc
    spec, bg, st, params = _lowered_inputs("sec11", chains, 0.1, card)
    static = cl.make_static_inputs(bg, spec, params)
    keys = ("slope", "angle")
    acc = sacc.init_summary(chains, cap=cap, series_keys=keys,
                            series_cap=2 * t_len - 5, device=card)
    want = acc.clone()
    for _ in range(2):
        ins = (st.board, *cl.pack_state(st, params))
        hist = cl.run_lowered_chunk_cuda(bg, static, spec, t_len, *ins)
        f0 = cuda_summary.fused_fold.launches
        got, acc = cl.run_lowered_chunk_cuda(
            bg, static, spec, t_len, *ins, acc=acc, keep_rows=keep_rows)
        torch.cuda.synchronize()
        assert cuda_summary.fused_fold.launches == f0 + 1
        for i, (a, b) in enumerate(zip(got, hist)):
            if a is None:
                assert not keep_rows and i in cl.FOLD_ONLY_OUTS
            else:
                assert _bits_equal(a, b), cl.OUT_NAMES[i]
        rows = dict(zip(("cut_count", "b_count", "wait", "accepts", "slope",
                         "angle"), hist[7:13]))
        want = cuda_summary.summary_fold(want, rows)
        torch.cuda.synchronize()
        _same_acc(acc, want)
        st = cl.unpack_state(st, hist, t_len)


@pytest.mark.cuda
@pytest.mark.parametrize("chains,t_len,cap,spec_kw,obs,keys,wide", [
    (32, 2439, 4096, {}, "cut_count", (), True),  # the hex batch
    (8, 300, 8, {}, "cut_count", (), True),
    (16, 200, 16, {"lazy_uniform": True}, "b_count", ("wait", "weight"),
     True),
    (256, 100, 8, {}, "cut_count", ("wait",), False),  # 2 chains a block
])
def test_general_dense_fused_fold_matches_history_launch(card, chains, t_len,
                                                         cap, spec_kw, obs,
                                                         keys, wide):
    """Two chunks of the hex lattice, with the rows and without, in the
    wide form (a chain, its draws warp and the fold warp a block) or the
    narrow one (the block's chains and the fold warp): the fused launch's
    state and rows bit-equal to the history-mode launch's, its
    accumulator bit-equal to the standalone fold of the history rows."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_summary
    from flipcomplexityempirical_tpu_torch.stats import accumulators as sacc
    spec, dg, st, params = _dense_inputs("hex_lattice", 14, 28, chains, 0.1,
                                         card, **spec_kw)
    static = cd.make_static_inputs(dg)
    assert cd.launch_shape(dg, chains, fold=True)["producer"] == wide
    acc = sacc.init_summary(chains, cap=cap, observable=obs,
                            series_keys=keys, series_cap=2 * t_len - 5,
                            device=card)
    want = acc.clone()
    for keep_rows in (True, False):
        hist, rows = cd.run_general_dense_chunk_cuda(dg, static, spec,
                                                     params, st, t_len)
        f0 = cuda_summary.fused_fold.launches
        got, got_rows, acc = cd.run_general_dense_chunk_cuda(
            dg, static, spec, params, st, t_len, acc=acc,
            keep_rows=keep_rows)
        torch.cuda.synchronize()
        assert cuda_summary.fused_fold.launches == f0 + 1
        _same_states(got, hist)
        assert set(got_rows) == (set(rows) if keep_rows else set())
        for k, v in got_rows.items():
            assert _bits_equal(v, rows[k]), k
        want = cuda_summary.summary_fold(want, rows)
        torch.cuda.synchronize()
        _same_acc(acc, want)
        st = hist


def _rows_equal(rows, wrows):
    """Rows equal value for value, NaN where the plain version's are (the
    kernel writes its own NaN bits)."""
    assert sorted(rows) == sorted(wrows)
    for k in rows:
        a, b = rows[k], wrows[k]
        if a.dtype.is_floating_point:
            assert torch.equal(torch.isnan(a), torch.isnan(b)), k
            ok = ~torch.isnan(b)
            assert torch.equal(a[ok], b[ok]), k
        else:
            assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("builder,planf,spec_kw,chains,t_len", [
    ("grid_sec11", "sec11_plan", {"nobacktrack": True}, 8, 300),
    ("frankengraph", "frank_plan", {"lazy_uniform": True}, 8, 300),
    ("grid_sec11", "sec11_plan", {}, 300, 200),             # narrow form
    ("frankengraph", "frank_plan", {"contiguity": "none"}, 64, 200),
])
def test_general_dense_interface_form_matches_plain_version(
        card, builder, planf, spec_kw, chains, t_len):
    """The interface form (record_interface): every state field and row,
    slope and angle included, equal to the plain version, in two
    chunks."""
    g = getattr(graphs, builder)()
    spec = Spec(record_interface=True, **spec_kw)
    dg, st, params = init_batch(g, getattr(graphs, planf)(g, 0),
                                n_chains=chains, seed=6, spec=spec,
                                base=0.8, pop_tol=0.1, device=card)
    static = cd.make_static_inputs(dg, spec)
    for _ in range(2):
        got, rows = cd.run_general_dense_chunk_cuda(dg, static, spec, params,
                                                    st, t_len)
        want, wrows = cd.general_dense_chunk_reference(dg, spec, params, st,
                                                       t_len)
        torch.cuda.synchronize()
        _same_states(got, want)
        _rows_equal(rows, wrows)
        st = got


def _pair_graph(name: str):
    """A pair-kernel test graph: ``precinctsS`` a synthetic S x S precinct
    map (populations that vary by node, boundary lengths), ``gridS`` an
    S x S rook grid and ``hexS`` the S x S hex lattice (one population
    per node)."""
    if name.startswith("precincts"):
        side = int(name[len("precincts"):])
        g, _ = graphs.from_geojson(
            graphs.synthetic_precincts(side, side, seed=1),
            pop_property="POP")
        return g
    if name.startswith("grid"):
        side = int(name[len("grid"):])
        return graphs.square_grid(side, side)
    side = int(name[len("hex"):])
    return graphs.hex_lattice(side, side)


# (graph, k, weighted_cut, chains, T, base, pop_tol, tables staged, a
# draws warp a chain): populations that vary by node (every accepted move
# recounts), one population per node with district masks that change
# (base 1: every move accepted, a tight tolerance), graphs of more than
# 1024 nodes (two, three and nine count groups), k = 2 to 8 (a byte cell
# at k <= 4, 16 bits above), the tables staged or read through L1, one
# chain a block with a draws warp or many chains a block
PAIR_CASES = [
    ("precincts12", 4, True, 8, 400, 2.0, 0.3, True, True),
    ("precincts12", 8, True, 8, 400, 2.0, 0.3, True, True),
    ("precincts12", 3, False, 300, 200, 2.0, 0.3, True, False),
    ("precincts6", 2, True, 64, 200, 2.0, 0.3, True, True),
    ("grid12", 4, False, 16, 300, 1.0, 0.06, True, True),
    ("grid12", 2, False, 300, 300, 1.2, 0.1, True, False),
    ("grid12", 8, False, 32, 300, 1.2, 0.2, True, True),
    ("grid33", 4, False, 300, 200, 1.0, 0.05, True, False),
    ("grid33", 8, False, 8, 200, 1.0, 0.05, True, True),
    ("grid48", 3, False, 8, 200, 2.0, 0.1, False, True),
    ("grid48", 8, True, 200, 100, 1.5, 0.1, False, False),
    ("hex64", 4, False, 400, 100, 2.63815853, 0.1, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("gname,k,weighted,chains,t_len,base,tol,staged,"
                         "producer", PAIR_CASES)
def test_general_pair_kernel_matches_plain_version(
        card, gname, k, weighted, chains, t_len, base, tol, staged,
        producer):
    """general_pair_chunk: every state field and row equal to the plain
    version, in two chunks, one launch counted each, in the launch form
    the case names; its full recounts: one at the step after each
    accepted move where the population varies by node, fewer than the
    moves but some where a tight tolerance changes the district masks."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_pair as cp
    g = _pair_graph(gname)
    spec = Spec(n_districts=k, proposal="pair", weighted_cut=weighted)
    dg, st, params = init_batch(g, graphs.stripes_plan(g, k),
                                n_chains=chains, seed=7, spec=spec,
                                base=base, pop_tol=tol, device=card)
    static = cp.make_static_inputs(dg)
    shape = cp.launch_shape(dg, chains, k)
    assert (shape["staged"], shape["producer"]) == (staged, producer)
    recounts, moves, last = 0, 0, 0
    for _ in range(2):
        n0 = cp.run_general_pair_chunk_cuda.launches
        rc = torch.zeros(chains, dtype=torch.int32, device=card)
        got, rows = cp.run_general_pair_chunk_cuda(dg, static, spec, params,
                                                   st, t_len, recounts=rc)
        assert cp.run_general_pair_chunk_cuda.launches == n0 + 1
        want, wrows = cp.general_pair_chunk_reference(dg, spec, params, st,
                                                      t_len)
        torch.cuda.synchronize()
        _same_states(got, want)
        _rows_equal(rows, wrows)
        recounts += int(rc.sum())
        moves += int((got.accept_count - st.accept_count).sum())
        # a move at a chunk's last step leaves its recount to the next chunk
        last += int((rows["accepts"][-1] - rows["accepts"][-2]).sum())
        st = got
    assert moves > 0
    if static.unit_pop == 0:
        assert recounts == moves - last
    else:
        assert recounts < moves
        if tol < 0.1:
            assert recounts > 0


@pytest.mark.cuda
def test_general_pair_launch_shape_holds_more_chains_an_sm(card):
    """At the bench's pair shape (hex 64 x 64, k = 4, C=4096) the kernel
    keeps more than 8 chains resident an SM (a byte a node), the tables
    read through L1."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_pair as cp
    g = graphs.hex_lattice(64, 64)
    dg = g.device(card)
    shape = cp.launch_shape(dg, 4096, 4)
    assert shape["chains_per_block"] * shape["blocks_per_sm"] > 8
    assert not shape["staged"] and not shape["producer"]


@pytest.mark.cuda
def test_pair_runs_go_through_the_pair_kernel(card):
    """run_chains on a 'pair' spec launches the pair kernel once a chunk
    and, with analytics, folds each chunk's rows in one standalone fold
    launch."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_pair as cp
    from flipcomplexityempirical_tpu_torch.kernel import cuda_summary as cs
    from flipcomplexityempirical_tpu_torch.stats.accumulators import (
        DeviceAnalytics)
    g = graphs.hex_lattice(6, 8)
    spec = Spec(n_districts=4, proposal="pair")
    dg, st, params = init_batch(g, graphs.stripes_plan(g, 4), n_chains=16,
                                seed=8, spec=spec, base=1.2, pop_tol=0.2,
                                device=card)
    an = DeviceAnalytics(16, observable="cut_count", device=card)
    n0, f0 = cp.run_general_pair_chunk_cuda.launches, cs.summary_fold.launches
    run_chains(dg, spec, params, st, n_steps=101, chunk=25,
               record_history=False, analytics=an)
    assert cp.run_general_pair_chunk_cuda.launches == n0 + 4
    assert cs.summary_fold.launches == f0 + 5     # the initial record too



def _board_pair_inputs(h, w, k, chains, tol, base, spec_kw, warm, dev):
    """A k-stripe start on the h x w grid, advanced ``warm`` steps by the
    run's own chunks: (wrapper module, BoardGraph, spec, static inputs,
    the chunk's per-chain inputs and, under parity_metrics, its flips)."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_board_pair as cbp
    from flipcomplexityempirical_tpu_torch.sampling import board_runner
    g = graphs.square_grid(h, w)
    spec = Spec(n_districts=k, proposal="pair", **spec_kw)
    bg, st, params = init_board(g, graphs.stripes_plan(g, k),
                                n_chains=chains, seed=k, spec=spec,
                                base=base, pop_tol=tol, device=dev)
    if warm:
        st = board_runner.run_board_segment(bg, spec, params, st, warm,
                                            record_history=False,
                                            device=dev).state
    static = cbp.make_static_inputs(bg, spec, params)
    flips = ((st.part_sum, st.last_flipped, st.num_flips)
             if spec.parity_metrics else None)
    return (cbp, bg, spec, static,
            (st.board, *cbp.pack_state(st, params), flips))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,k,chains,tol,base,t_len,spec_kw,warm", [
    (64, 64, 4, 64, 0.5, 2.63815853, 40, {}, 100),
    (40, 65, 3, 32, 0.5, 0.8, 40, {}, 100),
    (8, 16, 8, 32, 0.1, 0.8, 64, {}, 100),
    (6, 7, 3, 16, 0.3, 1.3, 64, {}, 0),
    (64, 64, 4, 32, 0.5, 2.63815853, 40, {"contiguity": "none"}, 100),
    (32, 32, 4, 32, 0.5, 2.63815853, 40, {"accept": "always"}, 100),
    (64, 64, 4, 16, 0.0, 2.63815853, 40, {}, 0),
    (64, 64, 4, 40, 0.5, 2.63815853, 40, {"parity_metrics": False}, 100),
    (8, 16, 8, 13, 0.1, 0.8, 64, {"parity_metrics": False}, 100),
    (17, 23, 5, 13, 0.2, 1.1, 80, {}, 60),
], ids=["64x64-k4", "40x65-k3", "8x16-k8-tight", "6x7-k3", "none",
        "always", "empty-valid-set", "64x64-k4-no-parity",
        "8x16-k8-tight-no-parity-C13", "17x23-k5-C13"])
def test_board_pair_kernel_matches_plain_version(card, h, w, k, chains, tol,
                                                 base, t_len, spec_kw, warm):
    """board_pair_chunk against its plain version, every output bit-equal
    (part_sum / last_flipped / num_flips too under parity_metrics), one
    launch counted a call, the inputs left as they were; a full recount
    only after a move that changes a population mask, so at least one
    where the gates bind (pop_tol 0.1 at 16 cells a district)."""
    cbp, bg, spec, static, ins = _board_pair_inputs(h, w, k, chains, tol,
                                                    base, spec_kw, warm, card)
    tensors = [*ins[:5], *(ins[5] or ())]
    kept = [x.clone() for x in tensors]
    recounts = torch.full((chains,), -1, dtype=torch.int32, device=card)
    n0 = cbp.run_board_pair_chunk_cuda.launches
    got = cbp.run_board_pair_chunk_cuda(bg, static, spec, t_len, *ins,
                                        recounts=recounts)
    assert cbp.run_board_pair_chunk_cuda.launches == n0 + 1
    want = cbp.board_pair_chunk_reference(bg, static, spec, t_len, *ins)
    assert len(got) == len(want) == (13 if spec.parity_metrics else 10)
    for name, g, w_ in zip(cbp.OUT_NAMES, got, want):
        assert torch.equal(g, w_), name
    assert all(torch.equal(x, y) for x, y in zip(tensors, kept))
    accepted = got[4][5] - ins[4][5]
    assert (int(accepted.sum()) == 0) == (tol == 0.0)
    assert bool((recounts >= 0).all() and (recounts <= accepted).all())
    if tol == 0.1:
        assert int(recounts.sum()) > 0


@pytest.mark.cuda
def test_board_pair_runs_go_through_the_kernel(card):
    """run_board on a 'pair' spec launches the board pair kernel once a
    chunk and no lowered_chunk; with analytics, each chunk's rows take one
    standalone fold launch."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_board_pair as cbp
    from flipcomplexityempirical_tpu_torch.kernel import cuda_summary as cs
    from flipcomplexityempirical_tpu_torch.stats.accumulators import (
        DeviceAnalytics)
    g = graphs.square_grid(16, 16)
    spec = Spec(n_districts=4, proposal="pair")
    bg, st, params = init_board(g, graphs.stripes_plan(g, 4), n_chains=16,
                                seed=8, spec=spec, base=1.2, pop_tol=0.4,
                                device=card)
    n0, l0 = cbp.run_board_pair_chunk_cuda.launches, \
        cl.run_lowered_chunk_cuda.launches
    res = run_board(bg, spec, params, st, n_steps=101, chunk=25,
                    device=card)
    assert cbp.run_board_pair_chunk_cuda.launches == n0 + 4
    assert cl.run_lowered_chunk_cuda.launches == l0
    assert int(res.state.accept_count.sum()) > 0
    an = DeviceAnalytics(16, observable="cut_count", device=card)
    f0 = cs.summary_fold.launches
    run_board(bg, spec, params, st, n_steps=101, chunk=25,
              record_history=False, analytics=an, device=card)
    assert cs.summary_fold.launches == f0 + 5     # the final record too


def _recom_inputs(graph, plan, k, chains, tol, seed, card, warm_moves=0,
                  eps=None, retries=4):
    """A ReCom batch on the card: (dg, spec, params, state, kw), the state
    advanced by ``warm_moves`` kernel moves first."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_recom as cr
    spec = Spec(n_districts=k, proposal="pair" if k > 2 else "bi")
    dg, st, params = init_batch(graph, plan, n_chains=chains, seed=seed,
                                spec=spec, base=1.0, pop_tol=tol,
                                device=card)
    kw = dict(epsilon=tol if eps is None else eps,
              pop_target=float(graph.pop.sum()) / k, tree_retries=retries)
    if warm_moves:
        st, _ = cr.run_recom_chunk_cuda(dg, None, spec, params, st,
                                        warm_moves, **kw)
    return dg, spec, params, st, kw


def _recom_case(card, case):
    if case == "dual-k4":
        from flipcomplexityempirical_tpu_torch.workloads.data import (
            load_fixture)
        g, _ = graphs.from_geojson(load_fixture(), pop_property="POP")
        return g, graphs.stripes_plan(g, 4), 4, 0.4
    n, k = {"8x8-k2": (8, 2), "8x8-k4": (8, 4), "16x16-k4": (16, 4),
            "32x32-k4": (32, 4), "6x6-k2": (6, 2)}[case]
    g = graphs.square_grid(n, n)
    return g, graphs.stripes_plan(g, k), k, 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["8x8-k2", "32x32-k4", "dual-k4",
                                  "6x6-k2", "64x64-k4"])
def test_recom_smem_bytes_matches_the_kernel(card, case):
    """The wrapper's shared-memory formula, which its refusals use, equals
    the byte count the kernel's own layout gives for the graphs the card
    runs."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_recom as cr
    g = (graphs.square_grid(64, 64) if case == "64x64-k4"
         else _recom_case(card, case)[0])
    dg, _, _ = init_batch(g, graphs.stripes_plan(g, 2), n_chains=1, seed=0,
                          spec=Spec(n_districts=2, proposal="bi"),
                          base=1.0, pop_tol=0.5, device=card)
    assert cr.smem_bytes(dg.n_nodes, dg.n_edges) == \
        cr.launch_shape(dg, 1)["smem_bytes"]


@pytest.mark.cuda
@pytest.mark.parametrize("case,chains,t_len,warm,eps,retries", [
    ("8x8-k2", 8, 8, 4, None, 4),
    ("8x8-k4", 8, 8, 4, None, 4),
    ("16x16-k4", 5, 6, 3, None, 4),
    ("32x32-k4", 3, 4, 2, None, 4),
    ("dual-k4", 4, 6, 3, None, 4),
    ("6x6-k2", 16, 6, 2, 0.06, 1),
])
def test_recom_kernel_matches_plain_version(card, case, chains, t_len, warm,
                                            eps, retries):
    """recom_chunk against its plain version from a state the kernel
    advanced: every state field and row bit-equal, one launch counted a
    call, the inputs left as they were; at 6x6, eps 0.06 and one attempt
    some moves find no balanced edge."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_recom as cr
    g, plan, k, tol = _recom_case(card, case)
    dg, spec, params, st, kw = _recom_inputs(g, plan, k, chains, tol, 1,
                                             card, warm, eps, retries)
    kept = {f: v.clone() for f, v in dataclasses.asdict(st).items()
            if isinstance(v, torch.Tensor)}
    n0 = cr.run_recom_chunk_cuda.launches
    got, rows = cr.run_recom_chunk_cuda(dg, None, spec, params, st, t_len,
                                        **kw)
    assert cr.run_recom_chunk_cuda.launches == n0 + 1
    want, wrows = recom_chunk_reference(dg, spec, params, st, t_len, **kw)
    assert sorted(rows) == sorted(wrows)
    for name in rows:
        assert torch.equal(rows[name], wrows[name]), name
    for f, v in dataclasses.asdict(want).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(got, f).to(v.dtype), v), f
    for f, v in kept.items():
        assert torch.equal(getattr(st, f), v), f
    if case == "6x6-k2":
        assert int((got.exhausted_count - st.exhausted_count).sum()) > 0
    assert int((got.accept_count - st.accept_count).sum()) > 0


@pytest.mark.cuda
def test_run_recom_goes_through_the_kernel(card):
    """run_recom launches recom_chunk once a chunk, and its run equals
    the plain chunks' run (the initial record first, then 5 chunks of 4
    moves thinned to every second yield)."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_recom as cr
    from flipcomplexityempirical_tpu_torch.sampling import recom
    g = graphs.square_grid(12, 12)
    dg, spec, params, st, kw = _recom_inputs(g, graphs.stripes_plan(g, 4),
                                             4, 6, 0.25, 3, card)
    n0 = cr.run_recom_chunk_cuda.launches
    res = recom.run_recom(dg, spec, params, st, n_steps=21, chunk=4,
                          record_every=2, **kw)
    assert cr.run_recom_chunk_cuda.launches == n0 + 5
    state, hist = st, []
    for _ in range(5):
        state, rows = recom_chunk_reference(dg, spec, params, state, 4,
                                            **kw)
        hist.append(rows["cut_count"][1::2].T.cpu().numpy())
    np.testing.assert_array_equal(res.history["cut_count"][:, 1:],
                                  np.concatenate(hist, axis=1))
    assert torch.equal(res.state.assignment, state.assignment)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lazy_uniform", "no parity",
                                     "no waits", "half the pair's target",
                                     "flip cursor"])
def test_recom_kernel_variants_match_plain_version(card, variant):
    """The kernel's other settings against the plain version, bit-equal:
    the weight row, parity_metrics and geom_waits off, pop_target None
    (half the merged pair's population), and a state whose last flip
    cursor is set (a flip chain's state), where the record's parity
    bookkeeping runs on the moves that find no balanced edge (one tree
    attempt at eps 0.06)."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_recom as cr
    g = graphs.square_grid(10, 10)
    k, eps, retries = (2, 0.06, 1) if variant == "flip cursor" else (
        4, 0.25, 4)
    dg, spec, params, st, kw = _recom_inputs(
        g, graphs.stripes_plan(g, k), k, 12, eps, 5, card, 3,
        retries=retries)
    spec = dataclasses.replace(spec, **{
        "lazy_uniform": dict(lazy_uniform=True),
        "no parity": dict(parity_metrics=False),
        "no waits": dict(geom_waits=False)}.get(variant, {}))
    if variant == "half the pair's target":
        kw["pop_target"] = None
    if variant == "flip cursor":
        gen = torch.Generator(device="cpu").manual_seed(5)
        st = st.replace(
            cur_flip_node=torch.randint(0, 100, (12,), generator=gen).to(
                card, torch.int32),
            last_flipped=torch.randint(0, 3, st.last_flipped.shape,
                                       generator=gen).to(card, torch.int32))
    got, rows = cr.run_recom_chunk_cuda(dg, None, spec, params, st, 8, **kw)
    want, wrows = recom_chunk_reference(dg, spec, params, st, 8, **kw)
    assert sorted(rows) == sorted(wrows) == sorted(cr.row_names(spec))
    for name in rows:
        assert torch.equal(rows[name], wrows[name]), name
    for f, v in dataclasses.asdict(want).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(got, f).to(v.dtype), v), f
    if variant == "flip cursor":
        assert int((got.exhausted_count - st.exhausted_count).sum()) > 0
        assert not torch.equal(got.num_flips, st.num_flips)
