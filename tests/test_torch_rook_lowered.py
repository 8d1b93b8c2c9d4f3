"""Plain rook grids through the port's ``run_board`` (the lowered-chunk
kernel's plain version on the grid's stencil) against the JAX package's
``run_board`` on its rook bodies.

Both packages start from their own ``init_board`` with the same seed and
draw the same threefry stream, so they agree step for step: every history
key, every state field (the rook state keeps no diagonal cut planes),
``waits_total`` and the per-edge cut_times. The JAX side runs its int8
rook body (``bits=False``, which ``tests/test_bitboard.py`` holds
bit-identical to the packed ``_scan_bits``); the comparison with
``_scan_bits`` itself compiles far longer and sits in the slow tier.

Tolerance: integers bit-equal; waits as ``_torch_parity`` allows (torch's
and XLA's ``log`` may round one input differently, each such wait off by
exactly 1.0).
"""

import numpy as np
import pytest
import torch

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import board as kb
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch import Spec, init_board, run_board
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl
from flipcomplexityempirical_tpu_torch.sampling import board_runner

from _torch_parity import assert_wait_sums_close, assert_waits_close, spec_port
from test_torch_lowered import assert_state_close

CHAINS, T = 6, 40
N_STEPS = 2 * T + 1          # two chunks of T transitions, then the final


def _init(h, w, spec, seed=3, base=1.3, pop_tol=0.3, chains=CHAINS):
    """Each package's own init_board on the h x w grid's stripes start."""
    g = fce.graphs.square_grid(h, w)
    tg = tgraphs.square_grid(h, w)
    want = fce.sampling.init_board(g, fce.graphs.stripes_plan(g, 2),
                                   n_chains=chains, seed=seed, spec=spec,
                                   base=base, pop_tol=pop_tol)
    got = init_board(tg, tgraphs.stripes_plan(tg, 2), n_chains=chains,
                     seed=seed, spec=spec_port(spec), base=base,
                     pop_tol=pop_tol, device="cpu")
    return g, tg, want, got


def _compare_runs(h, w, spec_kw, init_kw, bits):
    spec = fce.Spec(**spec_kw)
    g, tg, (bg, st, params), (tbg, tst, tpar) = _init(h, w, spec, **init_kw)
    assert not tb.is_lowered(tbg, spec_port(spec))
    want = fce.sampling.run_board(bg, spec, params, st, n_steps=N_STEPS,
                                  chunk=T, bits=bits)
    got = run_board(tbg, spec_port(spec), tpar, tst, n_steps=N_STEPS,
                    chunk=T, device="cpu")
    assert got.n_yields == want.n_yields == N_STEPS
    assert sorted(got.history) == sorted(want.history)
    bad = assert_waits_close(got.history["wait"], want.history["wait"])
    n_bad = bad.sum(axis=1)
    for k, v in want.history.items():
        if k != "wait":
            np.testing.assert_array_equal(got.history[k], np.asarray(v),
                                          err_msg=k)
    assert got.state.cut_times_se is None and got.state.cut_times_sw is None
    assert_state_close(got.state, want.state, n_bad)
    assert_wait_sums_close(got.waits_total, want.waits_total, n_bad,
                           "waits_total")
    np.testing.assert_array_equal(kb.edge_cut_times(g, want.state),
                                  tb.edge_cut_times(tg, got.state))
    assert int(got.state.accept_count.sum()) > 0
    return got


@pytest.mark.parametrize("h,w,spec_kw,init_kw", [
    (6, 7, dict(contiguity="patch"), {}),
    (6, 7, dict(contiguity="patch"), dict(seed=11, base=0.4, pop_tol=0.5)),
    (5, 8, dict(accept="always", contiguity="none"), {}),
], ids=["6x7-patch", "6x7-seed11-base0.4", "5x8-always-none"])
def test_run_board_matches_jax_rook_body(h, w, spec_kw, init_kw):
    _compare_runs(h, w, spec_kw, init_kw, bits=False)


@pytest.mark.slow
def test_run_board_matches_jax_scan_bits():
    """4 x 32: the width the JAX package packs, against ``_scan_bits``."""
    _compare_runs(4, 32, dict(contiguity="patch"), {}, bits=True)


def test_history_device_equals_the_host_history():
    """``history_device=True`` keeps a segment's history as tensors on the
    run's device, equal to the numpy history (thinned as well)."""
    spec = Spec(contiguity="patch")
    tg = tgraphs.square_grid(5, 6)
    plan = tgraphs.stripes_plan(tg, 2)
    bg, st, params = init_board(tg, plan, n_chains=4, seed=2, spec=spec,
                                base=1.2, pop_tol=0.3, device="cpu")
    for kw in (dict(record_every=3), {}):
        host = board_runner.run_board_segment(bg, spec, params, st, 30,
                                              chunk=10, device="cpu", **kw)
        dev = board_runner.run_board_segment(bg, spec, params, st, 30,
                                             chunk=10, history_device=True,
                                             device="cpu", **kw)
        assert sorted(host.history) == sorted(dev.history)
        for k, v in dev.history.items():
            assert isinstance(v, torch.Tensor), k
            assert isinstance(host.history[k], np.ndarray), k
            np.testing.assert_array_equal(v.numpy(), host.history[k],
                                          err_msg=k)
        np.testing.assert_array_equal(host.waits_total, dev.waits_total)


def test_segment_history_device_composes():
    """Segments with the history kept on the device compose into the
    unsegmented run, as the experiment driver uses them."""
    spec = Spec(contiguity="patch")
    tg = tgraphs.square_grid(4, 9)
    bg, st, params = init_board(tg, tgraphs.stripes_plan(tg, 2), n_chains=3,
                                seed=5, spec=spec, base=1.1, pop_tol=0.4,
                                device="cpu")
    whole = run_board(bg, spec, params, st, n_steps=41, chunk=10,
                      device="cpu")
    parts, state, waits = {}, st, np.zeros(3)
    for n in (15, 25):
        seg = board_runner.run_board_segment(bg, spec, params, state, n,
                                             chunk=10, history_device=True,
                                             device="cpu")
        state = seg.state
        waits += seg.waits_total
        for k, v in seg.history.items():
            parts.setdefault(k, []).append(v.numpy())
    res = board_runner.finalize_board_run(bg, spec, params, state, parts,
                                          waits, [], True, 41)
    for k, v in whole.history.items():
        np.testing.assert_array_equal(res.history[k], v, err_msg=k)
    assert torch.equal(res.state.board, whole.state.board)
    np.testing.assert_allclose(res.waits_total, whole.waits_total,
                               rtol=1e-6)


def test_run_board_refuses_large_rook_grids_and_the_int8_body():
    spec = Spec(contiguity="patch")
    tg = tgraphs.square_grid(65, 65)
    bg, st, params = init_board(tg, tgraphs.stripes_plan(tg, 2), n_chains=2,
                                seed=0, spec=spec, base=2.0, pop_tol=0.1,
                                device="cpu")
    assert bg.n > cl.MAX_CELLS
    with pytest.raises(ValueError, match="B2"):
        run_board(bg, spec, params, st, n_steps=3, device="cpu")
    tg = tgraphs.square_grid(64, 64)
    bg, st, params = init_board(tg, tgraphs.stripes_plan(tg, 2), n_chains=2,
                                seed=0, spec=spec, base=2.0, pop_tol=0.1,
                                device="cpu")
    assert bg.n == cl.MAX_CELLS and cl.supports(bg, spec)
    with pytest.raises(ValueError, match="B7"):
        run_board(bg, spec, params, st, n_steps=3, bits=False, device="cpu")
    with pytest.raises(ValueError, match="B7"):
        cl.body_for(bg, spec, bits=False)
    # nothing ran
    assert torch.equal(st.t_yield, torch.zeros_like(st.t_yield))


def test_rook_static_inputs_fit_the_kernel():
    """What ``csrc/lowered_chunk.cu`` assumes of a rook stencil: the eight
    ring directions with edges only in the four rook ones, no wall keys,
    and a patch class per distinct B2 window, the rook radius-2 ball."""
    spec = Spec(contiguity="patch")
    tg = tgraphs.square_grid(7, 9)
    bg, _, params = init_board(tg, tgraphs.stripes_plan(tg, 2), n_chains=1,
                               seed=0, spec=spec, base=2.0, pop_tol=0.1,
                               device="cpu")
    static = cl.make_static_inputs(bg, spec, params)
    adj = static.adj_words
    assert adj.shape == (8, 2)
    assert bool((adj[1::2] == 0).all()) and bool((adj[0::2] != 0).all())
    assert bool((static.wall_words == 0).all())
    assert bool((static.iface_key == tb.IFACE_BIG).all())
    # an interior cell's window: 12 patch members (|dr| + |dc| <= 2), its 4
    # rook neighbours as seeds
    row = static.class_rows[static.cell_class[3 * 9 + 4]] & 0xFFFFFFFF
    member, seeds = int(row[0]) & 0xFFFFFFFF, int(row[1]) & 0xFFFFFFFF
    want = {5 * (dr + 2) + dc + 2 for dr in range(-2, 3)
            for dc in range(-2, 3) if 0 < abs(dr) + abs(dc) <= 2}
    assert {p for p in range(25) if member >> p & 1} == want
    assert {p for p in range(25) if seeds >> p & 1} == {7, 11, 13, 17}


@pytest.mark.parametrize("graph", ["square64", "square6x7", "sec11",
                                   "frank"])
def test_body_for_equals_jax(graph):
    spec = fce.Spec(contiguity="patch")
    if graph == "sec11":
        g, tg = fce.graphs.grid_sec11(), tgraphs.grid_sec11()
    elif graph == "frank":
        g, tg = fce.graphs.frankengraph(), tgraphs.frankengraph()
    else:
        h, w = (64, 64) if graph == "square64" else (6, 7)
        g, tg = fce.graphs.square_grid(h, w), tgraphs.square_grid(h, w)
    want = kb.body_for(kb.make_board_graph(g), spec)
    got = cl.body_for(tb.make_board_graph(tg, device="cpu"), spec_port(spec))
    assert got == want
    assert want == {"square64": "bitboard", "square6x7": "board",
                    "sec11": "lowered_bits", "frank": "lowered_bits"}[graph]
