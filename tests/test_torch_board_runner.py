"""The port's whole runner against the JAX package's Pallas runner.

``run_board_cuda(device="cpu", _host_bits=...)`` and
``run_board_pallas(interpret=True, _host_bits=...)`` read the same bits
(the setup of ``test_pallas_board.py::test_pallas_runner_end_to_end_
interpret``: 8 chains, 121 steps, chunk 40), so every BoardState field,
every history row and ``waits_total`` agree under ``_torch_parity``'s
tolerance (integers bit-equal; waits up to torch/XLA ``log`` rounding).
The final record's wait is drawn through the port's threefry, so the
epilogue agrees draw for draw too. The port's result also passes the
chain invariants on its own.
"""

import numpy as np

import jax.numpy as jnp

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu_torch import convert
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel.step import Spec
from flipcomplexityempirical_tpu_torch.sampling import (init_board,
                                                        run_board_cuda)

from _torch_parity import (assert_wait_sums_close, assert_waits_close,
                           jax_host, spec_port, uint32_bits)
from conftest import assert_grid_districts_connected

H, W = 8, 16
CHAINS, STEPS, CHUNK = 8, 121, 40


def _bits(chunk_idx, t, c, n):
    r = np.random.default_rng(1000 + chunk_idx)
    return uint32_bits(r, t, c, n), uint32_bits(r, t, 2, c)


def _runs():
    g = fce.graphs.square_grid(H, W)
    plan = fce.graphs.stripes_plan(g, 2)
    spec = fce.Spec(contiguity="patch")
    bg, st, params = fce.sampling.init_board(
        g, plan, n_chains=CHAINS, seed=0, spec=spec, base=1.4, pop_tol=0.2)
    want = fce.sampling.run_board_pallas(
        bg, spec, params, st, n_steps=STEPS, chunk=CHUNK, block_chains=8,
        interpret=True,
        _host_bits=lambda *a: tuple(jnp.asarray(x) for x in _bits(*a)))
    got = run_board_cuda(
        convert.board_graph(jax_host(bg), device="cpu"), spec_port(spec),
        convert.step_params(jax_host(params), device="cpu"),
        convert.board_state(jax_host(st), device="cpu"), n_steps=STEPS,
        chunk=CHUNK, device="cpu", _host_bits=_bits)
    return want, got


def test_runner_matches_pallas_runner():
    want, got = _runs()
    ws = jax_host(want.state)
    gs = got.host_state()
    bad = assert_waits_close(got.history["wait"], want.history["wait"])
    n_bad = bad.sum(axis=1)
    for name, g_arr in gs.items():
        w_arr = np.asarray(getattr(ws, name))
        assert g_arr.shape == w_arr.shape, name
        if name == "cur_wait":
            assert_waits_close(g_arr, w_arr, name)
        elif name == "waits_sum":
            assert_wait_sums_close(g_arr, w_arr, n_bad, name)
        else:
            np.testing.assert_array_equal(g_arr, w_arr.astype(g_arr.dtype),
                                          err_msg=name)
    assert sorted(got.history) == sorted(want.history)
    for k in ("cut_count", "b_count", "accepts"):
        np.testing.assert_array_equal(got.history[k], want.history[k],
                                      err_msg=k)
    assert_wait_sums_close(got.waits_total, want.waits_total, n_bad,
                           "waits_total")
    assert got.n_yields == want.n_yields == STEPS


def test_runner_invariants():
    """The port's run on its own: contiguity, dist_pop and cut_count
    against recounts, cut_times and num_flips tie-outs."""
    g = tgraphs.square_grid(H, W)
    plan = tgraphs.stripes_plan(g, 2)
    spec = Spec(contiguity="patch")
    bg, st, params = init_board(g, plan, n_chains=CHAINS, seed=0, spec=spec,
                                base=1.4, pop_tol=0.2, device="cpu")
    res = run_board_cuda(bg, spec, params, st, n_steps=STEPS, chunk=CHUNK,
                         seed=3, device="cpu")
    s = res.host_state()
    b = s["board"].reshape(CHAINS, H, W)
    assert_grid_districts_connected(b, 2)
    np.testing.assert_array_equal(s["dist_pop"][:, 0],
                                  (b == 0).sum(axis=(1, 2)))
    np.testing.assert_array_equal(
        s["cut_count"], tb.recount_cuts(bg, res.state.board).numpy())
    assert (s["t_yield"] == STEPS).all()
    assert res.history["cut_count"].shape == (CHAINS, STEPS)
    np.testing.assert_array_equal(
        tb.edge_cut_times(g, res.state).sum(axis=1),
        res.history["cut_count"].sum(axis=1))
    np.testing.assert_allclose(
        res.waits_total, res.history["wait"].sum(axis=1, dtype=float),
        rtol=1e-6)
    first = (res.history["accepts"] > 0).argmax(axis=1)
    expect = np.where(res.history["accepts"][:, -1] > 0, STEPS - first, 0)
    np.testing.assert_array_equal(s["num_flips"].sum(axis=1), expect)
    assert (s["accept_count"] > 0).all()
