"""The port's board chunk against the JAX package's Pallas board kernel.

Both sides read the same uint32 bits, made by numpy from a seed: the JAX
side runs ``pallas_board.run_pallas_chunk(host_rng=True, interpret=True)``
as ``tests/test_pallas_board.py`` does, the port side runs
``cuda_board.run_board_chunk_cuda`` on CPU tensors, which is the kernel's
plain version. Tolerance (``_torch_parity``): every integer output
bit-equal; waits bit-equal up to torch/XLA ``log`` rounding, at most 1e-3
of entries and each off by exactly 1.0.

``test_torch_cuda.py`` holds the kernel itself against the plain version
on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import pallas_board as pb
from flipcomplexityempirical_tpu_torch import convert
from flipcomplexityempirical_tpu_torch.kernel import cuda_board as cb

from _torch_parity import (assert_wait_sums_close, assert_waits_close,
                           jax_host, spec_port, uint32_bits)

H, W = 8, 16
N = H * W
C, T, BLOCK = 16, 40, 8

# (base, pop_tol, init seed, bits seed): the default case; pop_tol=0 on a
# balanced plan, where every draw is invalid and the chain self-loops; and
# a pop_tol tight enough that the population gate binds on most steps
CASES = {
    "default": (1.4, 0.3, 0, 11),
    "empty_valid_set": (1.0, 0.0, 1, 12),
    "tight_pop_gate": (1.4, 0.02, 2, 13),
}


def _jax_setup(base, tol, seed):
    g = fce.graphs.square_grid(H, W)
    plan = fce.graphs.stripes_plan(g, 2)
    spec = fce.Spec(contiguity="patch")
    bg, st, params = fce.sampling.init_board(
        g, plan, n_chains=C, seed=seed, spec=spec, base=base, pop_tol=tol)
    return spec, bg, st, params


def _both(base, tol, seed, bits_seed):
    spec, bg, st, params = _jax_setup(base, tol, seed)
    rng = np.random.default_rng(bits_seed)
    plane = uint32_bits(rng, T, C, N)
    scal_bits = uint32_bits(rng, T, 2, C)

    pop_plane, deg_plane, masks8 = pb.make_static_inputs(bg)
    dist_pop, scal, ints = pb.pack_state(st, params)
    want = pb.run_pallas_chunk(
        spec, H, W, T, BLOCK, jnp.zeros(C // BLOCK, jnp.int32), st.board,
        pop_plane, deg_plane, masks8, dist_pop, scal, ints,
        jnp.asarray(plane), jnp.asarray(scal_bits), host_rng=True,
        interpret=True)
    want = [np.asarray(x) for x in want]

    tbg = convert.board_graph(jax_host(bg), device="cpu")
    tst = convert.board_state(jax_host(st), device="cpu")
    tpar = convert.step_params(jax_host(params), device="cpu")
    tpop, tdeg = cb.make_static_inputs(tbg)
    tdp, tscal, tints = cb.pack_state(tst, tpar)
    launches = cb.run_board_chunk_cuda.launches
    got = cb.run_board_chunk_cuda(
        spec_port(spec), H, W, T, 0, 0, tst.board, tpop, tdeg, tdp, tscal,
        tints, cb.bits_tensor(plane, "cpu"), cb.bits_tensor(scal_bits, "cpu"))
    assert cb.run_board_chunk_cuda.launches == launches  # plain version
    return want, [x.numpy() for x in got]


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_matches_pallas_kernel(case):
    want, got = _both(*CASES[case])
    names = ("board", "dist_pop", "scal", "ints", "log_f", "log_s",
             "hist_cut", "hist_b", "hist_wait", "hist_acc", "cut_e",
             "cut_s")
    for name, w_arr, g_arr in zip(names, want, got):
        if name in ("scal", "hist_wait"):
            continue
        assert g_arr.shape == w_arr.shape, name
        np.testing.assert_array_equal(g_arr, w_arr.astype(g_arr.dtype),
                                      err_msg=name)
    bad = assert_waits_close(got[8], want[8], "hist_wait")
    assert_waits_close(got[2][0], want[2][0], "cur_wait")
    assert_wait_sums_close(got[2][1], want[2][1], bad.sum(axis=0))
    if case == "empty_valid_set":
        assert (got[3][5] == 0).all() and (got[3][6] == T).all()
    if case == "tight_pop_gate":
        # chains moved, yet the gate held each district within 64 +- 1
        assert (got[3][5] >= 2).any()
        assert np.abs(got[1] - N // 2).max() <= 1


def test_chunk_requires_the_rook_degree():
    """The kernel's boundary test is the OR of the rook "differ" planes,
    which equals deg - same_deg > 0 only for the grid's rook degree:
    ``make_static_inputs``, which makes the kernel's planes once a run,
    refuses a board graph with any other deg plane."""
    spec, bg, st, params = _jax_setup(1.4, 0.3, 0)
    tbg = convert.board_graph(jax_host(bg), device="cpu")
    tpop, tdeg = cb.make_static_inputs(tbg)
    assert torch.equal(tdeg, cb.rook_degree(H, W, "cpu"))
    bad = tdeg.clone()
    bad[5] += 1
    with pytest.raises(ValueError, match="rook degree"):
        cb.make_static_inputs(dataclasses.replace(tbg, deg=bad))
