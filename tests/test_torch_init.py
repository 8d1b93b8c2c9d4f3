"""The port's foundation against the JAX package: threefry draws, graph
builders, BoardGraph planes, initial state, params; and the device rule
(entry points default to CUDA and raise without a card).

Tolerance: everything bit-equal, except ``make_params``' f32 ``log(base)``,
which may differ by 1 ulp (torch's and XLA's ``log`` round differently on
some inputs).
"""

import numpy as np
import pytest
import torch

import jax

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import board as kb
from flipcomplexityempirical_tpu.kernel import pallas_board as pb
from flipcomplexityempirical_tpu.kernel import step as kstep
from flipcomplexityempirical_tpu_torch import convert, rng as trng
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel import cuda_board as cb
from flipcomplexityempirical_tpu_torch.kernel import step as tstep
from flipcomplexityempirical_tpu_torch.sampling import (init_board,
                                                        run_board_cuda)

from _torch_parity import jax_host, spec_port


def test_threefry_matches_jax_random():
    keys = jax.random.split(jax.random.PRNGKey(7), 400)
    tkeys = trng.split(trng.prng_key(7), 400)
    np.testing.assert_array_equal(tkeys.numpy(),
                                  np.asarray(jax.random.key_data(keys)))
    want4 = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    np.testing.assert_array_equal(trng.split(tkeys, 4).numpy(),
                                  np.asarray(jax.random.key_data(want4)))
    np.testing.assert_array_equal(trng.uniform(tkeys).numpy(),
                                  np.asarray(jax.vmap(jax.random.uniform)(keys)))
    for seed in (0, 1, -3, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            trng.prng_key(seed).numpy(),
            np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))


def test_philox_known_answers():
    """Philox4x32-10 reference vectors (Random123's kat_vectors)."""
    zero = [int(x) for x in trng.philox4x32(0, 0, 0, 0, 0, 0)]
    assert zero == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    ones = 0xFFFFFFFF
    got = [int(x) for x in trng.philox4x32(ones, ones, ones, ones, ones,
                                           ones)]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


@pytest.mark.parametrize("h,w", [(8, 16), (64, 64), (5, 3)])
def test_builders_and_board_graph_match(h, w):
    g, tg = fce.graphs.square_grid(h, w), tgraphs.square_grid(h, w)
    assert tg.labels == g.labels and tg.name == g.name
    for name in ("edges", "deg", "pop", "coords"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(g, name),
                                      err_msg=name)
    assert (tg.n_nodes, tg.n_edges) == (g.n_nodes, g.n_edges)
    for axis in (0, 1):
        np.testing.assert_array_equal(tgraphs.stripes_plan(tg, 2, axis),
                                      fce.graphs.stripes_plan(g, 2, axis))
    bg = kb.make_board_graph(g)
    tbg = tb.make_board_graph(tg, device="cpu")
    assert (tbg.h, tbg.w) == (bg.h, bg.w) == tb.board_shape(tg)
    for name in ("pop", "deg", "east_ok", "west_ok"):
        np.testing.assert_array_equal(getattr(tbg, name).numpy(),
                                      np.asarray(getattr(bg, name)),
                                      err_msg=name)


def test_init_board_matches_jax():
    g = fce.graphs.square_grid(8, 16)
    spec = fce.Spec(contiguity="patch")
    bg, st, params = fce.sampling.init_board(
        g, fce.graphs.stripes_plan(g, 2), n_chains=12, seed=5, spec=spec,
        base=2.63815853, pop_tol=0.1)
    tg = tgraphs.square_grid(8, 16)
    tbg, tst, tpar = init_board(tg, tgraphs.stripes_plan(tg, 2),
                                n_chains=12, seed=5, spec=spec_port(spec),
                                base=2.63815853, pop_tol=0.1, device="cpu")
    ws = jax_host(st)
    for name, got in convert.to_numpy(tst).items():
        np.testing.assert_array_equal(
            got, np.asarray(getattr(ws, name)).astype(got.dtype),
            err_msg=name)
    # the state carried across through convert is the port's own init
    carried = convert.to_numpy(convert.board_state(ws, device="cpu"))
    for name, got in convert.to_numpy(tst).items():
        np.testing.assert_array_equal(got, carried[name], err_msg=name)
    wp = jax_host(params)
    for name in ("beta", "pop_lo", "pop_hi", "label_values"):
        np.testing.assert_array_equal(getattr(tpar, name).numpy(),
                                      getattr(wp, name), err_msg=name)
    np.testing.assert_array_equal(
        tb.recount_cuts(tbg, tst.board).numpy(),
        np.asarray(kb.recount_cuts(bg, st.board)))


def test_kernel_supports_the_pallas_kernels_subset():
    """``cuda_board.supports`` / ``check`` accept what
    ``pallas_board.supports`` / ``check`` accept on these inputs."""
    g, tg = fce.graphs.square_grid(8, 16), tgraphs.square_grid(8, 16)
    for kw in ({}, {"accept": "always"}, {"anneal": "linear"},
               {"contiguity": "none"}):
        spec = fce.Spec(**kw)
        _, _, params = fce.sampling.init_board(
            g, fce.graphs.stripes_plan(g, 2), n_chains=8, seed=0,
            spec=spec, base=2.0, pop_tol=0.2)
        tpar = convert.step_params(jax_host(params), device="cpu")
        want = pb.supports(g, spec, params, 8, block_chains=8)
        assert cb.supports(tg, spec_port(spec), tpar) == want, kw
        if not want:
            with pytest.raises(ValueError):
                cb.check(spec_port(spec), tpar)


@pytest.mark.parametrize("base", [2.63815853, 1.4, 1.0, 3.0, 0.5])
def test_make_params_log_base_within_one_ulp(base):
    want = np.asarray(kstep.make_params(base, 1.0, 2.0, [1, -1]).log_base)
    got = tstep.make_params(base, 1.0, 2.0, [1, -1],
                            device="cpu").log_base.numpy()
    assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Without a card, an entry point called with no device raises; it
    never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = tgraphs.square_grid(4, 4)
    plan = tgraphs.stripes_plan(g, 2)
    spec = tstep.Spec()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_board(g, plan, n_chains=2, seed=0, spec=spec, base=2.0,
                   pop_tol=0.2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.make_board_graph(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.make_params(2.0, 1.0, 2.0, [1, -1])
    bg, st, params = init_board(g, plan, n_chains=2, seed=0, spec=spec,
                                base=2.0, pop_tol=0.2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_board_cuda(bg, spec, params, st, n_steps=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.board_state(jax_host(fce.sampling.init_board(
            fce.graphs.square_grid(4, 4),
            fce.graphs.stripes_plan(fce.graphs.square_grid(4, 4), 2),
            n_chains=2, seed=0, spec=fce.Spec(), base=2.0,
            pop_tol=0.2)[1]))
