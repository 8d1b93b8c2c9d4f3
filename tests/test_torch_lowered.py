"""The lowered body's plain chunk against the JAX package's chunk.

``cuda_lowered.run_chunk`` on the CPU (the kernel's plain version, a
replay of the int8 lowered body) and the JAX package's
``board.run_board_chunk`` start from the same state (each package's own
``init_board`` with the same seed) and draw the same threefry stream, so
they agree step for step. The JAX side runs its int8 lowered body
(``bits=False``): ``tests/test_bitboard_lowered.py`` holds it bit-identical
to the packed body its dispatch picks, and it compiles in a fraction of
the time.

Tolerance: integer fields and histories bit-equal; waits as
``_torch_parity`` allows (torch's and XLA's ``log`` may round one input
differently); slope and angle within 4 ulp, NaN exactly where the JAX
value is NaN.
"""

import dataclasses

import numpy as np
import pytest

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import board as kb
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch import init_board
from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl

from _torch_parity import (assert_ulps_close, assert_wait_sums_close,
                           assert_waits_close, spec_port)

SURGERY = dict(remove_nodes=[(0, 0), (2, 3)],
               extra_edges=[((0, 1), (1, 0)), ((3, 4), (4, 5))])
CHAINS, T = 6, 30


def _graphs(name):
    if name == "surgical":
        return (fce.graphs.square_grid(5, 7, **SURGERY),
                tgraphs.square_grid(5, 7, **SURGERY))
    if name == "queen":
        return (fce.graphs.square_grid(6, queen=True),
                tgraphs.square_grid(6, queen=True))
    return fce.graphs.frankengraph(6), tgraphs.frankengraph(6)


def _init(name, spec, chains=CHAINS, seed=3, base=1.3, pop_tol=0.3):
    """Each package's own init_board on the same graph, plan and seed."""
    g, tg = _graphs(name)
    if name == "frank":
        plan = fce.graphs.frank_plan(g, 0, m=6)
        tplan = tgraphs.frank_plan(tg, 0, m=6)
    else:
        plan = fce.graphs.stripes_plan(g, 2)
        tplan = tgraphs.stripes_plan(tg, 2)
    want = fce.sampling.init_board(g, plan, n_chains=chains, seed=seed,
                                   spec=spec, base=base, pop_tol=pop_tol)
    got = init_board(tg, tplan, n_chains=chains, seed=seed,
                     spec=spec_port(spec), base=base, pop_tol=pop_tol,
                     device="cpu")
    return g, tg, want, got


def assert_state_close(got, want, n_bad):
    """Every field of the port's state against the JAX state; ``n_bad``
    (C,) counts the waits that differed so far, per chain."""
    for f in dataclasses.fields(got):
        a = getattr(got, f.name)
        b = getattr(want, f.name)
        if a is None:
            assert b is None, f.name
            continue
        a = a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape, f.name
        if f.name == "cur_wait":
            assert_waits_close(a, b, f.name)
        elif f.name == "waits_sum":
            assert_wait_sums_close(a, b, n_bad, f.name)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype),
                                          err_msg=f.name)


def assert_rows_close(got: dict, want: dict):
    """(T, C) rows; returns the per-chain count of differing waits."""
    assert sorted(got) == sorted(want)
    bad = assert_waits_close(got["wait"], want["wait"])
    for k in want:
        if k in ("slope", "angle"):
            assert_ulps_close(got[k], want[k], name=k)
        elif k != "wait":
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)
    return bad.sum(axis=0)


def compare_chunks(name, spec, chunks=2, t_len=T):
    """``chunks`` chunks composed, each from the last one's state, held
    against the JAX package's; returns both final states."""
    _, _, (bg, st, params), (tbg, tst, tpar) = _init(name, spec)
    tspec = spec_port(spec)
    assert cl.supports(tbg, tspec)
    n_bad = np.zeros(CHAINS, np.int64)
    for _ in range(chunks):
        # the keywords as the JAX runner passes them, so that its
        # run_board reuses this compile
        st, outs = kb.run_board_chunk(bg, spec, params, st, t_len,
                                      collect=True, bits=False)
        tst, rows = cl.run_chunk(tbg, tspec, tpar, tst, t_len)
        n_bad += assert_rows_close({k: v.numpy() for k, v in rows.items()},
                                   {k: np.asarray(v) for k, v in
                                    outs.items()})
        assert_state_close(tst, st, n_bad)
    assert int(tst.accept_count.sum()) > 0
    return tst, st


@pytest.mark.parametrize("name,spec_kw", [
    ("surgical", dict(contiguity="patch")),
    ("queen", dict(accept="always", contiguity="none")),
])
def test_plain_chunk_matches_jax(name, spec_kw):
    """Both accept rules and both contiguity modes; the second chunk
    starts from the first's state. The Frankengraph with
    ``record_interface`` is ``test_torch_lowered_runner.py``'s."""
    compare_chunks(name, fce.Spec(**spec_kw))


def test_kernel_contract_refuses_what_it_does_not_serve():
    spec = fce.Spec(contiguity="patch", record_interface=True)
    tg = tgraphs.frankengraph(6)
    tbg, _, tpar = init_board(tg, tgraphs.frank_plan(tg, 0, m=6), n_chains=2,
                              seed=0, spec=spec_port(spec), base=1.3,
                              pop_tol=0.3, device="cpu")
    for kw in (dict(accept="corrected"), dict(anneal="linear"),
               dict(contiguity="exact")):
        bad = spec_port(fce.Spec(**{"contiguity": "patch",
                                    "record_interface": True, **kw}))
        with pytest.raises(ValueError):
            cl.check(tbg, bad, tpar)
    # a non-uniform population plane
    tbg2 = dataclasses.replace(tbg, uniform_pop=False)
    with pytest.raises(ValueError):
        cl.check(tbg2, spec_port(spec), tpar)
