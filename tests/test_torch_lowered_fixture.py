"""A small sec11 run of the JAX package, kept as a fixture for the card.

``tests/fixtures/torch/lowered_sec11.npz`` holds one 50-step chunk of the
JAX package's lowered body on the sec11 graph (4 chains, config 0B263P10
with ``record_interface``): its history rows, its final per-chain state,
the final board in node order and the chunk's per-edge cut counts. The
card's machine has no JAX, so ``chip_smoke.py`` holds the CUDA kernel
against this file; here the file is checked to be what the JAX package
makes now, and the port's plain version is held against it.

Regenerate with ``python tests/test_torch_lowered_fixture.py`` (JAX on the
CPU).

Tolerance against the fixture: integer fields bit-equal; slope and angle
within 4 ulp, NaN where the fixture's is NaN; waits equal except where
``log`` rounds one input differently in the two libraries, which moves a
wait by exactly 1.0 and repeats it until the chain's next accept: such
entries are counted, each off by exactly 1.0, at most 2% of the rows.
"""

import os
import pathlib

import numpy as np
import pytest

FIXTURE = (pathlib.Path(__file__).resolve().parent / "fixtures" / "torch"
           / "lowered_sec11.npz")
SEED, CHAINS, T = 11, 4, 50
BASE, POP_TOL, ALIGNMENT = 2.63815853, 0.1, 0
ROW_KEYS = ("cut_count", "b_count", "accepts", "wait", "slope", "angle")
STATE_KEYS = ("key", "dist_pop", "cut_count", "cur_wait", "wait_pending",
              "cur_flip", "cur_sign", "t_yield", "move_clock",
              "accept_count", "exhausted_count", "waits_sum")
WAIT_SHARE = 0.02


def make_fixture() -> dict:
    """The JAX package's chunk, as the arrays the fixture holds."""
    import flipcomplexityempirical_tpu as fce
    from flipcomplexityempirical_tpu.kernel import board as kb

    g = fce.graphs.grid_sec11()
    spec = fce.Spec(contiguity="patch", record_interface=True)
    bg, st, params = fce.sampling.init_board(
        g, fce.graphs.sec11_plan(g, ALIGNMENT), n_chains=CHAINS, seed=SEED,
        spec=spec, base=BASE, pop_tol=POP_TOL)
    st, outs = kb.run_board_chunk(bg, spec, params, st, T, bits=False)
    out = {f"row_{k}": np.asarray(outs[k]) for k in ROW_KEYS}
    out.update({f"state_{k}": np.asarray(getattr(st, k))
                for k in STATE_KEYS})
    out["state_key"] = out["state_key"].astype(np.int64)
    out["board_nodes"] = np.asarray(kb.node_view(bg, st.board), np.int8)
    out["edge_cut_times"] = kb.edge_cut_times(g, st).astype(np.int16)
    return out


def compare(got: dict, want: dict) -> int:
    """Hold ``got`` (the fixture's keys) against the fixture; returns the
    number of differing wait rows."""
    bad = got["row_wait"] != want["row_wait"]
    n_bad = int(bad.sum())
    assert n_bad <= WAIT_SHARE * bad.size, n_bad
    assert (np.abs(got["row_wait"][bad] - want["row_wait"][bad]) == 1.0).all()
    for k in ("slope", "angle"):
        g, w = got[f"row_{k}"], want[f"row_{k}"]
        nan = np.isnan(w)
        np.testing.assert_array_equal(np.isnan(g), nan, err_msg=k)
        d = np.abs(g[~nan].view(np.int32).astype(np.int64)
                   - w[~nan].view(np.int32).astype(np.int64))
        assert ((g[~nan] == w[~nan]) | (d <= 4)).all(), k
    chain_bad = bad.any(axis=0)
    for k in want:
        if k in ("row_wait", "row_slope", "row_angle"):
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k in ("state_cur_wait", "state_waits_sum"):
            np.testing.assert_array_equal(g[~chain_bad], w[~chain_bad],
                                          err_msg=k)
            assert (np.abs(g - w) <= T).all(), k
            continue
        np.testing.assert_array_equal(g, w, err_msg=k)
    return n_bad


def test_fixture_is_current():
    want = dict(np.load(FIXTURE))
    got = make_fixture()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_plain_version_matches_fixture():
    from flipcomplexityempirical_tpu_torch import graphs, init_board, Spec
    from flipcomplexityempirical_tpu_torch.kernel import board as tb
    from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl

    g = graphs.grid_sec11()
    spec = Spec(contiguity="patch", record_interface=True)
    bg, st, params = init_board(g, graphs.sec11_plan(g, ALIGNMENT),
                                n_chains=CHAINS, seed=SEED, spec=spec,
                                base=BASE, pop_tol=POP_TOL, device="cpu")
    st, rows = cl.run_chunk(bg, spec, params, st, T)
    got = {f"row_{k}": rows[k].numpy() for k in ROW_KEYS}
    got.update({f"state_{k}": getattr(st, k).numpy() for k in STATE_KEYS})
    got["board_nodes"] = tb.node_view(bg, st.board)
    got["edge_cut_times"] = tb.edge_cut_times(g, st).astype(np.int16)
    compare(got, dict(np.load(FIXTURE)))


@pytest.mark.slow
def test_sec11_full_size_parity():
    """sec11 at full size against the JAX package's packed lowered body
    (the body its dispatch picks, bits=None), two composed chunks: the
    counterpart of the JAX package's slow test_bit_identity_sec11."""
    import flipcomplexityempirical_tpu as fce
    from flipcomplexityempirical_tpu.kernel import board as kb
    from flipcomplexityempirical_tpu_torch import graphs, init_board
    from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl
    from test_torch_lowered import assert_rows_close, assert_state_close

    from _torch_parity import spec_port

    spec = fce.Spec(contiguity="patch", record_interface=True)
    g, tg = fce.graphs.grid_sec11(), graphs.grid_sec11()
    bg, st, params = fce.sampling.init_board(
        g, fce.graphs.sec11_plan(g, 0), n_chains=CHAINS, seed=7, spec=spec,
        base=BASE, pop_tol=POP_TOL)
    tbg, tst, tpar = init_board(tg, graphs.sec11_plan(tg, 0),
                                n_chains=CHAINS, seed=7,
                                spec=spec_port(spec), base=BASE,
                                pop_tol=POP_TOL, device="cpu")
    n_bad = np.zeros(CHAINS, np.int64)
    for _ in range(2):
        st, outs = kb.run_board_chunk(bg, spec, params, st, 40)
        tst, rows = cl.run_chunk(tbg, spec_port(spec), tpar, tst, 40)
        n_bad += assert_rows_close({k: v.numpy() for k, v in rows.items()},
                                   {k: np.asarray(v) for k, v in
                                    outs.items()})
        assert_state_close(tst, st, n_bad)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **make_fixture())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
