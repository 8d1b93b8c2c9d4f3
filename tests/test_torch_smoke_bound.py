"""The valid-cell replay behind ``chip_smoke.py``'s board-chunk bound.

The bound prices a Philox draw per valid cell, counted by replaying a
chunk's flip log (``chip_smoke.valid_cells``). Here the replay runs on
the CPU over the plain version's outputs at a small shape, passes its own
checks (the kernel's boundary counts, the final board), and must give
exactly the count of the JAX package's validity plane
(``board._planes``) summed over the same chunk's states, which the plain
version yields one step at a time. Integer counts: exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import board as jboard
from flipcomplexityempirical_tpu_torch import convert
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel import cuda_board as cb

from _torch_parity import jax_host, spec_port, uint32_bits

ROOT = pathlib.Path(__file__).resolve().parent.parent
H, W, C, T = 8, 16, 6, 30


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (contiguity, pop_tol): every boundary cell valid; none (pop_tol 0 on the
# balanced start); patch contiguity; patch under a binding population gate
@pytest.mark.parametrize("contiguity,tol", [
    ("none", 1.0), ("none", 0.0), ("patch", 0.3), ("patch", 0.02)])
def test_valid_cell_replay(contiguity, tol):
    g = fce.graphs.square_grid(H, W)
    jspec = fce.Spec(contiguity=contiguity)
    jbg, jst, jpar = fce.sampling.init_board(
        g, fce.graphs.stripes_plan(g, 2), n_chains=C, seed=0, spec=jspec,
        base=1.4, pop_tol=tol)
    spec = spec_port(jspec)
    bg = convert.board_graph(jax_host(jbg), device="cpu")
    st = convert.board_state(jax_host(jst), device="cpu")
    pop, deg = cb.make_static_inputs(bg)
    dp, scal, ints = cb.pack_state(st, convert.step_params(jax_host(jpar),
                                                           device="cpu"))
    rng = np.random.default_rng(3)
    bits = [cb.bits_tensor(uint32_bits(rng, *shape), "cpu")
            for shape in ((T, C, H * W), (T, 2, C))]
    outs = cb.board_chunk_reference(spec, H, W, T, 0, 0, st.board, pop, deg,
                                    dp, scal, ints, *bits)
    start = st.board.clone()
    got = _chip_smoke().valid_cells(tb, bg, spec, st.board, pop, dp, scal,
                                    outs)
    assert torch.equal(st.board, start)  # the replay works on a copy

    want = 0
    board, d, s, k = st.board, dp, scal.clone(), ints
    for t in range(T):
        state = jst.replace(board=jnp.asarray(board.numpy()),
                            dist_pop=jnp.asarray(d.T.numpy()))
        want += int(jboard._planes(jbg, jspec, jpar, state)["valid"].sum())
        one = cb.board_chunk_reference(spec, H, W, 1, 0, 0, board, pop, deg,
                                       d, s, k, bits[0][t:t + 1],
                                       bits[1][t:t + 1])
        board, d, k = one[0], one[1], one[3]
        s = s.clone()
        s[4] = one[2][0]
    assert torch.equal(board, outs[0])  # one step at a time == the chunk
    assert got == want
    sum_hb = int(outs[7].long().sum())
    if (contiguity, tol) == ("none", 1.0):
        assert got == sum_hb
    elif tol == 0.0:
        assert got == 0 < sum_hb
    else:
        assert 0 < got < sum_hb
