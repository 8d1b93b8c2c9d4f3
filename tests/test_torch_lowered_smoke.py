"""The candidate-cell replay behind ``chip_smoke.py``'s lowered-chunk
bound.

The bound prices the patch check of every candidate cell (boundary and
population gate), counted by replaying a chunk's flip log
(``chip_smoke.lowered_candidates``). Here the replay runs on the CPU over
the plain version's outputs on a small Frankengraph, passes its own checks
(the kernel's boundary counts, the final board), and must give exactly the
candidate count of the plain version's planes summed over the chunk's
states, which one-step chunks yield one at a time. Integer counts: exact.
"""

import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from flipcomplexityempirical_tpu_torch import Spec, graphs, init_board
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl

ROOT = pathlib.Path(__file__).resolve().parent.parent
C, T = 4, 24


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("tol", [0.3, 0.05, 0.0])
def test_candidate_replay(tol):
    g = graphs.frankengraph(6)
    spec = Spec(contiguity="patch", record_interface=True)
    bg, st, params = init_board(g, graphs.frank_plan(g, 0, m=6), n_chains=C,
                                seed=4, spec=spec, base=0.8, pop_tol=tol,
                                device="cpu")
    static = cl.make_static_inputs(bg, spec, params)
    key, dp, scal, ints = cl.pack_state(st, params)
    outs = cl.lowered_chunk_reference(bg, static, spec, T, st.board, key,
                                      dp, scal, ints)
    start = st.board.clone()
    got = _chip_smoke().lowered_candidates(tb, bg, spec, st.board, dp, scal,
                                           outs, static.unit_pop)
    assert torch.equal(st.board, start)  # the replay works on a copy

    want = 0
    gate_only = dataclasses.replace(spec, contiguity="none")
    board, key, dp_t, ints_t, scal_t = st.board, key, dp, ints, scal
    for _ in range(T):
        planes = tb.planes_stencil(bg, gate_only, params.pop_lo,
                                   params.pop_hi, board, dp_t.T)
        want += int(planes["valid"].sum())
        one = cl.lowered_chunk_reference(bg, static, spec, 1, board, key,
                                         dp_t, scal_t, ints_t)
        board, key, dp_t, ints_t = one[0], one[1], one[2], one[4]
        scal_t = scal_t.clone()
        scal_t[4], scal_t[5] = one[3][0], one[3][1]
    assert torch.equal(board, outs[0])  # one step at a time == the chunk
    assert got == want
    # the gate binds at a tight tolerance: fewer candidates than boundary
    # cells (the small Frankengraph's plan is not balanced, so pop_tol 0
    # still leaves moves toward balance)
    assert 0 < got <= int(outs[8].long().sum())
