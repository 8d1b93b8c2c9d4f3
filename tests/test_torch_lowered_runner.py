"""The lowered path end to end on a small Frankengraph with
``record_interface``: two composed chunks of the plain version against the
JAX package's chunk, then the port's ``run_board`` against the JAX
package's ``run_board`` (full and thinned history, final record,
``waits_total``, ``edge_cut_times``), and the chain invariants of the
port's run on its own. The JAX side runs its int8 lowered body
(``bits=False``, bit-identical to the packed body).

Tolerance as in ``test_torch_lowered.py``: integers bit-equal, waits as
``_torch_parity`` allows, slope and angle within 4 ulp with NaN where the
JAX value is NaN.
"""

import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import board as kb
from flipcomplexityempirical_tpu_torch import run_board, run_board_cuda
from flipcomplexityempirical_tpu_torch.kernel import board as tb

from _torch_parity import (assert_ulps_close, assert_wait_sums_close,
                           assert_waits_close, spec_port)
from test_torch_lowered import T, _init, assert_state_close, compare_chunks

SPEC = fce.Spec(contiguity="patch", record_interface=True)
N_STEPS = 2 * T + 1          # two chunks of T transitions, then the final


def test_plain_chunk_matches_jax_frankengraph():
    compare_chunks("frank", SPEC)


def districts_connected(graph, node_assignment) -> bool:
    """Each of the two districts is one connected set of the graph."""
    e = graph.edges
    for d in (0, 1):
        nodes = np.nonzero(node_assignment == d)[0]
        if nodes.size == 0:
            return False
        keep = (node_assignment[e[:, 0]] == d) & (node_assignment[e[:, 1]]
                                                  == d)
        adj = coo_matrix((np.ones(int(keep.sum())), (e[keep, 0], e[keep, 1])),
                         shape=(graph.n_nodes, graph.n_nodes))
        _, lab = connected_components(adj, directed=False)
        if np.unique(lab[nodes]).size != 1:
            return False
    return True


@pytest.mark.parametrize("record_every", [1, 3])
def test_run_board_matches_jax(record_every):
    g, tg, (bg, st, params), (tbg, tst, tpar) = _init("frank", SPEC)
    want = fce.sampling.run_board(bg, SPEC, params, st, n_steps=N_STEPS,
                                  chunk=T, bits=False,
                                  record_every=record_every)
    got = run_board(tbg, spec_port(SPEC), tpar, tst, n_steps=N_STEPS,
                    chunk=T, record_every=record_every, device="cpu")
    assert got.n_yields == want.n_yields == N_STEPS
    assert sorted(got.history) == sorted(want.history)
    bad = assert_waits_close(got.history["wait"], want.history["wait"])
    n_bad = bad.sum(axis=1)
    for k, v in want.history.items():
        assert got.history[k].shape == v.shape, k
        assert v.shape[1] == len(range(0, N_STEPS, record_every)), k
        if k in ("slope", "angle"):
            assert_ulps_close(got.history[k], v, name=k)
        elif k != "wait":
            np.testing.assert_array_equal(got.history[k], v, err_msg=k)
    assert_state_close(got.state, want.state, n_bad)
    if record_every == 1:
        assert_wait_sums_close(got.waits_total, want.waits_total, n_bad,
                               "waits_total")
    np.testing.assert_array_equal(kb.edge_cut_times(g, want.state),
                                  tb.edge_cut_times(tg, got.state))


def test_run_board_invariants():
    """The port's run on its own: both districts connected, dist_pop and
    cut_count against recounts, cut_times against the cut history, holes
    untouched, the node view of the board."""
    _, tg, _, (tbg, tst, tpar) = _init("frank", SPEC)
    res = run_board(tbg, spec_port(SPEC), tpar, tst, n_steps=N_STEPS,
                    chunk=T, device="cpu")
    s = res.state
    nodes = tb.node_view(tbg, s.board)
    for c in range(nodes.shape[0]):
        assert districts_connected(tg, nodes[c]), c
    np.testing.assert_array_equal(s.dist_pop[:, 0].numpy(),
                                  (nodes == 0).sum(axis=1))
    np.testing.assert_array_equal(s.cut_count,
                                  tb.recount_cuts(tbg, s.board))
    np.testing.assert_array_equal(
        tb.edge_cut_times(tg, s).sum(axis=1),
        res.history["cut_count"].sum(axis=1))
    assert bool((s.board[:, ~tbg.node_mask] == -1).all())
    assert (s.t_yield == N_STEPS).all()
    np.testing.assert_allclose(
        res.waits_total, res.history["wait"].sum(axis=1, dtype=float),
        rtol=1e-6)


def test_run_board_refuses_the_rook_body_and_the_rook_runner_the_lowered():
    """run_board takes a plain rook grid on its stencil but refuses the
    JAX package's int8 rook body (``bits=False``, ROADMAP B7) and a grid
    too small to lower, which runs on run_board_cuda; a lowered workload
    is refused by run_board_cuda."""
    from flipcomplexityempirical_tpu_torch import graphs, init_board, Spec
    g = graphs.square_grid(6, 8)
    bg, st, params = init_board(g, graphs.stripes_plan(g, 2), n_chains=2,
                                seed=0, spec=Spec(), base=2.0, pop_tol=0.2,
                                device="cpu")
    with pytest.raises(ValueError, match="B7"):
        run_board(bg, Spec(), params, st, n_steps=5, bits=False,
                  device="cpu")
    g = graphs.square_grid(2, 8)
    bg, st, params = init_board(g, graphs.stripes_plan(g, 2), n_chains=2,
                                seed=0, spec=Spec(), base=2.0, pop_tol=0.2,
                                device="cpu")
    with pytest.raises(ValueError, match="run_board_cuda"):
        run_board(bg, Spec(), params, st, n_steps=5, device="cpu")
    _, _, _, (tbg, tst, tpar) = _init("frank", SPEC)
    with pytest.raises(ValueError):
        run_board_cuda(tbg, spec_port(SPEC), tpar, tst, n_steps=5,
                       device="cpu")
    assert torch.equal(tst.t_yield, torch.zeros_like(tst.t_yield))
