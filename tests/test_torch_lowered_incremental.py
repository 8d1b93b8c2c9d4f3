"""The invariants the lowered-chunk kernel's resident planes rely on.

``csrc/lowered_chunk.cu`` keeps each chain's patch verdicts and boundary
bits in shared memory and brings them up to date only around a committed
flip, and recomputes the wall keys and the interface metrics only when a
flip touches a wall edge. These tests hold, on the CPU and on four graphs
(sec11, the Frankengraph, a surgical 5 x 7 grid and a 6 x 6 queen grid,
the last two with a frame wall so that they have an interface):

(a) the kernel's formulation of the patch check
    (``cuda_lowered.window_patch_ok``) equals the plain
    ``board.stencil_patch_ok`` on every real cell of seeded random boards;
(b) after one flip at f, ``stencil_patch_ok`` changes only inside f's
    5 x 5 flat window and ``planes_stencil``'s boundary only at f and its
    ring neighbours;
(c) along a plain chunk, slope and angle change only on steps whose
    committed flip touched a wall edge by the kernel's own test
    (``cuda_lowered.touches_wall``);
(d) the kernel's update rule keeps the verdict plane exact where it is
    read: after each flip at f, recomputing the verdicts of only those
    cells of f's window that are on the boundary leaves the plane equal to
    ``stencil_patch_ok`` on every boundary cell, along a run of flips.

Tolerance: exact (booleans and bit-equal floats, NaN equal to NaN).
"""

import numpy as np
import pytest
import torch

from flipcomplexityempirical_tpu_torch import Spec, graphs, init_board
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl

SURGERY = dict(remove_nodes=[(0, 0), (2, 3)],
               extra_edges=[((0, 1), (1, 0)), ((3, 4), (4, 5))])
C = 6


def _frame_wall(nx_, ny_):
    """Wall ids of the frame's edges, as grid_sec11 numbers them."""
    def wall(u, v):
        for wid, (axis, val) in enumerate(((0, 0), (1, 0), (0, nx_ - 1),
                                           (1, ny_ - 1))):
            if u[axis] == val and v[axis] == val:
                return wid
        return -1
    return wall


def _graph(name):
    if name == "sec11":
        g = graphs.grid_sec11()
        return g, graphs.sec11_plan(g, 0), 2.63815853
    if name == "frankengraph":
        g = graphs.frankengraph()
        return g, graphs.frank_plan(g, 0), 0.3
    if name == "surgical":
        g = graphs.square_grid(5, 7, wall=_frame_wall(5, 7), **SURGERY)
    else:
        g = graphs.square_grid(6, queen=True, wall=_frame_wall(6, 6))
    return g, graphs.stripes_plan(g, 2), 1.3


GRAPHS = ("sec11", "frankengraph", "surgical", "queen")


@pytest.fixture(scope="module")
def workloads():
    """name -> (bg, state, params, spec, static), built once a module."""
    out = {}
    spec = Spec(contiguity="patch", record_interface=True)
    for name in GRAPHS:
        g, plan, base = _graph(name)
        bg, st, params = init_board(g, plan, n_chains=C, seed=5, spec=spec,
                                    base=base, pop_tol=0.3, device="cpu")
        assert bg.iface_ok, name
        out[name] = (bg, st, params, spec,
                     cl.make_static_inputs(bg, spec, params))
    return out


def _random_boards(bg, seed, density):
    """(C, N) int8 boards, district 1 with probability ``density`` on the
    real cells, -1 on the holes."""
    rs = np.random.default_rng(seed)
    b = (rs.random((C, bg.n)) < density).astype(np.int8)
    b[:, ~bg.node_mask.numpy()] = -1
    return torch.as_tensor(b)


@pytest.mark.parametrize("name", GRAPHS)
def test_window_patch_check_equals_stencil_patch_ok(workloads, name):
    bg, st, _, _, static = workloads[name]
    real = bg.node_mask
    cells = torch.arange(bg.n)
    n_false = 0
    for board in (st.board, _random_boards(bg, 1, 0.5),
                  _random_boards(bg, 2, 0.25)):
        got = cl.window_patch_ok(static, board, cells)
        want = tb.stencil_patch_ok(bg, board)
        assert torch.equal(got[:, real], want[:, real])
        n_false += int((~want[:, real]).sum())
    assert n_false > 0  # both verdicts occur: the comparison is not vacuous


def _boundary(bg, spec, params, board, dist_pop):
    planes = tb.planes_stencil(bg, spec, params.pop_lo, params.pop_hi, board,
                               dist_pop)
    return (planes["diff_deg"] > 0) & bg.node_mask[None]


@pytest.mark.parametrize("name", GRAPHS)
def test_flip_changes_verdicts_and_boundary_only_nearby(workloads, name):
    bg, st, params, spec, _ = workloads[name]
    w, n = bg.w, bg.n
    rs = np.random.default_rng(3)
    real = np.flatnonzero(bg.node_mask.numpy())
    p = np.arange(25)
    window = (p // 5 - 2) * w + p % 5 - 2
    ring = np.array(tb.ring_offsets(w) + (0,))
    n_ok = n_bnd = 0
    for board in (st.board, _random_boards(bg, 4, 0.5),
                  _random_boards(bg, 6, 0.3)):
        f = rs.choice(real, C)
        flipped = board.clone()
        flipped[np.arange(C), f] = 1 - flipped[np.arange(C), f]
        ok_changed = (tb.stencil_patch_ok(bg, board)
                      != tb.stencil_patch_ok(bg, flipped)).numpy()
        bnd_changed = (_boundary(bg, spec, params, board, st.dist_pop)
                       != _boundary(bg, spec, params, flipped,
                                    st.dist_pop)).numpy()
        for c in range(C):
            near = np.zeros(n, bool)
            cand = f[c] + window
            near[cand[(cand >= 0) & (cand < n)]] = True
            assert not (ok_changed[c] & ~near).any()
            near[:] = False
            cand = f[c] + ring
            near[cand[(cand >= 0) & (cand < n)]] = True
            assert not (bnd_changed[c] & ~near).any()
        n_ok += int(ok_changed.sum())
        n_bnd += int(bnd_changed.sum())
    assert n_ok > 0 and n_bnd > 0


@pytest.mark.parametrize("name", GRAPHS)
def test_verdicts_rechecked_on_the_boundary_stay_exact(workloads, name):
    bg, st, params, spec, static = workloads[name]
    n = bg.n
    rs = np.random.default_rng(9)
    real = np.flatnonzero(bg.node_mask.numpy())
    p = np.arange(25)
    window = (p // 5 - 2) * bg.w + p % 5 - 2
    board = st.board.clone()
    ok = cl.window_patch_ok(static, board, torch.arange(n))   # the fill
    n_stale = 0
    for _ in range(24):
        f = rs.choice(real, C)
        board[np.arange(C), f] = 1 - board[np.arange(C), f]
        bnd = _boundary(bg, spec, params, board, st.dist_pop)
        for c in range(C):
            cells = f[c] + window
            cells = cells[(cells >= 0) & (cells < n)]
            cells = cells[bnd[c, cells].numpy()]
            if cells.size:
                ok[c, cells] = cl.window_patch_ok(static, board[c:c + 1],
                                                  cells)[0]
        want = tb.stencil_patch_ok(bg, board)
        assert torch.equal(ok & bnd, want & bnd)
        n_stale += int(((ok != want) & bg.node_mask).sum())
    assert n_stale > 0  # off-boundary bits did go stale, unread


def _same(x, y):
    return (x == y) | (torch.isnan(x) & torch.isnan(y))


@pytest.mark.parametrize("name", GRAPHS)
def test_interface_changes_only_on_wall_touching_flips(workloads, name):
    bg, st, params, spec, static = workloads[name]
    t_len = 120
    outs = cl.lowered_chunk_reference(bg, static, spec, t_len, st.board,
                                      *cl.pack_state(st, params))
    log_f, acc, slope, angle = outs[5], outs[10], outs[11], outs[12]
    n_touch = n_change = 0
    for t in range(t_len - 1):
        # step t's transition committed log_f[t + 1] iff accepts grew
        moved = acc[t + 1] != acc[t]
        touched = moved & cl.touches_wall(bg, static, log_f[t + 1].clamp(0))
        changed = ~(_same(slope[t + 1], slope[t])
                    & _same(angle[t + 1], angle[t]))
        assert not bool((changed & ~touched).any()), t
        n_touch += int(touched.sum())
        n_change += int(changed.sum())
    assert n_change > 0 and n_touch >= n_change
