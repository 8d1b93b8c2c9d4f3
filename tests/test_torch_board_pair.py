"""The rook board's k-district pair walk in the port (``kernel/board.py``'s
pair body, ``kernel/cuda_board_pair.py``'s plain chunk) against the JAX
package's ``run_board`` on its pair bodies.

Both packages start from their own ``init_board`` with the same seed and
draw the same threefry stream, so they agree step for step: every history
key, every state field, ``waits_total`` and the per-edge cut_times. The
JAX side runs its int8 pair body (``bits=False``, which
``tests/test_bitboard.py`` holds bit-identical to the packed
``_scan_bits_pair``); 6 x 7 is a width the JAX package never packs.

Tolerance: board, dist_pop, cut_count, cut_times, part_sum, num_flips,
the keys and every history row but the waits bit-equal; waits by
``_parity``'s rule, its ``scaled`` rule at k >= 4 (a wait there is ~n**k /
b, and a one-ulp difference of torch's and XLA's ``log`` crosses an
integer on many draws; each differing wait off by exactly 1.0).
"""

import numpy as np
import pytest
import torch

import flipcomplexityempirical_tpu as fce
from flipcomplexityempirical_tpu.kernel import board as kb
from flipcomplexityempirical_tpu_torch import convert
from flipcomplexityempirical_tpu_torch import graphs as tgraphs
from flipcomplexityempirical_tpu_torch import init_board, run_board
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel import cuda_board_pair as cbp
from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl
from flipcomplexityempirical_tpu_torch.kernel.step import Spec
from flipcomplexityempirical_tpu_torch.stats import accumulators as sacc

from _torch_parity import (assert_wait_sums_close, assert_waits_close,
                           jax_host, spec_port)
from conftest import assert_grid_districts_connected
from test_board_pair import _brute_pair_set

CHAINS, T = 4, 20
N_STEPS = 2 * T + 1          # two chunks of T transitions, then the final


def _init(h, w, k, spec, seed=3, base=1.3, pop_tol=0.3, chains=CHAINS):
    """Each package's own init_board on the h x w grid's k stripes."""
    g = fce.graphs.square_grid(h, w)
    tg = tgraphs.square_grid(h, w)
    want = fce.sampling.init_board(g, fce.graphs.stripes_plan(g, k),
                                   n_chains=chains, seed=seed, spec=spec,
                                   base=base, pop_tol=pop_tol)
    got = init_board(tg, tgraphs.stripes_plan(tg, k), n_chains=chains,
                     seed=seed, spec=spec_port(spec), base=base,
                     pop_tol=pop_tol, device="cpu")
    return g, tg, want, got


def _spec(k, **kw):
    return fce.Spec(n_districts=k, proposal="pair", **kw)


def assert_state_close(got, want, n_bad, scaled):
    """Every field of the port's state against the JAX state; ``n_bad``
    (C,) counts the waits that differed so far, per chain."""
    for f in got.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if a is None:
            assert b is None, f
            continue
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, f
        if f == "cur_wait":
            assert_waits_close(a, b, f, scaled=scaled)
        elif f == "waits_sum":
            assert_wait_sums_close(a, b, n_bad, f)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


@pytest.mark.parametrize("h,w,k,spec_kw,init_kw", [
    (8, 8, 4, dict(contiguity="patch"), {}),
    (6, 7, 3, dict(contiguity="patch"), dict(base=0.7, seed=11)),
    (8, 16, 8, dict(contiguity="patch"), dict(pop_tol=0.5)),
    (8, 8, 4, dict(contiguity="none", accept="always"), {}),
    (8, 8, 4, dict(contiguity="patch"), dict(pop_tol=0.0)),
], ids=["8x8-k4", "6x7-k3", "8x16-k8", "8x8-k4-none-always",
        "8x8-k4-empty-valid-set"])
def test_run_board_matches_jax_pair_body(h, w, k, spec_kw, init_kw):
    spec = _spec(k, **spec_kw)
    g, tg, (bg, st, params), (tbg, tst, tpar) = _init(h, w, k, spec,
                                                      **init_kw)
    assert tb.supports(tg, spec_port(spec)) and kb.supports(g, spec)
    assert cbp.body_for(tbg, spec_port(spec)) == "board"
    assert tb.body_for(tbg, spec_port(spec)) == kb.body_for(bg, spec)
    want = fce.sampling.run_board(bg, spec, params, st, n_steps=N_STEPS,
                                  chunk=T, bits=False)
    got = run_board(tbg, spec_port(spec), tpar, tst, n_steps=N_STEPS,
                    chunk=T, device="cpu")
    assert got.n_yields == want.n_yields == N_STEPS
    assert sorted(got.history) == sorted(want.history)
    bad = assert_waits_close(got.history["wait"], want.history["wait"],
                             scaled=k >= 4)
    n_bad = bad.sum(axis=1)
    for key, v in want.history.items():
        if key != "wait":
            np.testing.assert_array_equal(got.history[key], np.asarray(v),
                                          err_msg=key)
    assert_state_close(got.state, want.state, n_bad, scaled=k >= 4)
    assert_wait_sums_close(got.waits_total, want.waits_total, n_bad,
                           "waits_total")
    np.testing.assert_array_equal(kb.edge_cut_times(g, want.state),
                                  tb.edge_cut_times(tg, got.state))
    acc = got.state.accept_count
    if init_kw.get("pop_tol") == 0.0:      # the balanced start: no valid move
        assert int(acc.sum()) == 0
        assert bool((got.state.exhausted_count == N_STEPS - 1).all())
    else:
        assert int(acc.sum()) > 0
    if spec.contiguity == "patch":
        assert_grid_districts_connected(
            got.state.board.numpy().reshape(-1, h, w), k)


def test_move_set_matches_brute_force():
    """The port's valid (node, district) pairs against a brute-force
    enumeration (``test_board_pair.py``'s), after 120 steps away from the
    stripes; one slot a distinct target; b_count the distinct pairs
    before the gates."""
    k, h, w, c = 4, 6, 7, 6
    spec = Spec(n_districts=k, proposal="pair", contiguity="patch")
    tg = tgraphs.square_grid(h, w)
    bg, st, params = init_board(tg, tgraphs.stripes_plan(tg, k),
                                n_chains=c, seed=9, spec=spec, base=1.0,
                                pop_tol=0.6, device="cpu")
    st = run_board(bg, spec, params, st, n_steps=120, record_history=False,
                   device="cpu").state
    planes = tb.planes_pair(bg, spec, params.pop_lo, params.pop_hi,
                            st.board, st.dist_pop)
    valid = planes["valid"].reshape(c, h * w, 4).numpy()
    lo, hi = float(params.pop_lo[0]), float(params.pop_hi[0])
    offs = tb.pair_offsets(w)
    for ci in range(c):
        flat = st.board[ci].numpy().astype(np.int64)
        b2 = flat.reshape(h, w)
        want = _brute_pair_set(b2, st.dist_pop[ci].numpy(), lo, hi)
        got = {(v, int(flat[v + offs[j]])) for v in range(h * w)
               for j in range(4) if valid[ci, v, j]}
        assert got == want, ci
        for v in range(h * w):
            ds = [int(flat[v + offs[j]]) for j in range(4) if valid[ci, v, j]]
            assert len(ds) == len(set(ds)), (ci, v)
        raw = {(x * w + y, int(b2[x + dx, y + dy]))
               for x in range(h) for y in range(w)
               for dx, dy in ((0, 1), (1, 0), (0, -1), (-1, 0))
               if 0 <= x + dx < h and 0 <= y + dy < w
               and b2[x + dx, y + dy] != b2[x, y]}
        assert int(planes["b_count"][ci]) == len(raw), ci


def _random_boards(h, w, k, c, seed):
    """Boards of k districts in random rectangles, so that pairs repeat
    districts, with their populations."""
    r = np.random.default_rng(seed)
    b = r.integers(0, k, size=(c, h, w))
    b = np.repeat(np.repeat(b[:, ::2, ::2], 2, axis=1), 2, axis=2)[:, :h, :w]
    board = torch.as_tensor(b.reshape(c, -1), dtype=torch.int8)
    dist_pop = torch.stack([(board == d).sum(dim=1) for d in range(k)],
                           dim=1).to(torch.int32)
    return board, dist_pop


def _planes_bits_pair(bg, spec, pop_lo, pop_hi, board, dist_pop):
    """The bitboard form of ``planes_pair`` (the JAX package's
    ``bitboard.planes_bits_pair``) on unpacked planes: the district ids as
    ``max(1, (k - 1).bit_length())`` bit-slices (``bits_per_district``),
    "differs" as an OR of sliced XORs against the shifted slices, the
    dedup by sliced equality with an earlier direction's neighbour, one
    pass over the k districts for the per-cell gates. Returns ``valid4``,
    ``b_count``, ``cut_e`` and ``cut_s``."""
    k = spec.n_districts
    w = bg.w
    nb = max(1, (k - 1).bit_length())
    sl = [((board.to(torch.int64) >> b) & 1) == 1 for b in range(nb)]

    def shift(x, o):                       # cells off the range read 0
        return tb._shifted(x.to(torch.int8), w, o).clamp_min(0) == 1

    masks = tb._rook_masks(bg, board.device)
    sh = [[shift(p, o) for p in sl] for o in tb.pair_offsets(w)]
    diff = []
    for j in range(tb.PAIR_DIRS):
        x = sl[0] ^ sh[j][0]
        for b in range(1, nb):
            x = x | (sl[b] ^ sh[j][b])
        diff.append(x & masks[j][None])
    if spec.contiguity == "patch":
        contig = tb.ring_contig_ok(tb.same_planes(bg, board))
    else:
        contig = torch.ones_like(diff[0])
    from_bits, to_bits = tb.pop_gate_bits(bg, k, pop_lo, pop_hi, dist_pop)
    ok_from = torch.zeros_like(diff[0])
    to_plane = torch.zeros_like(diff[0])
    for d in range(k):
        eq = sl[0] if d & 1 else ~sl[0]
        for b in range(1, nb):
            eq = eq & (sl[b] if (d >> b) & 1 else ~sl[b])
        ok_from = ok_from | (eq & (((from_bits >> d) & 1) == 1)[:, None])
        to_plane = to_plane | (eq & (((to_bits >> d) & 1) == 1)[:, None])
    pairs = []
    b_count = torch.zeros(board.shape[0], dtype=torch.int32,
                          device=board.device)
    for j, o in enumerate(tb.pair_offsets(w)):
        pj = diff[j]
        for jp in range(j):
            eq = sh[j][0] ^ sh[jp][0]
            for b in range(1, nb):
                eq = eq | (sh[j][b] ^ sh[jp][b])
            pj = pj & ~(masks[jp][None] & ~eq)
        b_count = b_count + pj.sum(dim=1).to(torch.int32)
        pairs.append(pj & contig & ok_from & shift(to_plane, o))
    return dict(valid4=pairs, b_count=b_count, cut_e=diff[0], cut_s=diff[1])


@pytest.mark.parametrize("k,contiguity,tol", [
    (3, "patch", 0.3), (5, "none", 2.0), (8, "patch", 0.6)])
def test_bitboard_forms_equal_the_int8_body(k, contiguity, tol):
    """The bitboard planes (``_planes_bits_pair``, the JAX package's packed
    form that fixes the trajectory) and ``select_flat_pair`` against
    ``planes_pair`` and the flat m-th-valid selection, on random boards
    and uniforms."""
    h, w, c = 7, 9, 16
    tg = tgraphs.square_grid(h, w)
    bg = tb.make_board_graph(tg, device="cpu")
    spec = Spec(n_districts=k, proposal="pair", contiguity=contiguity)
    board, dist_pop = _random_boards(h, w, k, c, 5 + k)
    ideal = h * w / k
    lo = torch.full((c,), (1 - tol) * ideal)
    hi = torch.full((c,), (1 + tol) * ideal)
    want = tb.planes_pair(bg, spec, lo, hi, board, dist_pop)
    got = _planes_bits_pair(bg, spec, lo, hi, board, dist_pop)
    for key in ("valid4", "b_count", "cut_e", "cut_s"):
        a, b = got[key], want[key]
        for x, y in (zip(a, b) if key == "valid4" else ((a, b),)):
            assert torch.equal(x, y), key
    u = torch.rand(c, generator=torch.Generator().manual_seed(k))
    flat4, any_valid = tb.select_flat_pair(bg, want["valid4"], u)
    valid = want["valid"]
    total = valid.sum(dim=1)
    m = torch.minimum((u * total.to(torch.float32)).to(torch.int64),
                      torch.clamp_min(total - 1, 0))
    for ci in range(c):
        idx = torch.nonzero(valid[ci])[:, 0]
        assert bool(any_valid[ci]) == (idx.numel() > 0)
        assert int(flat4[ci]) == (int(idx[m[ci]]) if idx.numel() else 0)
    assert any_valid.any()
    assert torch.equal(tb.value_at(board, flat4 // 4),
                       board.gather(1, flat4[:, None] // 4)[:, 0].to(
                           torch.int32))


def test_chunk_reference_composes_step_by_step():
    """``board_pair_chunk_reference`` over T steps equals T one-step
    calls chained through ``run_chunk`` (the plain body step by step),
    every state field and row; and its SE / SW-free state keeps the rook
    layout."""
    k, h, w = 5, 6, 9
    spec = Spec(n_districts=k, proposal="pair", contiguity="patch")
    tg = tgraphs.square_grid(h, w)
    bg, st, params = init_board(tg, tgraphs.stripes_plan(tg, k),
                                n_chains=3, seed=4, spec=spec, base=0.8,
                                pop_tol=0.5, device="cpu")
    static = cbp.make_static_inputs(bg, spec, params)
    whole, rows = cbp.run_chunk(bg, spec, params, st, 12, static)
    one = st
    parts = []
    for _ in range(12):
        one, r = cbp.run_chunk(bg, spec, params, one, 1, static)
        parts.append(r)
    for key in rows:
        assert torch.equal(rows[key], torch.cat([p[key] for p in parts])), key
    for f in ("board", "dist_pop", "cut_count", "cur_wait", "cur_flip",
              "cur_sign", "t_yield", "move_clock", "part_sum",
              "last_flipped", "num_flips", "cut_times_e", "cut_times_s",
              "accept_count", "tries_sum", "exhausted_count", "key"):
        assert torch.equal(getattr(whole, f), getattr(one, f)), f
    assert whole.cut_times_se is None and whole.cut_times_sw is None
    assert int(whole.accept_count.sum()) > 0
    assert torch.equal(whole.cut_count, tb.recount_cuts(bg, whole.board))


def test_convert_carries_k_district_state():
    """``convert`` carries the JAX package's k = 4 BoardState and
    StepParams (k labels) into the port's, equal to the port's own
    init."""
    k = 4
    spec = _spec(k, contiguity="patch")
    g, tg, (bg, st, params), (tbg, tst, tpar) = _init(8, 8, k, spec)
    cst = convert.board_state(jax_host(st), device="cpu")
    cpar = convert.step_params(jax_host(params), device="cpu")
    cbg = convert.board_graph(jax_host(bg), device="cpu")
    assert cst.dist_pop.shape == (CHAINS, k)
    assert torch.equal(cpar.label_values, torch.arange(k, dtype=torch.int32))
    for f in ("board", "dist_pop", "cut_count", "key", "part_sum"):
        assert torch.equal(getattr(cst, f), getattr(tst, f)), f
    assert cbp.supports(cbg, spec_port(spec))
    assert cbg.n == tbg.n and cbg.uniform_pop == tbg.uniform_pop


def test_summary_mode_folds_the_rows():
    """Summary mode on the pair path: the chunks' rows folded by the
    standalone fold equal the fold of the history run's rows."""
    k = 4
    spec = Spec(n_districts=k, proposal="pair", contiguity="patch")
    tg = tgraphs.square_grid(8, 8)
    bg, st, params = init_board(tg, tgraphs.stripes_plan(tg, k),
                                n_chains=3, seed=1, spec=spec, base=1.2,
                                pop_tol=0.4, device="cpu")
    hist = run_board(bg, spec, params, st, n_steps=31, chunk=10,
                     device="cpu")
    da = sacc.DeviceAnalytics(3, observable="cut_count", device="cpu")
    summ = run_board(bg, spec, params, st, n_steps=31, chunk=10,
                     record_history=False, analytics=da, device="cpu")
    assert summ.history == {}
    want = sacc.fold_block(
        sacc.init_summary(3, device="cpu"),
        {k2: torch.as_tensor(v).T.contiguous()
         for k2, v in hist.history.items()})
    for f in ("mean", "m2", "waits", "accepts"):
        assert torch.equal(getattr(da.acc, f), getattr(want, f)), f


def test_refusals_name_their_item():
    tg = tgraphs.square_grid(8, 8)
    bg = tb.make_board_graph(tg, device="cpu")
    for spec, item in (
            (Spec(n_districts=4, proposal="pair", anneal="linear"), "B4"),
            (Spec(n_districts=2, proposal="bi"), "proposal 'pair'")):
        with pytest.raises(ValueError, match=item):
            cbp.check(bg, spec, None)
    big = tb.make_board_graph(tgraphs.square_grid(65, 65), device="cpu")
    with pytest.raises(ValueError, match="B2"):
        cbp.check(big, Spec(n_districts=4, proposal="pair"), None)
    assert cl.body_for(bg, Spec()) == "board"
