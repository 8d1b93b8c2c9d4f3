"""The slot counts, the selection and the flip-log runs of
``csrc/board_pair_chunk.cu``, on the CPU.

The kernel does not rescan the board's pair slots at each step. It keeps,
per chain, the board, the valid slots of each word of 8 cells (a 32-bit
mask, slot (v, j) at bit 4 (v mod 8) + j), the count of valid slots of
each lane's run of ``wpl`` words (a power of two), the distinct-pair
count b, and the population masks the valid slots were made under; an
accepted move changes the words and counts of its 3 x 3 block only (each
cell's bits before and after, under those masks), a move that changes a
mask recounts every cell, and the m-th valid slot is found in three warp
rounds: the owner lane, the word, then ``nth_bit`` in the word's mask.
Under ``parity_metrics`` it closes each flip-log run (cur_flip and
cur_sign constant between two accepted moves) in place of the replay.
``BoardPairCounts`` and ``Runs`` below are numpy models of exactly that
arithmetic. The test drives them along the accepted moves of the plain
version (``cuda_board_pair.board_pair_chunk_reference``) step by
step and holds them, at every step, to a full recount of the plain
version's valid slots (``kernel/board.py::planes_pair``) and to
first-index selection for every m < total; the runs' part_sum /
last_flipped / num_flips to the JAX package's ``apply_flip_log`` on the
same flip log, and to the plain version's own chunk. The kernel itself is
held to the plain version on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flipcomplexityempirical_tpu.kernel import board as jboard
from flipcomplexityempirical_tpu_torch import Spec, graphs, init_board
from flipcomplexityempirical_tpu_torch.kernel import board as tb
from flipcomplexityempirical_tpu_torch.kernel import cuda_board_pair as cbp

F32 = np.float32
POPC = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def popc32(x):
    """Set bits of each 32-bit value."""
    x = np.asarray(x, dtype=np.int64)
    return sum(POPC[(x >> s) & 0xFF] for s in (0, 8, 16, 24))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nth_bit(x: int, r: int) -> int:
    """Position of the r-th (from 0) set bit of x (chain_common.cuh's
    halvings)."""
    pos = 0
    for s in (16, 8, 4, 2, 1):
        low = bin(x & ((1 << s) - 1)).count("1")
        if r >= low:
            r, x, pos = r - low, x >> s, pos + s
    return pos


class BoardPairCounts:
    """One chain's board, word masks, lane counts, b and masks, as the
    kernel keeps them."""

    def __init__(self, h, w, k, patch, board, dp, unit, lo, hi):
        self.h, self.w, self.n, self.k, self.patch = h, w, h * w, k, patch
        per = (((self.n + 7) // 8) + 31) // 32
        self.wpl = 1 << (per - 1).bit_length()
        self.board = np.asarray(board, np.int64).copy()
        self.dp = np.asarray(dp, np.int64).copy()
        self.unit, self.lo, self.hi = F32(unit), F32(lo), F32(hi)
        self.fm, self.tm = self.masks()
        self.recounts = 0
        self.b = self.recount()

    def masks(self):
        dpf = self.dp.astype(F32)
        fm = sum(int(x) << d
                 for d, x in enumerate(dpf - self.unit >= self.lo))
        tm = sum(int(x) << d
                 for d, x in enumerate(dpf + self.unit <= self.hi))
        return fm, tm

    def cell_bits(self, v: int) -> int:
        """Bits 0..3 the pair slots E, S, W, N of cell v, bits 4..7 the
        valid ones under the contiguity and the masks (cell_bits)."""
        h, w, B = self.h, self.w, self.board
        r, c = divmod(v, w)
        a = int(B[v])

        def at(dr, dc):
            rr, cc = r + dr, c + dc
            return int(B[rr * w + cc]) if 0 <= rr < h and 0 <= cc < w else -1
        nE, nS, nW, nN = at(0, 1), at(1, 0), at(0, -1), at(-1, 0)
        pE = nE >= 0 and nE != a
        pS = nS >= 0 and nS != a and nS != nE
        pW = nW >= 0 and nW != a and nW not in (nE, nS)
        pN = nN >= 0 and nN != a and nN not in (nE, nS, nW)
        contig = True
        if self.patch:
            sE, sS, sW, sN = (x == a for x in (nE, nS, nW, nN))
            sSE, sSW = at(1, 1) == a, at(1, -1) == a
            sNW, sNE = at(-1, -1) == a, at(-1, 1) == a
            seeds = sE + sS + sW + sN
            runs = ((sE and not (sNE and sN)) + (sS and not (sSE and sE))
                    + (sW and not (sSW and sS)) + (sN and not (sNW and sW)))
            contig = seeds <= 1 or runs <= 1
        pairs = int(pE) | int(pS) << 1 | int(pW) << 2 | int(pN) << 3
        to = sum(((self.tm >> (x & 31)) & 1) << j
                 for j, x in enumerate((nE, nS, nW, nN)))
        ok = to if contig and (self.fm >> a) & 1 else 0
        return pairs | (pairs & ok) << 4

    def recount(self) -> int:
        """Every cell's bits: the word masks (those past the board's zero)
        and the lane counts; returns b."""
        bits = np.array([self.cell_bits(v) for v in range(self.n)])
        nib = np.zeros(8 * 32 * self.wpl, dtype=np.int64)
        nib[:self.n] = bits >> 4
        self.vm = (nib.reshape(-1, 8) << (4 * np.arange(8))).sum(axis=1)
        self.lc = popc32(self.vm).reshape(32, self.wpl).sum(axis=1)
        return int(POPC[bits & 0xF].sum())

    def commit(self, flat: int, d_to: int) -> None:
        """The accepted move of ``flat`` to ``d_to``: lanes 0..8 for its
        3 x 3 block, old and new bits under the counts' masks; a mask
        change recounts."""
        h, w = self.h, self.w
        fr, fc = divmod(flat, w)
        block = [(fr + i // 3 - 1) * w + fc + i % 3 - 1 for i in range(9)
                 if 0 <= fr + i // 3 - 1 < h and 0 <= fc + i % 3 - 1 < w]
        old = [self.cell_bits(u) for u in block]
        d_from = int(self.board[flat])
        self.board[flat] = d_to
        new = [self.cell_bits(u) for u in block]
        self.b += int(sum(POPC[x & 0xF] - POPC[y & 0xF]
                          for x, y in zip(new, old)))
        self.dp[d_to] += int(self.unit)
        self.dp[d_from] -= int(self.unit)
        masks = self.masks()
        if masks != (self.fm, self.tm):
            self.fm, self.tm = masks
            self.recount()
            self.recounts += 1
            return
        for u, x, y in zip(block, new, old):
            vdiff = (x ^ y) >> 4
            if vdiff:
                self.vm[u >> 3] ^= vdiff << (4 * (u & 7))
                self.lc[(u >> 3) // self.wpl] += int(POPC[x >> 4]
                                                     - POPC[y >> 4])

    def total(self) -> int:
        return int(self.lc.sum())

    def select(self, m: int) -> int:
        """The slot flat4 = 4 v + j of the m-th valid slot, in the kernel's
        three rounds."""
        incl = np.cumsum(self.lc)
        owner = int(np.argmax(incl > m))
        r = m - int(incl[owner] - self.lc[owner])
        vm = np.zeros(32, dtype=np.int64)   # lane i: the owner's word i
        vm[:self.wpl] = self.vm[owner * self.wpl:(owner + 1) * self.wpl]
        wcnt = popc32(vm)
        below = np.zeros(32, dtype=np.int64)
        for bit in range(6):   # one ballot a bit of the counts
            ballot = (wcnt >> bit) & 1
            below += (np.cumsum(ballot) - ballot) << bit
        ws = int(np.argmax(below + wcnt > r))
        r -= int(below[ws])
        return 32 * (owner * self.wpl + ws) + nth_bit(int(vm[ws]), r)


class Runs:
    """Lane 0's flip-log runs of one chain (parity_metrics): part_sum,
    last_flipped and num_flips as the kernel writes them."""

    def __init__(self, ps, lf, nf, t_yield, cur_flip, cur_sign):
        self.ps = np.asarray(ps, np.int64).copy()
        self.lf = np.asarray(lf, np.int64).copy()
        self.nf = np.asarray(nf, np.int64).copy()
        self.t_yield, self.x, self.s = t_yield, cur_flip, cur_sign
        self.t0 = 0
        self.run_lf = int(self.lf[cur_flip]) if cur_flip >= 0 else 0

    def close(self, t_end: int) -> None:
        e = self.t_yield + t_end - 1
        self.ps[self.x] += -self.s * (e - self.run_lf)
        self.nf[self.x] += t_end - self.t0
        self.lf[self.x] = e

    def accept(self, t: int, flat: int, sign: int) -> None:
        if self.x >= 0:
            self.close(t + 1)
        self.run_lf, self.t0 = int(self.lf[flat]), t + 1
        self.x, self.s = flat, sign

    def end(self, t_len: int):
        if self.x >= 0 and self.t0 < t_len:
            self.close(t_len)
        # the kernel's int32 arithmetic wraps as the replay's cast does
        return tuple(x.astype(np.int32) for x in (self.ps, self.lf, self.nf))


def drive(h, w, k, tol, base, spec_kw, chains, warm, steps, seed):
    """The models along ``steps`` one-step calls of the plain version from
    a state ``warm`` steps into a run; returns (models, moves)."""
    g = graphs.square_grid(h, w)
    spec = Spec(n_districts=k, proposal="pair", **spec_kw)
    bg, st, params = init_board(g, graphs.stripes_plan(g, k),
                                n_chains=chains, seed=seed, spec=spec,
                                base=base, pop_tol=tol, device="cpu")
    static = cbp.make_static_inputs(bg, spec, params)
    if warm:
        st, _ = cbp.run_chunk(bg, spec, params, st, warm, static)
    key, dp, scal, ints = cbp.pack_state(st, params)
    board = st.board
    flips_in = (st.part_sum, st.last_flipped, st.num_flips)
    ins = (board, key, dp, scal, ints)
    labels = static.labels.numpy()
    models = [BoardPairCounts(h, w, k, spec.contiguity == "patch",
                              board[c].numpy(), dp[:, c].numpy(),
                              static.unit_pop, scal[2, c], scal[3, c])
              for c in range(chains)]
    runs = [Runs(*(x[c].numpy() for x in flips_in), int(ints[3, c]),
                 int(ints[1, c]), int(ints[2, c])) for c in range(chains)]
    log_f, log_s, moves = [], [], 0
    for t in range(steps):
        planes = tb.planes_pair(bg, spec, scal[2], scal[3], board,
                                dp.T.contiguous())
        for c, mdl in enumerate(models):
            valid = planes["valid"][c].numpy()
            per = np.zeros(32 * 32 * mdl.wpl, dtype=np.int64)
            per[:4 * mdl.n] = valid
            np.testing.assert_array_equal(
                mdl.vm, (per.reshape(-1, 32) << np.arange(32)).sum(axis=1))
            np.testing.assert_array_equal(
                mdl.lc, per.reshape(32, -1).sum(axis=1))
            assert mdl.b == int(planes["b_count"][c])
            idx = np.flatnonzero(valid)
            assert [mdl.select(m) for m in range(mdl.total())] == list(idx)
        log_f.append(ints[1].clone())
        log_s.append(ints[2].clone())
        outs = cbp.board_pair_chunk_reference(bg, static, spec, 1, board,
                                              key, dp, scal, ints)
        for c, (mdl, run) in enumerate(zip(models, runs)):
            changed = np.flatnonzero((outs[0][c] != board[c]).numpy())
            assert changed.size == int(outs[4][5, c] - ints[5, c])
            if changed.size:
                v = int(changed[0])
                d_to = int(outs[0][c, v])
                mdl.commit(v, d_to)
                run.accept(t, v, int(labels[d_to]))
                moves += 1
        board, key, dp, ints = outs[0], outs[1], outs[2], outs[4]
        scal = torch.cat([scal[:4], outs[3]])
    # the runs against the JAX package's replay of the same log, and
    # against the plain version's own chunk from the same inputs
    want = jboard.apply_flip_log(
        *(jnp.asarray(x.numpy()) for x in flips_in),
        jnp.asarray(torch.stack(log_f).numpy()),
        jnp.asarray(torch.stack(log_s).numpy()),
        jnp.asarray(ins[4][3].numpy()))
    whole = cbp.board_pair_chunk_reference(bg, static, spec, steps, *ins,
                                           flips_in)
    assert torch.equal(whole[0], board)
    for c, run in enumerate(runs):
        got = run.end(steps)
        for name, x, y, z in zip(("part_sum", "last_flipped", "num_flips"),
                                 got, want, whole[10:]):
            np.testing.assert_array_equal(x, np.asarray(y)[c], err_msg=name)
            np.testing.assert_array_equal(x, z[c].numpy(), err_msg=name)
    for mdl, c in zip(models, range(chains)):
        np.testing.assert_array_equal(mdl.board, board[c].numpy())
        np.testing.assert_array_equal(mdl.dp, dp[:, c].numpy())
    return models, moves


def test_counts_gates_that_bind():
    """8 x 16, k = 8, pop_tol 0.1: the masks change at most moves, and
    each change recounts."""
    models, moves = drive(8, 16, 8, 0.1, 0.8, {}, chains=3, warm=40,
                          steps=60, seed=1)
    assert moves > 0
    assert sum(m.recounts for m in models) > 0


def test_counts_width_that_straddles_words():
    """20 x 13, k = 3: words of 8 cells straddle the rows, the last word
    is partly past the board, and each lane owns two words (33 of them
    hold cells)."""
    models, moves = drive(20, 13, 3, 0.5, 0.8, {}, chains=2, warm=30,
                          steps=50, seed=2)
    assert models[0].wpl == 2 and 20 * 13 % 8
    assert moves > 0
    # a move that changes no mask updates the counts in place
    assert sum(m.recounts for m in models) < moves


def test_counts_contiguity_none():
    """9 x 10, k = 4, contiguity 'none', accept always."""
    models, moves = drive(9, 10, 4, 0.5, 1.3,
                          {"contiguity": "none", "accept": "always"},
                          chains=2, warm=20, steps=40, seed=3)
    assert moves > 0


def test_wrapper_takes_flips_with_parity_only():
    """``flips`` goes with parity_metrics, and ``recounts`` with the
    kernel alone."""
    g = graphs.square_grid(4, 5)
    for parity in (True, False):
        spec = Spec(n_districts=3, proposal="pair", parity_metrics=parity)
        bg, st, params = init_board(g, graphs.stripes_plan(g, 3),
                                    n_chains=2, seed=1, spec=spec, base=1.0,
                                    pop_tol=0.5, device="cpu")
        static = cbp.make_static_inputs(bg, spec, params)
        ins = (st.board, *cbp.pack_state(st, params))
        flips = (st.part_sum, st.last_flipped, st.num_flips)
        wrong = None if parity else flips
        with pytest.raises(ValueError, match="parity_metrics"):
            cbp.run_board_pair_chunk_cuda(bg, static, spec, 4, *ins, wrong)
        right = flips if parity else None
        outs = cbp.run_board_pair_chunk_cuda(bg, static, spec, 4, *ins,
                                             right)
        assert len(outs) == (13 if parity else 10)
        with pytest.raises(ValueError, match="plain version keeps none"):
            cbp.run_board_pair_chunk_cuda(
                bg, static, spec, 4, *ins, right,
                recounts=torch.zeros(2, dtype=torch.int32))
