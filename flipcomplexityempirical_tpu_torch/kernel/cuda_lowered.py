"""The lowered-chunk kernel: its wrapper, its plain version, its contract.

``run_lowered_chunk_cuda`` runs ``t_inner`` steps of the lowered body (the
JAX package's ``_scan_bits_lowered``, bit-identical to its int8 form
``_scan_stencil``) for every chain: sec11, the Frankengraph, queen grids,
every ``record_interface`` spec, and plain rook grids on their stencil
(four of the eight ring directions carry edges, no wall keys), where it
equals the JAX package's rook bodies (``_scan_bits`` and its int8 form)
draw for draw. On a CUDA tensor it launches the
hand-written kernel of ``csrc/lowered_chunk.cu`` (built on first use by
``_build``; one warp per chain, the board bit-packed); on a CPU tensor it
runs ``lowered_chunk_reference``, a per-step PyTorch replay of the int8
body. Both draw the JAX package's threefry stream from the state's keys,
so they agree with the JAX package draw for draw.

    inputs:  board (C, N) int8 (holes -1), key (2, C) int32 (the uint32
             key words' bit patterns), dist_pop (2, C) int32, scal (6, C)
             f32 [log_base, beta, pop_lo, pop_hi, cur_wait, waits_sum],
             ints (8, C) int32 [pending, cur_flip, cur_sign, t_yield,
             move_clock, accepts, exhausted, cut_count], and the static
             inputs of ``make_static_inputs``;
    outputs: board, key, dist_pop as above, scal (2, C) [cur_wait,
             waits_sum], ints (8, C), six int32 and f32 (T, C) rows
             [log_f, log_s, cut, b, wait (f32), accepts], slope and angle
             (f32, NaN without ``record_interface`` or with fewer than two
             cut wall edges), and the chunk's cut counts (4, C, N) int32 of
             the forward planes E, SE, S, SW (SE and SW stay zero on a
             rook grid, whose state keeps no diagonal planes).

With ``acc=`` (a ``stats.accumulators.SummaryAcc``) the chunk also folds
its records into the run's summary accumulator, as the JAX package's
scan bodies call ``fold_out`` on every yield: on the card inside the same
launch (a fold warp of each block, ``csrc/summary_fold.cuh``), on the CPU by
the plain chunk and then ``cuda_summary.fold_chunk_rows``. With
``keep_rows=False`` (summary mode, no history) the kernel writes only the
flip-log pair of the rows, and the row outputs are None.

``run_chunk`` is the chunk at the level of BoardState (the JAX package's
``run_board_chunk`` contract on this body); ``body_for`` names the JAX
package's body that a run equals. ``window_patch_ok`` and
``touches_wall`` are plain forms of two of the kernel's own tests (its
window patch check and its wall-edge test), which the CPU tests hold
against this package's plane functions.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import rng
from . import cuda_summary
from .board import (CUT_KEYS, IFACE_BIG, BoardGraph, BoardState,
                    apply_flip_log, interface_stencil, is_lowered,
                    planes_stencil, ring_offsets)
from .step import Spec, StepParams, geom_denom_finite, geom_wait

# the kernel keeps 128 words of 32 cells a chain (WPL <= 4)
MAX_CELLS = 4096

OUT_NAMES = ("board", "key", "dist_pop", "scal", "ints", "log_f", "log_s",
             "hist_cut", "hist_b", "hist_wait", "hist_acc", "hist_slope",
             "hist_angle", "cut_planes")

# the record's rows in the kernel's lane order (lane r writes row r)
RECORD_ROWS = ("cut_count", "b_count", "wait", "accepts", "log_f", "log_s",
               "slope", "angle")
# the outputs a fused launch without a history leaves unwritten (None)
FOLD_ONLY_OUTS = tuple(range(7, 13))


def fold_row_index(spec: Spec) -> dict:
    """{name: lane} of the record rows a chunk's fold may read: the rows
    ``run_chunk`` returns (slope and angle under ``record_interface``)."""
    names = ("cut_count", "b_count", "wait", "accepts")
    if spec.record_interface:
        names += ("slope", "angle")
    return {k: RECORD_ROWS.index(k) for k in names}


def chunk_rows(spec: Spec, outs) -> dict:
    """The rows ``run_chunk`` returns, {name: (T, C)}, from a chunk's
    outputs (``fold_row_index``'s names)."""
    rows = dict(zip(("cut_count", "b_count", "wait", "accepts", "slope",
                     "angle"), outs[7:13]))
    return {k: rows[k] for k in fold_row_index(spec)}


@dataclasses.dataclass
class LoweredStatic:
    """The kernel's static inputs, made once a run on the board's device.
    Word planes hold cell 32 * word + bit of the flat canvas."""

    adj_words: torch.Tensor   # int32 (8, NW) ring-direction edge bits
    wall_words: torch.Tensor  # int32 (4, NW) forward cells with a wall key
    node_words: torch.Tensor  # int32 (NW,) real cells
    cell_class: torch.Tensor  # int32 (N,) the cell's patch class
    class_rows: torch.Tensor  # int32 (n_classes, 32), in window positions:
                              # the patch, the neighbours, then the patch
                              # adjacency of each of the 25 positions
    iface_key: torch.Tensor   # int32 (4, N), IFACE_BIG where no wall edge
    labels: tuple             # the district labels (label_values)
    unit_pop: int             # pop[cell_of_node[0]]: cell 0 may be a hole
    w: int                    # the canvas width (flat row-major cells)


def supports(bg: BoardGraph, spec: Spec) -> bool:
    """What ``bitboard.supported_lowered`` admits, on a graph with a
    stencil (a lowered workload, or a plain rook grid of height and width
    at least 3): uniform population, the 2-district 'bi' walk, accept
    'cut' / 'always', contiguity 'patch' / 'none' ('patch' with one 2-D
    displacement per window offset, which a canvas of width 3 lacks); no
    annealing or assignment bits."""
    return (bg.adj is not None
            and (spec.contiguity != "patch" or bg.b2_disp is not None)
            and bool(bg.uniform_pop)
            and spec.n_districts == 2
            and spec.proposal == "bi"
            and spec.accept in ("cut", "always")
            and spec.contiguity in ("patch", "none")
            and spec.anneal == "none"
            and not spec.record_assignment_bits
            and (not spec.record_interface or bg.iface_ok))


def body_for(bg: BoardGraph, spec: Spec, bits: Optional[bool] = None) -> str:
    """The JAX package's body (its ``kernel/board.py::body_for``) that a
    run of this kernel equals draw for draw: 'lowered_bits' on surgical
    canvases and ``record_interface`` specs; on a plain rook grid
    'bitboard' (``_scan_bits``) where the JAX package packs it (a width
    that is a multiple of 32) and its bit-identical int8 rook body
    'board' elsewhere. The JAX package packs what ``supports`` admits
    (its ``bitboard.supported_lowered``; ``bitboard.supported`` adds the
    width rule on a rook grid). ``bits=True`` insists on a packed body,
    as in the JAX package; ``bits=False`` selects the JAX package's int8
    bodies as a performance choice, which this package has not ported
    (ROADMAP.md B7), and raises."""
    if bits is not None and not bits:
        raise ValueError("bits=False selects the JAX package's int8 board "
                         "bodies, which this package has not ported "
                         "(ROADMAP.md B7); pass bits=None")
    lowered = is_lowered(bg, spec)
    packs = supports(bg, spec) and (lowered or bg.w % 32 == 0)
    if bits and not packs:
        raise ValueError("bits=True: workload not supported by the JAX "
                         "package's packed bodies")
    if lowered:
        return "lowered_bits" if packs else "lowered"
    return "bitboard" if packs else "board"


def check(bg: BoardGraph, spec: Spec, params: StepParams) -> None:
    """Raise unless the kernel reproduces the requested semantics."""
    if bg.adj is None:
        raise ValueError(f"the {bg.h}x{bg.w} grid does not lower to a "
                         "stencil (a plain grid needs height and width of at "
                         "least 3); run it with run_board_cuda")
    if not supports(bg, spec):
        raise ValueError(
            "the lowered-chunk kernel serves uniform population, the "
            "2-district 'bi' walk, accept 'cut' / 'always', contiguity "
            f"'patch' / 'none', no annealing; got {spec}, uniform_pop="
            f"{bg.uniform_pop}")
    if params.label_values.numel() != 2:
        raise ValueError("label_values must hold the two district labels")
    if bg.n > MAX_CELLS:
        raise ValueError(f"canvas of {bg.n} cells exceeds the lowered "
                         f"kernel's {MAX_CELLS} (a plain rook grid that "
                         "large waits for ROADMAP.md B2; run_board_cuda "
                         "takes it)")
    if spec.geom_waits and not geom_denom_finite(bg.n_real, 2):
        raise ValueError("geom_waits: n**2 - 1 overflows float32")


def _pack_words(plane: torch.Tensor) -> torch.Tensor:
    """bool (..., N) -> int32 (..., ceil(N / 32)) bit patterns, cell
    32 * word + bit."""
    n = plane.shape[-1]
    nw = (n + 31) // 32
    p = torch.nn.functional.pad(plane.to(torch.int64), (0, 32 * nw - n))
    p = p.reshape(*plane.shape[:-1], nw, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=plane.device)
    words = (p << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _window_bits(words: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Offset-indexed bitsets (bit k = B2 offset k) -> window-position
    bitsets (bit pos[k])."""
    out = np.zeros(words.shape, np.int64)
    for k, p in enumerate(pos):
        out |= ((words >> k) & 1) << int(p)
    return out


def patch_classes(bg: BoardGraph):
    """The cells' B2 tables in window coordinates, deduplicated:
    (cell_class (N,), class_rows (n_classes, 32)) int32. Window position
    p = 5 * (dr + 2) + (dc + 2) of the (dr, dc) displacement within the
    5 x 5 window around the cell (a radius-2 king ball never leaves it),
    row = [patch members, direct neighbours, the patch adjacency of each
    position p, 0 ...]. A few dozen rows serve sec11 and the Frankengraph,
    so the kernel keeps them in shared memory and reads a cell's window as
    five 5-bit fields of the board."""
    disp = np.asarray(bg.b2_disp, np.int64).reshape(-1, 2)
    if np.abs(disp).max(initial=0) > 2:
        raise ValueError("a B2 offset leaves the 5 x 5 window")
    pos = 5 * (disp[:, 0] + 2) + disp[:, 1] + 2
    b2_in = bg.b2_in.cpu().numpy().astype(np.int64)
    b2_adj = bg.b2_adj.cpu().numpy().astype(np.int64)
    table = np.zeros((bg.n, 32), np.int64)
    table[:, 0] = (b2_in << pos[:, None]).sum(axis=0)
    table[:, 1] = _window_bits(bg.nbr_bits.cpu().numpy().astype(np.int64),
                               pos)
    for k, p in enumerate(pos):
        table[:, 2 + p] = _window_bits(b2_adj[k], pos)
    rows, cell_class = np.unique(table, axis=0, return_inverse=True)
    return (cell_class.reshape(-1).astype(np.int32),
            rows.astype(np.uint32).view(np.int32))


def make_static_inputs(bg: BoardGraph, spec: Spec,
                       params: StepParams) -> LoweredStatic:
    """The kernel's static planes for (bg, spec), made once a run."""
    check(bg, spec, params)
    dev = bg.pop.device
    i32 = torch.int32
    if spec.contiguity == "patch":
        cell_class, class_rows = patch_classes(bg)
    else:  # no patch check: one empty class
        cell_class = np.zeros(bg.n, np.int32)
        class_rows = np.zeros((1, 32), np.int32)
    if bg.iface_key is not None and spec.record_interface:
        iface_key = bg.iface_key.to(i32).contiguous()
    else:
        iface_key = torch.full((4, bg.n), IFACE_BIG, dtype=i32, device=dev)
    unit = int(bg.pop[bg.cell_of_node[0]])
    return LoweredStatic(
        adj_words=_pack_words(bg.adj).contiguous(),
        wall_words=_pack_words(iface_key < IFACE_BIG).contiguous(),
        node_words=_pack_words(bg.node_mask).contiguous(),
        cell_class=torch.as_tensor(cell_class, device=dev),
        class_rows=torch.as_tensor(class_rows, device=dev),
        iface_key=iface_key,
        labels=tuple(int(x) for x in params.label_values.cpu()),
        unit_pop=unit, w=bg.w)


def window_patch_ok(static: LoweredStatic, board: torch.Tensor,
                    cells) -> torch.Tensor:
    """The kernel's patch check (``csrc/lowered_chunk.cu::patch_ok``) of
    ``cells`` on every chain: bool (C, len(cells)). The kernel's own
    formulation: the cell's class row from ``patch_classes``, the member
    bitset over the 5 x 5 window of the bit-packed board (holes and cells
    off the canvas pack as 0), seeds = direct neighbours, reach grown from
    the lowest seed over the class row's patch adjacency until nothing new
    is reached (the worklist's closure, taken a frontier at a time)."""
    i64 = torch.int64
    dev = board.device
    w = static.w
    cells = torch.as_tensor(cells, dtype=i64, device=dev).reshape(-1)
    bits = (board == 1).to(i64)
    pad = 2 * w + 2
    padded = torch.nn.functional.pad(bits, (pad, pad))
    p = torch.arange(25, dtype=i64, device=dev)
    off = (p // 5 - 2) * w + p % 5 - 2                    # window position p
    win = padded[:, pad + cells[:, None] + off[None, :]]  # (C, M, 25)
    same = ((win == bits[:, cells][..., None]).to(i64) << p).sum(dim=-1)
    rows = static.class_rows.to(i64)[static.cell_class.to(i64)[cells]]
    rows = rows & 0xFFFFFFFF                              # (M, 32) uint32
    member = same & rows[:, 0]
    seeds = member & rows[:, 1]
    reach = seeds & -seeds
    frontier = reach
    while bool((frontier != 0).any()):
        grown = torch.zeros_like(frontier)
        for q in range(25):
            hit = ((frontier >> q) & 1) == 1
            grown |= torch.where(hit, rows[:, 2 + q], 0)
        frontier = grown & member & ~reach
        reach |= frontier
    return (seeds & ~reach) == 0


def touches_wall(bg: BoardGraph, static: LoweredStatic,
                 cells) -> torch.Tensor:
    """The kernel's test of whether a flip at each of ``cells`` changes the
    set of cut wall edges: bool (len(cells),), True where the cell has a
    wall edge (every edge of a flipped cell changes its cut state). An
    edge in a backward direction d is stored at the neighbour, in plane
    d & 3."""
    i64 = torch.int64
    n = bg.n
    wall = static.iface_key < IFACE_BIG                   # (4, N)
    cells = torch.as_tensor(cells, dtype=i64,
                            device=wall.device).reshape(-1)
    hit = torch.zeros(cells.shape, dtype=torch.bool, device=wall.device)
    for d, o in enumerate(ring_offsets(bg.w)):
        at = cells if d < 4 else cells + o
        inside = (at >= 0) & (at < n)
        hit |= bg.adj[d][cells] & inside & wall[d & 3][at.clamp(0, n - 1)]
    return hit


def _words_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 bit patterns."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def pack_state(state: BoardState, params: StepParams):
    """BoardState + params -> (key (2, C), dist_pop (2, C), scal (6, C),
    ints (8, C)), the kernel's per-chain inputs."""
    f32, i32 = torch.float32, torch.int32
    key = _words_i32(state.key.to(torch.int64) & rng.MASK32).T.contiguous()
    dist_pop = state.dist_pop.to(i32).T.contiguous()
    scal = torch.stack([params.log_base.to(f32), params.beta.to(f32),
                        params.pop_lo.to(f32), params.pop_hi.to(f32),
                        state.cur_wait.to(f32), state.waits_sum.to(f32)])
    ints = torch.stack([state.wait_pending.to(i32), state.cur_flip.to(i32),
                        state.cur_sign.to(i32), state.t_yield.to(i32),
                        state.move_clock.to(i32), state.accept_count.to(i32),
                        state.exhausted_count.to(i32),
                        state.cut_count.to(i32)])
    return key, dist_pop, scal.contiguous(), ints.contiguous()


def unpack_state(state: BoardState, outs, t_inner: int) -> BoardState:
    """Merge chunk outputs back into a BoardState (tries_sum counts one
    draw per yield). A rook grid's state keeps no diagonal planes
    (``cut_times_se`` / ``cut_times_sw`` None, as in the JAX package): the
    kernel's SE and SW counts, zero there, are dropped."""
    board, key, dist_pop, scal, ints = outs[:5]
    cuts = outs[13]
    diag = {}
    if state.cut_times_se is not None:
        diag = dict(cut_times_se=state.cut_times_se + cuts[1],
                    cut_times_sw=state.cut_times_sw + cuts[3])
    return state.replace(
        key=key.T.to(torch.int64) & rng.MASK32,
        board=board,
        dist_pop=dist_pop.T.contiguous(),
        cut_count=ints[7],
        cur_wait=scal[0],
        wait_pending=ints[0] > 0,
        cur_flip=ints[1],
        cur_sign=ints[2],
        t_yield=ints[3],
        move_clock=ints[4],
        accept_count=ints[5],
        exhausted_count=ints[6],
        waits_sum=scal[1],
        tries_sum=state.tries_sum + t_inner,
        cut_times_e=state.cut_times_e + cuts[0],
        cut_times_s=state.cut_times_s + cuts[2], **diag)


def lowered_chunk_reference(bg: BoardGraph, static: LoweredStatic,
                            spec: Spec, t_inner: int, board, key, dist_pop,
                            scal, ints):
    """The plain version of the kernel: a per-step PyTorch replay of the
    JAX package's int8 lowered body (``_scan_stencil``: split the key,
    plane pass, wait, record, m-th valid selection, accept, commit) with
    the kernel's inputs and outputs (module docstring)."""
    c, n = board.shape
    dev = board.device
    f32, i32 = torch.float32, torch.int32
    b = board.clone()
    keys = key.T.to(torch.int64) & rng.MASK32
    dp = dist_pop.T.to(i32).clone()
    log_base, beta, pop_lo, pop_hi, cur_wait, waits_sum = (
        scal[k] for k in range(6))
    (pending, cur_flip, cur_sign, tyield, move_clock, acc_cnt, exh_cnt,
     cut_count) = (ints[k] for k in range(8))
    pending = pending > 0
    labels = torch.tensor(static.labels, dtype=i32, device=dev)
    tiny = torch.tensor(1e-12, dtype=f32, device=dev)
    rows = {k: torch.empty((t_inner, c), dtype=i32, device=dev)
            for k in ("log_f", "log_s", "cut", "b", "acc")}
    frows = {k: torch.full((t_inner, c), float("nan"), dtype=f32,
                           device=dev) for k in ("wait", "slope", "angle")}
    cuts = torch.zeros((4, c, n), dtype=i32, device=dev)
    ar = torch.arange(c, device=dev)

    for t in range(t_inner):
        ks = rng.split(keys, 4)
        keys, kprop, kacc, kwait = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
        planes = planes_stencil(bg, spec, pop_lo, pop_hi, b, dp)

        # complete the pending wait, record yield t
        if spec.geom_waits:
            w = geom_wait(rng.uniform(kwait), planes["b_count"], bg.n_real,
                          2)
            cur_wait = torch.where(pending, w, cur_wait)
        rows["cut"][t] = cut_count
        rows["b"][t] = planes["b_count"]
        frows["wait"][t] = cur_wait
        rows["acc"][t] = acc_cnt
        rows["log_f"][t] = cur_flip
        rows["log_s"][t] = cur_sign
        if spec.record_interface:
            frows["slope"][t], frows["angle"][t] = interface_stencil(
                bg, [planes[k] for k in CUT_KEYS])
        for d, k in enumerate(CUT_KEYS):
            cuts[d] += planes[k].to(i32)
        waits_sum = waits_sum + cur_wait
        tyield = tyield + 1

        # transition: the m-th valid cell in flat order, accept, commit
        valid = planes["valid"]
        total = valid.sum(dim=1).to(i32)
        any_valid = total > 0
        m = torch.minimum((rng.uniform(kprop) * total.to(f32)).to(i32),
                          torch.clamp_min(total - 1, 0))
        csum = torch.cumsum(valid.to(i32), dim=1)
        flat = (csum > m[:, None]).to(i32).argmax(dim=1)
        d_from = b[ar, flat].to(i32)      # -1 at a hole: never committed
        d_to = 1 - d_from
        dcut = bg.deg[flat] - 2 * planes["diff_deg"][ar, flat]
        if spec.accept == "always":
            accept = any_valid
        else:
            bound = -beta * dcut.to(f32) * log_base
            logu = torch.log(torch.maximum(rng.uniform(kacc), tiny))
            accept = any_valid & (logu < bound)
        b[ar, flat] = torch.where(accept, d_to, d_from).to(b.dtype)
        acc_i = accept.to(i32)
        popv = bg.pop[flat] * acc_i
        sgn = torch.where(d_from == 0, 1, -1).to(i32)
        dp = torch.stack([dp[:, 0] - popv * sgn, dp[:, 1] + popv * sgn],
                         dim=1)
        cut_count = cut_count + dcut * acc_i
        cur_flip = torch.where(accept, flat.to(i32), cur_flip)
        cur_sign = torch.where(accept, labels[d_to.clamp(0, 1)], cur_sign)
        pending = accept
        move_clock = move_clock + acc_i
        acc_cnt = acc_cnt + acc_i
        exh_cnt = exh_cnt + (~any_valid).to(i32)

    return (b, _words_i32(keys).T.contiguous(), dp.T.contiguous(),
            torch.stack([cur_wait, waits_sum]),
            torch.stack([pending.to(i32), cur_flip, cur_sign, tyield,
                         move_clock, acc_cnt, exh_cnt, cut_count]).to(i32),
            rows["log_f"], rows["log_s"], rows["cut"], rows["b"],
            frows["wait"], rows["acc"], frows["slope"], frows["angle"],
            cuts)


def _check_inputs(bg: BoardGraph, static: LoweredStatic, t_inner: int,
                  board, key, dist_pop, scal, ints) -> None:
    c, n = board.shape
    if n != bg.n:
        raise ValueError(f"board has {n} cells, canvas is {bg.h}x{bg.w}")
    if t_inner < 1:
        raise ValueError(f"t_inner {t_inner} < 1")
    nw = (n + 31) // 32
    want = [(board, (c, n), torch.int8), (key, (2, c), torch.int32),
            (dist_pop, (2, c), torch.int32), (scal, (6, c), torch.float32),
            (ints, (8, c), torch.int32),
            (static.adj_words, (8, nw), torch.int32),
            (static.wall_words, (4, nw), torch.int32),
            (static.node_words, (nw,), torch.int32),
            (static.cell_class, (n,), torch.int32),
            (static.class_rows, (static.class_rows.shape[0], 32),
             torch.int32),
            (static.iface_key, (4, n), torch.int32)]
    for x, shape, dtype in want:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"expected {dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != board.device:
            raise ValueError(f"tensor on {x.device}, board on {board.device}")
        if not x.is_contiguous():
            raise ValueError("chunk inputs must be contiguous")


def _entry(lib):
    """``lib``'s ``fce_lowered_chunk`` with its C signature declared: 26
    pointers, 17 ints, two floats, the fold's two host arrays (null in
    history mode), the stream."""
    fn = lib.fce_lowered_chunk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 17
                       + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
    return fn


def _launch(lib, bg: BoardGraph, static: LoweredStatic, spec: Spec,
            t_inner: int, board, key, dist_pop, scal, ints, acc=None,
            keep_rows: bool = True):
    c, n = board.shape
    dev = board.device
    i32, f32 = torch.int32, torch.float32

    def rows(dtype, written=True):
        return (torch.empty((t_inner, c), dtype=dtype, device=dev)
                if written else None)

    outs = (torch.empty((c, n), dtype=torch.int8, device=dev),
            torch.empty((2, c), dtype=i32, device=dev),
            torch.empty((2, c), dtype=i32, device=dev),
            torch.empty((2, c), dtype=f32, device=dev),
            torch.empty((8, c), dtype=i32, device=dev),
            rows(i32), rows(i32),
            *(rows(dt, keep_rows) for dt in (i32, i32, f32, i32, f32, f32)),
            torch.empty((4, c, n), dtype=i32, device=dev))
    # last flip step of each cell, read by the kernel only where it wrote
    # it in this launch
    scratch = torch.empty((c, n), dtype=i32, device=dev)
    ins = [board, key, dist_pop, scal, ints, static.adj_words,
           static.wall_words, static.node_words, static.cell_class,
           static.class_rows, static.iface_key, *outs, scratch]
    qx_off, qy_off, bx, by = bg.iface_decode
    args = ([None if x is None else x.data_ptr() for x in ins], c, bg.h,
            bg.w, bg.n_real, static.class_rows.shape[0], t_inner,
            int(spec.contiguity == "patch"), int(spec.geom_waits),
            int(spec.accept == "always"), int(spec.record_interface),
            static.labels[0], static.labels[1], static.unit_pop,
            int(qx_off), int(qy_off), int(bx), int(by),
            float(bg.center[0]), float(bg.center[1]))

    def launch(fold_ptrs=None, fold_ints=None):
        ptrs, *rest = args
        with torch.cuda.device(dev):
            err = _entry(lib)(*ptrs, *rest, fold_ptrs, fold_ints,
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"lowered_chunk launch failed: CUDA error "
                               f"{err}")

    if acc is None:
        launch()
        return outs
    return outs, cuda_summary.fused_fold(acc, fold_row_index(spec), c, launch,
                                         keep_rows)


def _fold_on_host(bg, static, spec, t_inner, args, acc, keep_rows):
    """The plain version of a fused launch: the plain chunk, then the fold
    of its rows (``cuda_summary.fold_chunk_rows``)."""
    outs = lowered_chunk_reference(bg, static, spec, t_inner, *args)
    acc = cuda_summary.fold_chunk_rows(acc, chunk_rows(spec, outs),
                                       fold_row_index(spec))
    if not keep_rows:
        outs = tuple(None if i in FOLD_ONLY_OUTS else x
                     for i, x in enumerate(outs))
    return outs, acc


def run_lowered_chunk_cuda(bg: BoardGraph, static: LoweredStatic,
                           spec: Spec, t_inner: int, board, key, dist_pop,
                           scal, ints, acc=None, keep_rows: bool = True):
    """One chunk for all chains (module docstring for the layout). A CUDA
    board launches the kernel; a CPU board runs the plain version.
    ``run_lowered_chunk_cuda.launches`` counts kernel launches. With
    ``acc`` the chunk folds its records into it and returns (outs, the
    updated accumulator), on the card in the same launch
    (``cuda_summary.fused_fold.launches`` counts those);
    ``keep_rows=False``, for a run that keeps no history, leaves the rows
    only the fold reads unwritten (None)."""
    _check_inputs(bg, static, t_inner, board, key, dist_pop, scal, ints)
    if acc is None and not keep_rows:
        raise ValueError("keep_rows=False drops the rows that only the "
                         "fold reads: pass an accumulator")
    args = (bg, static, spec, t_inner, board, key, dist_pop, scal, ints)
    if board.device.type == "cuda":
        from . import _build
        out = _launch(_build.load("lowered_chunk"), *args, acc=acc,
                      keep_rows=keep_rows)
        run_lowered_chunk_cuda.launches += 1
        return out
    if board.device.type == "cpu":
        if acc is None:
            return lowered_chunk_reference(*args)
        return _fold_on_host(bg, static, spec, t_inner, args[4:], acc,
                             keep_rows)
    raise ValueError(f"no lowered-chunk path for device {board.device}")


run_lowered_chunk_cuda.launches = 0


def run_chunk(bg: BoardGraph, spec: Spec, params: StepParams,
              state: BoardState, t_inner: int,
              static: LoweredStatic | None = None, acc=None,
              keep_rows: bool = True):
    """``t_inner`` iterations of [split, complete wait, record, transition]
    on the lowered body, with the flip log replayed into part_sum /
    last_flipped / num_flips: the JAX package's ``run_board_chunk`` on
    this body. Returns (state, rows), rows {name: (T, C) tensor} with
    cut_count, b_count, wait, accepts and, under ``record_interface``,
    slope and angle. With ``acc`` (a ``SummaryAcc``) the records are also
    folded into it and the return is (state, rows, acc); with
    ``keep_rows=False`` besides, rows is empty and the kernel writes none
    of them (``run_lowered_chunk_cuda``)."""
    if static is None:
        static = make_static_inputs(bg, spec, params)
    t0 = state.t_yield
    key, dist_pop, scal, ints = pack_state(state, params)
    outs = run_lowered_chunk_cuda(bg, static, spec, t_inner, state.board,
                                  key, dist_pop, scal, ints, acc=acc,
                                  keep_rows=keep_rows)
    if acc is not None:
        outs, acc = outs
    state = unpack_state(state, outs, t_inner)
    if spec.parity_metrics:
        ps, lf, nf = apply_flip_log(state.part_sum, state.last_flipped,
                                    state.num_flips, outs[5], outs[6], t0)
        state = state.replace(part_sum=ps, last_flipped=lf, num_flips=nf)
    rows = chunk_rows(spec, outs) if keep_rows else {}
    return (state, rows) if acc is None else (state, rows, acc)
