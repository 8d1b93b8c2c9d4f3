"""The rook board's pair-chunk kernel: its wrapper, its plain version, its
contract.

``run_board_pair_chunk_cuda`` runs ``t_inner`` steps of the k-district
pair walk on a plain rook grid (the JAX package's ``_scan_bits_pair``,
bit-identical to its int8 form ``_planes_pair`` / ``_transition_pair``,
which it runs at any width) for every chain of a ``BoardState``, and
under ``parity_metrics`` advances part_sum / last_flipped / num_flips by
the chunk's flip log (the JAX package's ``apply_flip_log``). On CUDA
tensors it launches the hand-written kernel of
``csrc/board_pair_chunk.cu`` (built on first use by ``_build``; one warp
a chain, two chains a block, the board a byte a cell in shared memory
beside a mask of the valid pair slots of each word of 8 cells and each
lane's count of them, changed only inside an accepted move's 3 x 3 block
and recounted only when the move changes a population mask; the m-th
valid slot found in three warp rounds; the flip-log runs closed in the
kernel);
on CPU tensors it runs ``board_pair_chunk_reference``, a per-step PyTorch
replay of the int8 body followed by ``apply_flip_log``. Both draw the JAX
package's threefry stream from the state's keys, ``split(key, 4)`` a
step, so they agree with the JAX package draw for draw.

The kernel's scope (``supports``): what ``kernel.board.supports`` admits
for the 'pair' proposal (a plain rook grid of height and width at least
3, 2 to 31 districts, a uniform population, accept 'cut' or 'always',
contiguity 'patch' or 'none', a finite wait denominator), without
annealing and up to ``MAX_CELLS`` cells. ``check`` refuses the rest,
naming the ROADMAP.md item; the runner never runs the plain version in
the kernel's place on the card.

    inputs:  board (C, N) int8, key (2, C) int32 (the uint32 key words'
             bit patterns), dist_pop (K, C) int32, scal (6, C) f32
             [log_base, beta, pop_lo, pop_hi, cur_wait, waits_sum], ints
             (8, C) int32 [pending, cur_flip, cur_sign, t_yield,
             move_clock, accepts, exhausted, cut_count], under
             ``parity_metrics`` ``flips`` (part_sum, last_flipped,
             num_flips), each (C, N) int32, and the static inputs of
             ``make_static_inputs`` (the K district labels);
    outputs: board, key, dist_pop as above, scal (2, C) [cur_wait,
             waits_sum], ints (8, C), the (T, C) rows [cut, b, wait (f32),
             accepts], the chunk's cut counts (2, C, N) int32 of the E and
             S planes and, under ``parity_metrics``, part_sum,
             last_flipped and num_flips after the chunk (``OUT_NAMES``).
The inputs are left as they are.

``run_chunk`` is the chunk at the level of BoardState (the JAX package's
``run_board_chunk`` contract on this body); with ``acc=`` it folds the
chunk's rows into a summary accumulator by the standalone fold
(``cuda_summary.summary_fold``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from .. import rng
from . import cuda_summary
from .board import (BoardGraph, BoardState, apply_flip_log, is_pair,
                    planes_pair, supported_pair, transition_pair)
from .cuda_lowered import _words_i32, pack_state
from .step import Spec, StepParams, geom_denom_finite, geom_wait

# the kernel keeps a chain's board and slots in shared memory
MAX_CELLS = 4096
# a district is a lane of the warp; ids and labels fit the board's bytes
MAX_DISTRICTS = 31

OUT_NAMES = ("board", "key", "dist_pop", "scal", "ints", "hist_cut",
             "hist_b", "hist_wait", "hist_acc", "cut_planes", "part_sum",
             "last_flipped", "num_flips")
ROW_NAMES = ("cut_count", "b_count", "wait", "accepts")


@dataclasses.dataclass
class PairBoardStatic:
    """The kernel's static inputs, made once a run on the board's device."""

    labels: torch.Tensor     # (K,) int32 district labels
    unit_pop: int            # every cell's population
    denom: float             # the wait's n**k - 1, rounded to f32


def _refusal(bg: BoardGraph, spec: Spec) -> Optional[str]:
    """Why the kernel does not run (bg, spec), or None."""
    k = spec.n_districts
    if not is_pair(spec):
        return "the board pair kernel runs proposal 'pair' only"
    if not 2 <= k <= MAX_DISTRICTS:
        return f"2 to {MAX_DISTRICTS} districts; got k={k}"
    if bg.surgical or bg.adj is None or bg.h < 3 or bg.w < 3:
        return ("a plain rook grid of height and width at least 3 (one "
                "that lowers to a stencil); surgical canvases run the "
                "2-district walk only")
    if spec.accept not in ("cut", "always") or spec.anneal != "none":
        return (f"accept {spec.accept!r} / anneal {spec.anneal!r} in the "
                "board pair kernel waits for ROADMAP.md B4 (the step "
                "tail's accept rules)")
    if spec.contiguity not in ("patch", "none"):
        return f"contiguity {spec.contiguity!r}: 'patch' or 'none'"
    if (spec.record_interface or spec.record_assignment_bits
            or spec.weighted_cut or spec.nobacktrack or spec.lazy_uniform
            or spec.frame_interface or spec.invalid != "repropose"):
        return (f"{spec} is outside the JAX package's board pair body "
                "(kernel.board.supports)")
    if not bg.uniform_pop:
        return "the pair body's population gates need a uniform population"
    if bg.n > MAX_CELLS:
        return (f"a board of {bg.n} cells exceeds the kernel's {MAX_CELLS} "
                "(larger rook grids wait for ROADMAP.md B2)")
    if spec.geom_waits and not geom_denom_finite(bg.n, k):
        return f"geom_waits: n**{k} - 1 overflows float32"
    return None


def supports(bg: BoardGraph, spec: Spec) -> bool:
    """True iff the kernel reproduces (bg, spec) (module docstring)."""
    return _refusal(bg, spec) is None


def check(bg: BoardGraph, spec: Spec, params: StepParams) -> None:
    """Raise unless the kernel reproduces the requested semantics."""
    why = _refusal(bg, spec)
    if why is not None:
        raise ValueError(f"the board pair kernel does not run {spec}: {why}")
    if params.label_values.numel() != spec.n_districts:
        raise ValueError("label_values must hold one label a district")


def body_for(bg: BoardGraph, spec: Spec, bits: Optional[bool] = None) -> str:
    """The JAX package's body that a run of this kernel equals draw for
    draw: 'bitboard' (``_scan_bits_pair``) where its packed pair body runs
    (``board.supported_pair``: a width that is a multiple of 32), its
    bit-identical int8 pair body 'board' elsewhere. ``bits=True`` insists
    on the packed body, ``bits=False`` names the int8 one; both are the
    same trajectory, and this kernel draws it."""
    packs = supported_pair(bg, spec)
    if bits and not packs:
        raise ValueError("bits=True: workload not supported by the JAX "
                         "package's packed pair body")
    use = packs if bits is None else bool(bits)
    return "bitboard" if use else "board"


def make_static_inputs(bg: BoardGraph, spec: Spec,
                       params: StepParams) -> PairBoardStatic:
    """The kernel's static inputs for (bg, spec), made once a run."""
    check(bg, spec, params)
    denom = float(torch.tensor(float(bg.n) ** spec.n_districts - 1.0,
                               dtype=torch.float32))
    return PairBoardStatic(
        labels=params.label_values.to(dtype=torch.int32,
                                      device=bg.pop.device).contiguous(),
        unit_pop=int(bg.pop[0]), denom=denom)


def unpack_state(state: BoardState, outs, t_inner: int) -> BoardState:
    """Merge chunk outputs back into a BoardState (tries_sum counts one
    draw per yield)."""
    board, key, dist_pop, scal, ints = outs[:5]
    cuts = outs[9]
    flips = {}
    if len(outs) > 10:
        flips = dict(zip(("part_sum", "last_flipped", "num_flips"),
                         outs[10:13]))
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
        cut_times_s=state.cut_times_s + cuts[1], **flips)


def board_pair_chunk_reference(bg: BoardGraph, static: PairBoardStatic,
                               spec: Spec, t_inner: int, board, key,
                               dist_pop, scal, ints, flips=None):
    """The plain version of the kernel: a per-step PyTorch replay of the
    JAX package's int8 pair body (split the key, ``planes_pair``, wait,
    record, ``transition_pair``, commit) and, with ``flips``, the replay
    of the chunk's flip log by ``apply_flip_log``, with the kernel's inputs
    and outputs (module docstring)."""
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
    labels = static.labels.to(dev)
    rows = {k: torch.empty((t_inner, c), dtype=i32, device=dev)
            for k in ("log_f", "log_s", "cut", "b", "acc")}
    wait_rows = torch.empty((t_inner, c), dtype=f32, device=dev)
    cuts = torch.zeros((2, c, n), dtype=i32, device=dev)

    for t in range(t_inner):
        ks = rng.split(keys, 4)
        keys, kprop, kacc, kwait = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
        planes = planes_pair(bg, spec, pop_lo, pop_hi, b, dp)

        # complete the pending wait, record yield t
        if spec.geom_waits:
            w = geom_wait(rng.uniform(kwait), planes["b_count"], n,
                          spec.n_districts)
            cur_wait = torch.where(pending, w, cur_wait)
        rows["cut"][t] = cut_count
        rows["b"][t] = planes["b_count"]
        wait_rows[t] = cur_wait
        rows["acc"][t] = acc_cnt
        rows["log_f"][t] = cur_flip
        rows["log_s"][t] = cur_sign
        cuts[0] += planes["cut_e"].to(i32)
        cuts[1] += planes["cut_s"].to(i32)
        waits_sum = waits_sum + cur_wait
        tyield = tyield + 1

        # transition: the m-th valid slot, accept, commit
        tr = transition_pair(bg, spec, beta, log_base, b, dp, planes,
                             rng.uniform(kprop), rng.uniform(kacc))
        accept, acc_i = tr["accept"], tr["accept"].to(i32)
        b, dp = tr["board"], tr["dist_pop"]
        cut_count = cut_count + tr["dcut"] * acc_i
        cur_flip = torch.where(accept, tr["flat"], cur_flip)
        cur_sign = torch.where(accept, labels[tr["d_to"].to(torch.int64)],
                               cur_sign)
        pending = accept
        move_clock = move_clock + acc_i
        acc_cnt = acc_cnt + acc_i
        exh_cnt = exh_cnt + (~tr["any_valid"]).to(i32)

    outs = (b, _words_i32(keys).T.contiguous(), dp.T.contiguous(),
            torch.stack([cur_wait, waits_sum]),
            torch.stack([pending.to(i32), cur_flip, cur_sign, tyield,
                         move_clock, acc_cnt, exh_cnt, cut_count]).to(i32),
            rows["cut"], rows["b"], wait_rows, rows["acc"], cuts)
    if flips is None:
        return outs
    return outs + apply_flip_log(*flips, rows["log_f"], rows["log_s"],
                                 ints[3])


def _check_inputs(bg: BoardGraph, static: PairBoardStatic, spec: Spec,
                  t_inner: int, board, key, dist_pop, scal, ints, flips,
                  recounts) -> None:
    c, n = board.shape
    if n != bg.n:
        raise ValueError(f"board has {n} cells, the grid is {bg.h}x{bg.w}")
    if t_inner < 1:
        raise ValueError(f"t_inner {t_inner} < 1")
    if (flips is None) == spec.parity_metrics:
        raise ValueError("flips (part_sum, last_flipped, num_flips) go with "
                         "parity_metrics, and only with it")
    k = static.labels.numel()
    want = [(board, (c, n), torch.int8), (key, (2, c), torch.int32),
            (dist_pop, (k, c), torch.int32), (scal, (6, c), torch.float32),
            (ints, (8, c), torch.int32), (static.labels, (k,), torch.int32)]
    want += [(x, (c, n), torch.int32) for x in flips or ()]
    if recounts is not None:
        if board.device.type != "cuda":
            raise ValueError("recounts counts the kernel's bookkeeping; the "
                             "plain version keeps none")
        want.append((recounts, (c,), torch.int32))
    for x, shape, dtype in want:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"expected {dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != board.device:
            raise ValueError(f"tensor on {x.device}, board on {board.device}")
        if not x.is_contiguous():
            raise ValueError("chunk inputs must be contiguous")


def _entry(lib):
    """``lib``'s ``fce_board_pair_chunk`` with its C signature declared: 23
    pointers, 10 ints, the wait denominator, the stream."""
    fn = lib.fce_board_pair_chunk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 23 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def launch_shape(n_cells: int) -> dict:
    """How the kernel runs a board of ``n_cells`` on this card:
    ``chain_bytes`` (a chain's shared memory, a block's), ``chains_per_block``
    (one), ``blocks_per_sm`` resident, ``threads`` a block,
    ``words_per_lane`` (the slot words whose counts a lane's run holds),
    ``registers`` a thread and ``spill_bytes`` (local memory a thread)."""
    from . import _build
    fn = _build.load("board_pair_chunk").fce_board_pair_shape
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    err = fn(n_cells, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"board_pair_chunk shape query failed: CUDA "
                           f"error {err}")
    return dict(chain_bytes=out[0], chains_per_block=out[1],
                blocks_per_sm=out[2], threads=out[3], words_per_lane=out[4],
                registers=out[5], spill_bytes=out[6])


def _launch(lib, bg: BoardGraph, static: PairBoardStatic, spec: Spec,
            t_inner: int, board, key, dist_pop, scal, ints, flips,
            recounts):
    c, n = board.shape
    k = static.labels.numel()
    dev = board.device
    i32, f32 = torch.int32, torch.float32

    def rows(dtype):
        return torch.empty((t_inner, c), dtype=dtype, device=dev)

    outs = (torch.empty((c, n), dtype=torch.int8, device=dev),
            torch.empty((2, c), dtype=i32, device=dev),
            torch.empty((k, c), dtype=i32, device=dev),
            torch.empty((2, c), dtype=f32, device=dev),
            torch.empty((8, c), dtype=i32, device=dev),
            rows(i32), rows(i32), rows(f32), rows(i32),
            torch.empty((2, c, n), dtype=i32, device=dev))
    if flips is not None:
        outs += tuple(torch.empty((c, n), dtype=i32, device=dev)
                      for _ in range(3))
    flip_ptrs = ([x.data_ptr() for x in flips] if flips is not None
                 else [None] * 3)
    ptrs = ([x.data_ptr() for x in (board, key, dist_pop, scal, ints,
                                    static.labels)]
            + flip_ptrs + [x.data_ptr() for x in outs[:10]]
            + ([x.data_ptr() for x in outs[10:]] if flips is not None
               else [None] * 3)
            + [None if recounts is None else recounts.data_ptr()])
    with torch.cuda.device(dev):
        err = _entry(lib)(
            *ptrs, c, bg.h, bg.w, k, t_inner,
            int(spec.contiguity == "patch"), int(spec.geom_waits),
            int(spec.accept == "always"), static.unit_pop,
            int(flips is not None), static.denom,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"board_pair_chunk launch failed: CUDA error "
                           f"{err}")
    return outs


def run_board_pair_chunk_cuda(bg: BoardGraph, static: PairBoardStatic,
                              spec: Spec, t_inner: int, board, key,
                              dist_pop, scal, ints, flips=None, *,
                              recounts=None):
    """One chunk for all chains (module docstring for the layout);
    ``flips`` (part_sum, last_flipped, num_flips) under ``parity_metrics``
    and only then. A CUDA board launches the kernel; a CPU board runs the
    plain version. ``recounts``, an int32 (C,) CUDA tensor, receives each
    chain's count of full recounts of its valid slots after accepted moves
    (the kernel's own bookkeeping; the plain version has none).
    ``run_board_pair_chunk_cuda.launches`` counts kernel launches."""
    _check_inputs(bg, static, spec, t_inner, board, key, dist_pop, scal,
                  ints, flips, recounts)
    args = (bg, static, spec, t_inner, board, key, dist_pop, scal, ints,
            flips)
    if board.device.type == "cuda":
        from . import _build
        out = _launch(_build.load("board_pair_chunk"), *args, recounts)
        run_board_pair_chunk_cuda.launches += 1
        return out
    if board.device.type == "cpu":
        return board_pair_chunk_reference(*args)
    raise ValueError(f"no board pair chunk path for device {board.device}")


run_board_pair_chunk_cuda.launches = 0


def chunk_rows(outs) -> dict:
    """The rows ``run_chunk`` returns, {name: (T, C)}, from a chunk's
    outputs."""
    return dict(zip(ROW_NAMES, outs[5:9]))


def run_chunk(bg: BoardGraph, spec: Spec, params: StepParams,
              state: BoardState, t_inner: int,
              static: PairBoardStatic | None = None, acc=None,
              keep_rows: bool = True):
    """``t_inner`` iterations of [split, complete wait, record, transition]
    on the pair body, with part_sum / last_flipped / num_flips advanced by
    the chunk's flip log under ``parity_metrics``: the JAX package's
    ``run_board_chunk`` on this body. Returns (state, rows), rows {name:
    (T, C) tensor} with cut_count, b_count, wait and accepts. With ``acc`` (a ``SummaryAcc``)
    the rows are also folded into it by the standalone fold and the
    return is (state, rows, acc); ``keep_rows=False`` besides returns no
    rows."""
    if static is None:
        static = make_static_inputs(bg, spec, params)
    if acc is None and not keep_rows:
        raise ValueError("keep_rows=False drops the rows: pass an "
                         "accumulator")
    key, dist_pop, scal, ints = pack_state(state, params)
    flips = ((state.part_sum, state.last_flipped, state.num_flips)
             if spec.parity_metrics else None)
    outs = run_board_pair_chunk_cuda(bg, static, spec, t_inner, state.board,
                                     key, dist_pop, scal, ints, flips)
    state = unpack_state(state, outs, t_inner)
    rows = chunk_rows(outs)
    if acc is None:
        return state, rows
    acc = cuda_summary.summary_fold(acc, rows)
    return state, (rows if keep_rows else {}), acc
