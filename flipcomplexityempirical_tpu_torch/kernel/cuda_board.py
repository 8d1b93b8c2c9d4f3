"""The board-chunk kernel: its wrapper, its plain version, its contract.

``run_board_chunk_cuda`` runs ``t_inner`` steps of the 2-district flip
chain for every chain of a rook-grid batch. On a CUDA tensor it launches
the hand-written kernel of ``csrc/board_chunk.cu`` (built on first use by
``_build``; one warp per chain, the board bit-packed); on a CPU tensor it
runs ``board_chunk_reference``, a transparent per-step PyTorch replay of
the same semantics. Both take and return the (k, C) / (T, C) layout of
the JAX package's ``pallas_board.run_pallas_chunk``, whose TPU kernel
this one replaces:

    inputs:  board (C, N) int8, pop and deg (N,) int32, dist_pop (2, C)
             int32, scalars (5, C) f32 [log_base, beta, pop_lo, pop_hi,
             cur_wait], counters (7, C) int32 [pending, cur_flip,
             cur_sign, t_yield, move_clock, accepts, exhausted], and in
             host-bits mode bits (T, C, N) and (T, 2, C) int32 bit
             patterns of uint32 draws; the board holds 0 / 1 and deg is
             the grid's rook degree (``make_static_inputs`` checks it);
    outputs: board (C, N) int8, dist_pop (2, C), scalars (2, C) f32
             [cur_wait, waits_sum], counters (7, C), six (T, C) rows
             [log_f, log_s, cut, b, wait (f32), accepts], and the chunk's
             cut_e / cut_s counts (C, N) int32.

Without host bits the draws come from Philox4x32-10 with key (seed,
chain) and counter (cell // 4, step, chunk, stream); ``rng.philox_plane``
and ``rng.philox_scalars`` reproduce them, so the plain version matches
the kernel bit for bit in that mode too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import rng
from .board import (BoardGraph, BoardState, board_shape, recount_cuts,
                    ring_contig_ok)
from .board import supports as _board_supports
from .step import Spec, StepParams, geom_wait

# board bound: 512 words of 32 cells, 16 words a lane
MAX_CELLS = 16384

_U01_SCALE = 1.0 / 16777218.0


def supports(graph, spec: Spec, params: StepParams) -> bool:
    """The kernel serves plain rook grids under the 2-district 'bi' walk
    with the cut-Metropolis accept and the reference +1/-1 labels."""
    lv = params.label_values.cpu().numpy()
    return (board_shape(graph) is not None
            and _board_supports(graph, spec)
            and not spec.record_interface
            and spec.accept == "cut"
            and spec.anneal == "none"
            and lv.shape == (2,) and lv[0] == 1 and lv[1] == -1)


def check(spec: Spec, params: StepParams) -> None:
    """Raise unless the kernel reproduces the requested semantics."""
    if spec.n_districts != 2 or spec.proposal != "bi":
        raise ValueError("the board-chunk kernel requires the 2-district "
                         f"'bi' proposal, got k={spec.n_districts} "
                         f"proposal={spec.proposal!r}")
    if spec.accept != "cut":
        raise ValueError(f"the board-chunk kernel requires accept='cut', "
                         f"got {spec.accept!r}")
    if spec.anneal != "none":
        raise ValueError(f"the board-chunk kernel requires anneal='none', "
                         f"got {spec.anneal!r}")
    if spec.contiguity not in ("patch", "none"):
        raise ValueError(f"contiguity {spec.contiguity!r} not supported")
    if spec.record_interface:
        raise ValueError("record_interface runs on the lowered body "
                         "(sampling.run_board), not the board-chunk kernel")
    lv = params.label_values.cpu().numpy()
    if lv.shape != (2,) or lv[0] != 1 or lv[1] != -1:
        raise ValueError(f"the board-chunk kernel requires label_values "
                         f"[1, -1], got {lv.tolist()}")


def make_static_inputs(bg: BoardGraph):
    """(pop, deg) (N,) int32 planes, made once a run. The kernel derives
    the neighbour masks and the degree from (h, w) itself: its boundary
    test is the OR of the rook "differ" planes, which is deg - same_deg > 0
    for the grid's rook degree only, so any other deg plane is refused."""
    if not torch.equal(bg.deg, rook_degree(bg.h, bg.w, bg.deg.device)):
        raise ValueError("deg must be the grid's rook degree")
    return bg.pop.contiguous(), bg.deg.contiguous()


def pack_state(state: BoardState, params: StepParams):
    """BoardState + params -> (dist_pop (2, C) int32, scalars (5, C) f32,
    counters (7, C) int32)."""
    f32, i32 = torch.float32, torch.int32
    dist_pop = state.dist_pop.T.contiguous()
    scal = torch.stack([params.log_base.to(f32), params.beta.to(f32),
                        params.pop_lo.to(f32), params.pop_hi.to(f32),
                        state.cur_wait.to(f32)])
    ints = torch.stack([state.wait_pending.to(i32), state.cur_flip.to(i32),
                        state.cur_sign.to(i32), state.t_yield.to(i32),
                        state.move_clock.to(i32), state.accept_count.to(i32),
                        state.exhausted_count.to(i32)])
    return dist_pop, scal, ints


def unpack_state(state: BoardState, bg: BoardGraph, outs,
                 t_inner: int) -> BoardState:
    """Merge chunk outputs back into a BoardState (tries_sum counts one
    draw per yield, as the board path does)."""
    (board, dist_pop, scal, ints, _lf, _ls, _hc, _hb, _hw, _ha,
     cut_e, cut_s) = outs
    return state.replace(
        board=board,
        dist_pop=dist_pop.T.contiguous(),
        # h_cut[-1] is the last record's pre-transition value: recount
        cut_count=recount_cuts(bg, board),
        cur_wait=scal[0],
        wait_pending=ints[0] > 0,
        cur_flip=ints[1],
        cur_sign=ints[2],
        t_yield=ints[3],
        move_clock=ints[4],
        accept_count=ints[5],
        exhausted_count=ints[6],
        waits_sum=state.waits_sum + scal[1],
        tries_sum=state.tries_sum + t_inner,
        cut_times_e=state.cut_times_e + cut_e,
        cut_times_s=state.cut_times_s + cut_s)


def bits_tensor(bits, device) -> torch.Tensor:
    """uint32 draws (a numpy array, or an int32/int64 tensor) as the
    int32 bit-pattern tensor the chunk takes."""
    if isinstance(bits, np.ndarray):
        return torch.from_numpy(
            np.ascontiguousarray(bits, np.uint32).view(np.int32)).to(device)
    if bits.dtype == torch.int64:
        bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(device=device, dtype=torch.int32).contiguous()


def _u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (held in int64) -> f32 uniform in (0, 1): (top 24 bits + 1)
    / 16777218, in f32 as the kernel computes it."""
    scale = torch.tensor(_U01_SCALE, dtype=torch.float32, device=bits.device)
    return ((bits >> 8).to(torch.float32) + 1.0) * scale


def _neighbour_masks(h: int, w: int, device):
    i = torch.arange(h * w, device=device)
    x, y = i // w, i % w
    e, wk, s, nn = y < w - 1, y > 0, x < h - 1, x > 0
    return dict(e=e, w=wk, s=s, n=nn, se=s & e, sw=s & wk, ne=nn & e,
                nw=nn & wk)


def board_chunk_reference(spec: Spec, h: int, w: int, t_inner: int,
                          seed: int, chunk_idx: int, board, pop_plane,
                          deg_plane, dist_pop, scal, ints, bits_plane=None,
                          bits_scal=None):
    """The plain version of the kernel: a per-step PyTorch replay of
    ``pallas_board._kernel``'s semantics on (C, N) tensors, with the
    kernel's inputs and outputs (module docstring). Bit arithmetic and the
    score run in int64, because torch's uint32 support is thin."""
    c, n = board.shape
    dev = board.device
    f32, i64 = torch.float32, torch.int64
    host = bits_plane is not None
    b = board.to(i64)
    m = _neighbour_masks(h, w, dev)
    pop = pop_plane.to(i64)
    deg = deg_plane.to(i64)
    popn = pop.to(f32)
    log_base, beta, pop_lo, pop_hi, cur_wait = (scal[k] for k in range(5))
    dp0, dp1 = dist_pop[0].to(i64), dist_pop[1].to(i64)
    (pending, cur_flip, cur_sign, tyield, move_clock, acc_cnt,
     exh_cnt) = (ints[k].to(i64) for k in range(7))
    waits_sum = torch.zeros(c, dtype=f32, device=dev)
    tiny = torch.tensor(1e-12, dtype=f32, device=dev)
    rows = {k: torch.empty((t_inner, c), dtype=torch.int32, device=dev)
            for k in ("log_f", "log_s", "cut", "b", "acc")}
    h_wait = torch.empty((t_inner, c), dtype=f32, device=dev)
    cut_e_acc = torch.zeros((c, n), dtype=torch.int32, device=dev)
    cut_s_acc = torch.zeros((c, n), dtype=torch.int32, device=dev)
    ar = torch.arange(c, device=dev)
    pad = w + 1

    for t in range(t_inner):
        p = torch.nn.functional.pad(b, (pad, pad), value=-1)

        def same(o, mask):
            return mask & (p[:, pad + o: pad + o + n] == b)

        s_e, s_w = same(1, m["e"]), same(-1, m["w"])
        s_s, s_n = same(w, m["s"]), same(-w, m["n"])
        s_se, s_sw = same(w + 1, m["se"]), same(w - 1, m["sw"])
        s_ne, s_nw = same(-w + 1, m["ne"]), same(-w - 1, m["nw"])
        same_deg = (s_e.to(i64) + s_w.to(i64) + s_s.to(i64) + s_n.to(i64))
        diff_deg = deg - same_deg
        b_mask = diff_deg > 0
        cut_e = m["e"] & ~s_e
        cut_s = m["s"] & ~s_s
        if spec.contiguity == "patch":
            contig = ring_contig_ok([s_e, s_se, s_s, s_sw, s_w, s_nw, s_n,
                                     s_ne])
        else:
            contig = torch.ones_like(b_mask)
        is1 = b == 1
        pop_of = torch.where(is1, dp1[:, None], dp0[:, None]).to(f32)
        pop_to = torch.where(is1, dp0[:, None], dp1[:, None]).to(f32)
        pop_ok = ((pop_of - popn >= pop_lo[:, None])
                  & (pop_to + popn <= pop_hi[:, None]))
        valid = b_mask & contig & pop_ok
        b_count = b_mask.sum(dim=1)
        cut_count = cut_e.sum(dim=1) + cut_s.sum(dim=1)

        if host:
            plane = bits_plane[t].to(i64) & rng.MASK32
            sbits = bits_scal[t].to(i64) & rng.MASK32
            wbits, abits = sbits[0], sbits[1]
        else:
            plane = rng.philox_plane(seed, chunk_idx, t, c, n, dev)
            sbits = rng.philox_scalars(seed, chunk_idx, t, c, dev)
            wbits, abits = sbits[:, 0], sbits[:, 1]

        # complete the pending wait from this state's boundary count
        if spec.geom_waits:
            wnew = geom_wait(_u01(wbits), b_count, n, 2)
            cur_wait = torch.where(pending != 0, wnew, cur_wait)

        # record yield t
        rows["cut"][t] = cut_count
        rows["b"][t] = b_count
        h_wait[t] = cur_wait
        rows["acc"][t] = acc_cnt
        rows["log_f"][t] = cur_flip
        rows["log_s"][t] = cur_sign
        cut_e_acc += cut_e
        cut_s_acc += cut_s
        waits_sum = waits_sum + cur_wait
        tyield = tyield + 1

        # propose: argmax of (bits | 1) over the valid set, first index
        score = torch.where(valid, plane | 1, 0)
        idx = torch.argmax(score, dim=1)
        any_valid = score[ar, idx] > 0
        d_from = b[ar, idx]
        dcut = deg[idx] - 2 * diff_deg[ar, idx]
        log_bound = -beta * dcut.to(f32) * log_base
        logu = torch.log(torch.maximum(_u01(abits), tiny))
        accept = any_valid & (logu < log_bound)

        # commit
        d_to = 1 - d_from
        b[ar, idx] = torch.where(accept, d_to, d_from)
        popv = torch.where(accept, pop[idx], 0)
        dp0 = dp0 + torch.where(d_from == 0, -popv, popv)
        dp1 = dp1 + torch.where(d_from == 0, popv, -popv)
        cur_flip = torch.where(accept, idx, cur_flip)
        cur_sign = torch.where(accept, 1 - 2 * d_to, cur_sign)
        acc_i = accept.to(i64)
        pending = acc_i
        move_clock = move_clock + acc_i
        acc_cnt = acc_cnt + acc_i
        exh_cnt = exh_cnt + (~any_valid).to(i64)

    i32 = torch.int32
    return (b.to(torch.int8),
            torch.stack([dp0, dp1]).to(i32),
            torch.stack([cur_wait, waits_sum]),
            torch.stack([pending, cur_flip, cur_sign, tyield, move_clock,
                         acc_cnt, exh_cnt]).to(i32),
            rows["log_f"], rows["log_s"], rows["cut"], rows["b"], h_wait,
            rows["acc"], cut_e_acc, cut_s_acc)


def rook_degree(h: int, w: int, device) -> torch.Tensor:
    """(N,) int32 rook degree of the h x w grid."""
    m = _neighbour_masks(h, w, device)
    return (m["e"].int() + m["w"].int() + m["s"].int()
            + m["n"].int()).to(torch.int32)


def _check_inputs(h, w, t_inner, board, pop_plane, deg_plane, dist_pop,
                  scal, ints, bits_plane, bits_scal) -> None:
    c, n = board.shape
    if n != h * w:
        raise ValueError(f"board has {n} cells, grid is {h}x{w}")
    if n > MAX_CELLS:
        raise ValueError(f"board of {n} cells exceeds the kernel's "
                         f"{MAX_CELLS}")
    if t_inner < 1:
        raise ValueError(f"t_inner {t_inner} < 1")
    want = [(board, (c, n), torch.int8), (pop_plane, (n,), torch.int32),
            (deg_plane, (n,), torch.int32), (dist_pop, (2, c), torch.int32),
            (scal, (5, c), torch.float32), (ints, (7, c), torch.int32)]
    if (bits_plane is None) != (bits_scal is None):
        raise ValueError("host bits need both bits_plane and bits_scal")
    if bits_plane is not None:
        want += [(bits_plane, (t_inner, c, n), torch.int32),
                 (bits_scal, (t_inner, 2, c), torch.int32)]
    for x, shape, dtype in want:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"expected {dtype} {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != board.device:
            raise ValueError(f"tensor on {x.device}, board on {board.device}")
        if not x.is_contiguous():
            raise ValueError("chunk inputs must be contiguous")


def _entry(lib, scratch: bool):
    """``lib``'s ``fce_board_chunk`` with its C signature declared: 20
    tensor pointers, the last-flip scratch pointer if ``scratch``, six
    ints, seed, chunk index and the stream."""
    fn = lib.fce_board_chunk
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * (20 + scratch)
                       + [ctypes.c_int] * 6
                       + [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _launch(lib, args, scratch: bool = True):
    """Launch ``lib``'s ``fce_board_chunk`` on the wrapper's ``args`` and
    return the outputs. ``scratch`` passes the last-flip plane, which the
    first version of the kernel's interface lacks (``chip_smoke.py
    --baseline`` times that version beside this one)."""
    (spec, h, w, t_inner, seed, chunk_idx, board, pop_plane, deg_plane,
     dist_pop, scal, ints, bits_plane, bits_scal) = args
    c, n = board.shape
    dev = board.device
    i32, f32 = torch.int32, torch.float32
    outs = (torch.empty((c, n), dtype=torch.int8, device=dev),
            torch.empty((2, c), dtype=i32, device=dev),
            torch.empty((2, c), dtype=f32, device=dev),
            torch.empty((7, c), dtype=i32, device=dev),
            *(torch.empty((t_inner, c), dtype=i32, device=dev)
              for _ in range(4)),
            torch.empty((t_inner, c), dtype=f32, device=dev),
            torch.empty((t_inner, c), dtype=i32, device=dev),
            torch.empty((c, n), dtype=i32, device=dev),
            torch.empty((c, n), dtype=i32, device=dev))
    (board_o, dp_o, scal_o, ints_o, log_f, log_s, h_cut, h_b, h_wait,
     h_acc, cut_e, cut_s) = outs
    ins = [board, pop_plane, deg_plane, dist_pop, scal, ints, bits_plane,
           bits_scal, board_o, dp_o, scal_o, ints_o, log_f, log_s, h_cut, h_b,
           h_wait, h_acc, cut_e, cut_s]
    if scratch:
        # last flip step of each cell, read by the kernel only where it
        # wrote it in this launch
        ins.append(torch.empty((c, n), dtype=i32, device=dev))
    ptr = [None if x is None else x.data_ptr() for x in ins]
    with torch.cuda.device(dev):
        err = _entry(lib, scratch)(
            *ptr, c, h, w, t_inner, int(spec.contiguity == "patch"),
            int(spec.geom_waits), seed & rng.MASK32,
            chunk_idx & rng.MASK32, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"board_chunk launch failed: CUDA error {err}")
    return outs


def run_board_chunk_cuda(spec: Spec, h: int, w: int, t_inner: int,
                         seed: int, chunk_idx: int, board, pop_plane,
                         deg_plane, dist_pop, scal, ints, bits_plane=None,
                         bits_scal=None):
    """One chunk for all chains (module docstring for the layout). A
    CUDA board launches the kernel; a CPU board runs the plain version.
    ``run_board_chunk_cuda.launches`` counts kernel launches."""
    _check_inputs(h, w, t_inner, board, pop_plane, deg_plane, dist_pop,
                  scal, ints, bits_plane, bits_scal)
    args = (spec, h, w, t_inner, seed, chunk_idx, board, pop_plane,
            deg_plane, dist_pop, scal, ints, bits_plane, bits_scal)
    if board.device.type == "cuda":
        from . import _build
        outs = _launch(_build.load("board_chunk"), args)
        run_board_chunk_cuda.launches += 1
        return outs
    if board.device.type == "cpu":
        return board_chunk_reference(*args)
    raise ValueError(f"no board-chunk path for device {board.device}")


run_board_chunk_cuda.launches = 0
