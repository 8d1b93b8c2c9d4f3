"""Runner for the board-chunk kernel: chunked on-chip execution.

Port of ``flipcomplexityempirical_tpu/sampling/pallas_runner.py``. Same
contract as the JAX package's board runners (RunResult, history keys,
float64 wait accumulation, the record-final epilogue): per chunk the
kernel returns its flip log and int32 cut planes, and the plain PyTorch
pieces (``kernel.board.apply_flip_log``, ``kernel.board.record_final``)
finish the bookkeeping.

Random streams: without ``_host_bits`` the kernel draws Philox4x32-10
bits keyed by (seed, chain) with the chunk index in the counter. That is
this package's own stream: the JAX package seeds its TPU kernel per
(block, chunk) through ``np.random.SeedSequence`` and the TPU's own
generator, which has no twin here, so runs of the two packages agree in
distribution, not draw for draw. With ``_host_bits`` both packages read
the same caller-supplied bits and agree draw for draw.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import check_on, resolve_device
from ..kernel import board as kboard
from ..kernel import cuda_board as cboard
from ..kernel.step import Spec, StepParams
from .board_runner import drain_waits, finalize_board_run
from .runner import RunResult, pick_chunk


def run_board_cuda(bg: kboard.BoardGraph, spec: Spec, params: StepParams,
                   state: kboard.BoardState, n_steps: int,
                   record_history: bool = True,
                   chunk: Optional[int] = None, seed: int = 0,
                   device="cuda", _host_bits=None) -> RunResult:
    """Run ``n_steps`` yields through the board-chunk kernel on
    ``device`` (the state must already live there); ``seed`` keys the
    kernel's Philox streams.

    ``_host_bits(chunk_idx, t, c, n) -> (bits_plane, bits_scal)`` replaces
    the kernel's generator with caller-supplied uint32 draws of shapes
    (t, c, n) and (t, 2, c), as numpy arrays or tensors."""
    dev = resolve_device(device)
    check_on(dev, state.board, bg.pop, params.log_base)
    c = state.board.shape[0]
    cboard.check(spec, params)
    if chunk is None:
        chunk = pick_chunk(n_steps, 512)
    n = bg.n
    pop_plane, deg_plane = cboard.make_static_inputs(bg)

    hist_parts: dict = {}
    waits_total = state.waits_sum.cpu().numpy().astype(np.float64)
    state = state.replace(waits_sum=torch.zeros_like(state.waits_sum))
    pending_waits: list = []

    done = 0
    chunk_idx = 0
    transitions = n_steps - 1
    while done < transitions:
        this = min(chunk, transitions - done)
        dist_pop, scal, ints = cboard.pack_state(state, params)
        t0 = state.t_yield
        bits_plane = bits_scal = None
        if _host_bits is not None:
            bp, bs = _host_bits(chunk_idx, this, c, n)
            bits_plane = cboard.bits_tensor(bp, state.board.device)
            bits_scal = cboard.bits_tensor(bs, state.board.device)
        outs = cboard.run_board_chunk_cuda(
            spec, bg.h, bg.w, this, seed, chunk_idx, state.board,
            pop_plane, deg_plane, dist_pop, scal, ints, bits_plane,
            bits_scal)
        state = cboard.unpack_state(state, bg, outs, this)
        if spec.parity_metrics:
            ps, lf, nf = kboard.apply_flip_log(
                state.part_sum, state.last_flipped, state.num_flips,
                outs[4], outs[5], t0)
            state = state.replace(part_sum=ps, last_flipped=lf,
                                  num_flips=nf)
        if record_history:
            for k, v in zip(("cut_count", "b_count", "wait", "accepts"),
                            outs[6:10]):
                hist_parts.setdefault(k, []).append(v.cpu().numpy().T)
        state = drain_waits(state, pending_waits)
        done += this
        chunk_idx += 1

    return finalize_board_run(bg, spec, params, state, hist_parts,
                              waits_total, pending_waits, record_history,
                              n_steps)
