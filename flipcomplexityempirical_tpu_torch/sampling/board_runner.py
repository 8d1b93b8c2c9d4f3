"""The board-path runners' initialisation and epilogue, and the runner of
the lowered-chunk kernel.

Port of ``init_board``, ``drain_waits``, ``_sum_pending``,
``finalize_board_run``, ``run_board_segment`` and ``run_board`` from
``flipcomplexityempirical_tpu/sampling/board_runner.py``, with the device
analytics (``analytics=``, a ``stats.accumulators.DeviceAnalytics``: each
chunk's records folded inside the chunk kernel, the final record by
``kernel.cuda_summary.summary_fold``) and without the observability and
degradation hooks, which this package has not ported. Which graphs take
which kernel:

- ``run_board_segment`` / ``run_board`` run every chunk on the
  lowered-chunk kernel (``kernel/cuda_lowered.py``,
  ``csrc/lowered_chunk.cu``): the surgical canvases (sec11, the
  Frankengraph, queen grids), every ``record_interface`` spec, and plain
  rook grids of height and width at least 3 and at most
  ``cuda_lowered.MAX_CELLS`` cells. The kernel draws the JAX package's
  threefry stream, so a run equals the JAX package's ``run_board`` draw
  for draw: its ``lowered_bits`` body on the lowered workloads, its rook
  bodies (``bitboard``, the packed ``_scan_bits``, or ``board``) on a
  plain grid (``kernel.cuda_lowered.body_for`` names the one);
- under the k-district 'pair' proposal the same runners run every chunk
  on the board pair kernel (``kernel/cuda_board_pair.py``,
  ``csrc/board_pair_chunk.cu``), equal to the JAX package's pair bodies
  (``_scan_bits_pair`` and its int8 form) draw for draw; in summary mode
  its rows are folded by the standalone fold (``csrc/summary_fold.cu``);
- ``cuda_runner.run_board_cuda`` runs a plain rook grid through the
  board-chunk kernel (``csrc/board_chunk.cu``, the Pallas kernel's twin)
  on the port's own Philox stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import check_on, resolve_device
from ..graphs.lattice import LatticeGraph
from ..kernel import board as kboard
from ..kernel import cuda_board_pair as cbpair
from ..kernel import cuda_lowered as clow
from ..kernel import cuda_summary
from ..kernel import step as kstep
from ..kernel.step import Spec
from .runner import (RunResult, assemble_history, default_label_values,
                     maybe_host, pick_chunk, pop_bounds, snap_chunk_to)


def chunk_module(spec: Spec):
    """The chunk kernel's wrapper module of ``spec``'s body: the board pair
    kernel (``kernel/cuda_board_pair.py``) for the k-district pair walk,
    the lowered-chunk kernel (``kernel/cuda_lowered.py``) for the
    2-district walk."""
    return cbpair if kboard.is_pair(spec) else clow


def init_board(graph: LatticeGraph, assignment: np.ndarray, n_chains: int,
               seed: int, spec: Spec, base: float, pop_tol: float,
               label_values=None, beta=1.0, device="cuda"):
    """Build (BoardGraph, BoardState, StepParams) on ``device``."""
    dev = resolve_device(device)
    if not kboard.supports(graph, spec):
        raise ValueError(
            f"board path does not support (graph={graph.name!r}, {spec})")
    if label_values is None:
        label_values = default_label_values(spec.n_districts)
    lo, hi = pop_bounds(graph, spec.n_districts, pop_tol)
    params = kstep.make_params(base, lo, hi, label_values, beta=beta,
                               n_chains=n_chains, device=dev)
    bg = kboard.make_board_graph(graph, device=dev)
    state = kboard.init_board_state(graph, bg, assignment, n_chains, seed,
                                    spec, params)
    return bg, state, params


def drain_waits(state, pending_waits: list):
    """Stash the chunk-local f32 wait sum (a device tensor, no sync) and
    zero it; the stash is summed in float64 on the host at run end."""
    pending_waits.append(state.waits_sum)
    return state.replace(waits_sum=torch.zeros_like(state.waits_sum))


def _sum_pending(waits_total: np.ndarray, pending_waits: list) -> np.ndarray:
    for w in pending_waits:
        waits_total += w.cpu().numpy().astype(np.float64)
    return waits_total


def finalize_board_run(bg, spec, params, state, hist_parts, waits_total,
                       pending_waits, record_history, n_steps,
                       record_every: int = 1,
                       history_device: bool = False,
                       analytics=None) -> RunResult:
    """Record the final yield (no trailing transition), drain waits and
    assemble the RunResult. Under thinning the final yield joins the
    history only when it lands on the record grid. ``history_device``
    keeps the history as tensors on the run's device (``hist_parts``
    then holds tensors too) instead of numpy arrays. ``analytics`` folds
    the final yield as it would join the history (one fold launch)."""
    state, out_last = kboard.record_final(bg, spec, params, state)
    if analytics is not None:
        analytics.update(cuda_summary.summary_fold(
            analytics.acc, {k: v[None] for k, v in out_last.items()}), 1)
    if record_history and (n_steps - 1) % record_every == 0:
        for k, v in maybe_host(out_last, history_device).items():
            hist_parts.setdefault(k, []).append(v[:, None])
    state = drain_waits(state, pending_waits)
    waits_total = _sum_pending(waits_total, pending_waits)
    history = assemble_history(hist_parts, record_history, history_device)
    return RunResult(state=state, history=history, waits_total=waits_total,
                     n_yields=n_steps)


def run_board_segment(bg: kboard.BoardGraph, spec: Spec,
                      params: kstep.StepParams, state: kboard.BoardState,
                      n_transitions: int, record_history: bool = True,
                      chunk: Optional[int] = None,
                      bits: Optional[bool] = None, record_every: int = 1,
                      history_device: bool = False,
                      device="cuda", analytics=None) -> RunResult:
    """Advance ``n_transitions`` transitions of the batched chain on
    ``device``, where the state must already live, recording the same
    number of yields (each before its transition) and no trailing
    record, so segments compose without duplicate boundary yields: a
    full run is segments summing to ``n_steps - 1`` transitions plus one
    ``kboard.record_final`` (``run_board``), and the experiment driver
    checkpoints between segments. Per chunk: the lowered-chunk kernel
    (its plain version on the CPU), the flip-log replay and, unless
    ``history_device``, the history's copy to the host.
    ``record_every=k`` keeps yields 0, k, 2k, ... of the segment; every
    accumulator still advances every step. ``bits`` is the JAX
    signature's body choice: None or True run the body ``body_for``
    names, False (the JAX package's int8 bodies) raises.
    ``history_device=True`` returns the history as tensors on the run's
    device, (C, T_recorded) per key, copied nowhere. ``analytics`` (a
    ``stats.accumulators.DeviceAnalytics`` on the run's device) folds
    each chunk's records, every step whatever ``record_every``, inside
    the chunk's launch and with no host sync; pass
    ``record_history=False`` for summary mode, where no history is kept
    and the kernel writes no row that only the fold reads. The chains
    draw the JAX package's threefry stream, so a run equals the JAX
    package's draw for draw."""
    dev = resolve_device(device)
    check_on(dev, state.board, bg.pop, params.log_base)
    kern = chunk_module(spec)
    kern.body_for(bg, spec, bits)
    if record_every < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    static = kern.make_static_inputs(bg, spec, params)
    if chunk is None:
        chunk = pick_chunk(n_transitions + 1, 512)
    if record_every > 1:
        chunk = snap_chunk_to(chunk, record_every)

    hist_parts: dict = {}
    waits_total = state.waits_sum.cpu().numpy().astype(np.float64)
    state = state.replace(waits_sum=torch.zeros_like(state.waits_sum))
    pending_waits: list = []
    done = 0
    while done < n_transitions:
        this = min(chunk, n_transitions - done)
        if analytics is None:
            state, rows = kern.run_chunk(bg, spec, params, state, this,
                                         static)
        else:
            state, rows, acc = kern.run_chunk(
                bg, spec, params, state, this, static, acc=analytics.acc,
                keep_rows=record_history)
            analytics.update(acc, this)
        if record_history:
            # records precede their transitions: row 0 is on the grid
            rows = maybe_host({k: v[::record_every] for k, v in rows.items()},
                              history_device)
            for k, v in rows.items():
                hist_parts.setdefault(k, []).append(v.T)
        state = drain_waits(state, pending_waits)
        done += this
    waits_total = _sum_pending(waits_total, pending_waits)
    return RunResult(state=state,
                     history=assemble_history(hist_parts, record_history,
                                              history_device),
                     waits_total=waits_total, n_yields=n_transitions)


def run_board(bg: kboard.BoardGraph, spec: Spec, params: kstep.StepParams,
              state: kboard.BoardState, n_steps: int,
              record_history: bool = True, chunk: Optional[int] = None,
              bits: Optional[bool] = None, record_every: int = 1,
              history_device: bool = False, device="cuda",
              analytics=None) -> RunResult:
    """Run the batched chain for ``n_steps`` yields (yield 0 is the
    initial state): one ``run_board_segment`` of ``n_steps - 1``
    transitions, then the final record (``finalize_board_run``);
    ``history_device`` and ``analytics`` as there (the chunks fold
    their own records; the final record takes one ``summary_fold``
    launch)."""
    seg = run_board_segment(bg, spec, params, state, n_steps - 1,
                            record_history=record_history, chunk=chunk,
                            bits=bits, record_every=record_every,
                            history_device=history_device, device=device,
                            analytics=analytics)
    hist_parts = {k: [v] for k, v in seg.history.items()}
    return finalize_board_run(bg, spec, params, seg.state, hist_parts,
                              seg.waits_total, [], record_history, n_steps,
                              record_every, history_device=history_device,
                              analytics=analytics)
