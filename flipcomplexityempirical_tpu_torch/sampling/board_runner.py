"""Initialisation and epilogue of the board-path runners.

Port of ``init_board``, ``drain_waits``, ``_sum_pending`` and
``finalize_board_run`` from
``flipcomplexityempirical_tpu/sampling/board_runner.py`` (without the
observability and analytics hooks, which this package has not ported).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.lattice import LatticeGraph
from ..kernel import board as kboard
from ..kernel import step as kstep
from ..kernel.step import Spec
from .runner import RunResult, assemble_history, default_label_values, \
    pop_bounds


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
                       pending_waits, record_history, n_steps) -> RunResult:
    """Record the final yield (no trailing transition), drain waits and
    assemble the RunResult."""
    state, out_last = kboard.record_final(bg, spec, params, state)
    if record_history:
        for k, v in out_last.items():
            hist_parts.setdefault(k, []).append(v.cpu().numpy()[:, None])
    state = drain_waits(state, pending_waits)
    waits_total = _sum_pending(waits_total, pending_waits)
    history = assemble_history(hist_parts, record_history)
    return RunResult(state=state, history=history, waits_total=waits_total,
                     n_yields=n_steps)
