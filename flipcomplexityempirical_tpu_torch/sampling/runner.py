"""Run results and the helpers shared by the runners.

Port of ``RunResult``, ``pick_chunk``, ``snap_chunk_to``, ``pop_bounds``,
``default_label_values``, ``maybe_host`` and ``assemble_history`` from
``flipcomplexityempirical_tpu/sampling/runner.py``. Long-horizon wait sums
accumulate on the host in float64 from per-chunk float32 partial sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import to_numpy
from ..graphs.lattice import LatticeGraph


@dataclasses.dataclass
class RunResult:
    state: object                # batched final state (on the run's device)
    history: dict                # name -> (C, T) np.ndarray when recorded
                                 # (a tensor on the run's device under
                                 # ``history_device``)
    waits_total: np.ndarray      # float64 (C,) host-accumulated sum of waits
    n_yields: int

    def host_state(self) -> dict:
        """The final state's fields as numpy arrays."""
        return to_numpy(self.state)


def pick_chunk(n_steps: int, cap: int) -> int:
    """Default chunk length: at most ``cap``, snapped to a nearby divisor
    of the transition count so every chunk has one length."""
    chunk = max(1, min(n_steps - 1, cap))
    total = n_steps - 1
    for d in range(chunk, max(chunk // 2, 1) - 1, -1):
        if total % d == 0:
            return d
    return chunk


def snap_chunk_to(chunk: int, every: int) -> int:
    """Largest multiple of ``every`` <= chunk (at least ``every``): full
    chunks hold a whole number of record periods, so every chunk boundary
    lands on the thinned grid."""
    return max(every, chunk - chunk % every)


def pop_bounds(graph: LatticeGraph, k: int, tol: float):
    """within_percent_of_ideal_population semantics
    (grid_chain_sec11.py:319): inclusive bounds around the ideal."""
    ideal = float(graph.pop.sum()) / k
    return (1.0 - tol) * ideal, (1.0 + tol) * ideal


def default_label_values(k: int):
    """The reference's district labels: +1/-1 for 2 districts, plain
    indices otherwise."""
    return [1, -1] if k == 2 else list(range(k))


def maybe_host(outs: dict, history_device: bool) -> dict:
    """A chunk's history block copied to the host as numpy arrays (each
    copy synchronises), or left as tensors on the run's device when the
    history is to stay there."""
    if history_device:
        return outs
    return {k: v.cpu().numpy() for k, v in outs.items()}


def assemble_history(hist_parts: dict, record_history: bool,
                     history_device: bool = False) -> dict:
    """Concatenate per-chunk (C, t) history parts along T: tensors on the
    run's device under ``history_device``, numpy arrays otherwise."""
    if not (record_history and hist_parts):
        return {}
    if history_device:
        return {k: torch.cat(v, dim=1) for k, v in hist_parts.items()}
    return {k: np.concatenate(v, axis=1) for k, v in hist_parts.items()}
