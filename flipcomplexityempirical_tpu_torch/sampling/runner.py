"""Run results, the helpers shared by the runners, and the general runner.

Port of ``flipcomplexityempirical_tpu/sampling/runner.py``: ``RunResult``,
``pick_chunk``, ``snap_chunk_to``, ``pop_bounds``,
``default_label_values``, ``maybe_host``, ``assemble_history``,
``thin_outs``, and the general path's ``init_batch`` and ``run_chains``
with the device analytics (``analytics=``; without the obs recorder and
the degradation ladder, which this package has not ported). Long-horizon
wait sums accumulate on the host in float64 from per-chunk float32
partial sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from ..convert import to_numpy
from ..device import resolve_device
from ..graphs.lattice import LatticeGraph
from ..kernel import cuda_dense, cuda_pair, cuda_summary, dense
from ..kernel import step as kstep
from ..state.chain_state import init_state


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


# ---------------------------------------------------------------------------
# The general runner: ChainState batches on the legacy or the dense body
# ---------------------------------------------------------------------------

def init_batch(graph: LatticeGraph, assignment: np.ndarray, n_chains: int,
               seed: int, spec, base: float, pop_tol: float,
               label_values=None, beta=1.0, device="cuda") -> tuple:
    """(DeviceGraph, batched ChainState, StepParams) on ``device``: the
    chains' keys are ``split(PRNGKey(seed), n_chains)`` and each chain
    starts as ``init_state`` does, its initial wait drawn."""
    dev = resolve_device(device)
    dg = graph.device(dev)
    k = spec.n_districts
    if label_values is None:
        label_values = default_label_values(k)
    lo, hi = pop_bounds(graph, k, pop_tol)
    params = kstep.make_params(base, lo, hi, label_values, beta=beta,
                               n_chains=n_chains, device=dev)
    keys = rng.split(rng.prng_key(seed, device=dev), n_chains)
    siw = None
    if spec.geom_waits:
        def siw(kw, b):
            return kstep.sample_geom_minus1(kw, b, graph.n_nodes, k)
    a0 = torch.as_tensor(np.asarray(assignment, np.int8), device=dev)
    states = init_state(dg, a0, k, keys, params.label_values,
                        sample_initial_wait=siw, proposal=spec.proposal)
    return dg, states, params


def thin_outs(outs: dict, every: int, offset=None) -> dict:
    """Stride a chunk's (T, C) history block before it leaves the device:
    rows offset, offset + every, ... (offset ``every - 1`` by default, so
    record-after-transition chunks land on the grid 0, every, 2 every ...
    shared with the initial record)."""
    if every == 1:
        return outs
    if offset is None:
        offset = every - 1
    return {k: v[offset::every] for k, v in outs.items()}


def _run_chunk(dg, spec, params, states, chunk: int, path: str,
               static=None, acc=None, keep_rows: bool = True):
    """``chunk`` rounds of transition and record: (states, {name: (T, C)},
    ``acc`` with the chunk's records folded in, or None).
    ``general_dense`` on the card is a kernel (``static`` its tables): the
    2-district one folds its own records, the pair walk's rows go to the
    standalone ``summary_fold`` launch; elsewhere the bodies run as torch
    ops (``kernel/dense.py``, ``kernel/step.py``) and their rows go to
    ``summary_fold`` (the legacy body has no kernel yet, ROADMAP B9)."""
    if isinstance(static, cuda_pair.PairStatic):
        states, outs = cuda_pair.run_general_pair_chunk_cuda(
            dg, static, spec, params, states, chunk)
        if acc is not None:
            acc = cuda_summary.summary_fold(acc, outs)
        return states, outs, acc
    if static is not None:
        if acc is None:
            return (*cuda_dense.run_general_dense_chunk_cuda(
                dg, static, spec, params, states, chunk), None)
        return cuda_dense.run_general_dense_chunk_cuda(
            dg, static, spec, params, states, chunk, acc=acc,
            keep_rows=keep_rows)
    trans = dense.transition if path == "general_dense" else kstep.transition
    states, outs = kstep.run_steps(trans, dg, spec, params, states, chunk)
    if acc is not None:
        acc = cuda_summary.summary_fold(acc, outs)
    return states, outs, acc


def resolve_kernel_path(dg, spec, kernel_path=None) -> str:
    """'general_dense' or 'general', as the JAX package's ``run_chains``
    resolves it: None takes the dense body where ``dense.supported``
    holds, a demanded 'general_dense' that it rejects raises."""
    if kernel_path is None:
        return "general_dense" if dense.supported(dg, spec) else "general"
    if kernel_path == "general_dense":
        if not dense.supported(dg, spec):
            raise ValueError("kernel_path='general_dense' demanded but "
                             "kernel.dense.supported rejects this (graph, "
                             "spec)")
        return kernel_path
    if kernel_path == "general":
        return kernel_path
    raise ValueError(f"kernel_path {kernel_path!r}: the general runner takes "
                     "'general_dense' | 'general' | None")


def run_chains(dg, spec, params, states, n_steps: int,
               record_history: bool = True, chunk=None,
               record_initial: bool = True, record_every: int = 1,
               history_device: bool = False, kernel_path=None,
               recorder=None, analytics=None) -> RunResult:
    """Run the batch for ``n_steps`` yields, the first the initial state
    (as the reference's ``for part in exp_chain`` sees it); the JAX
    package's ``run_chains``. ``record_initial=False`` continues an
    earlier run whose last yield recorded the current state, so every
    yield here is a fresh transition. ``record_every=k`` keeps yields 0,
    k, 2k, ... of the history (the accumulators advance every step).
    ``history_device`` keeps the history as tensors on the run's device.
    Wait sums are drained into a host float64 total once a chunk.

    ``kernel_path``: None resolves as the JAX package does
    (``resolve_kernel_path``). On the card the ``general_dense`` chunk is
    the kernel of ``kernel/cuda_dense.py`` (the 2-district walk) or of
    ``kernel/cuda_pair.py`` (the k-district pair walk), launched once a
    chunk; a spec beyond its scope raises, naming the ROADMAP.md item, and
    the plain dense version never runs in its place. The legacy body ('general')
    runs as torch ops on the run's device. The conn planes are attached
    on entry (by the kernel itself on its first chunk) and stripped on
    exit. ``analytics`` (a ``stats.accumulators.DeviceAnalytics`` on the
    run's device) folds the initial record (one ``summary_fold`` launch)
    and each chunk's records, every step whatever ``record_every``: the
    dense kernel folds them in its own launch, the legacy body's rows go
    to ``summary_fold``; pass ``record_history=False`` for summary mode,
    where the dense kernel writes no row. ``recorder``
    (obs events) waits for ROADMAP.md A11."""
    if recorder is not None:
        raise ValueError("run_chains(recorder=...): obs events wait for "
                         "ROADMAP.md A11")
    kstep.check_general(spec)
    if states.reject_count is not None:
        raise ValueError("reject_count is not ported: the reject taxonomy "
                         "waits for ROADMAP.md A11")
    path = resolve_kernel_path(dg, spec, kernel_path)
    dev = states.assignment.device
    static = None
    if path == "general_dense" and dev.type == "cuda":
        if spec.proposal == "pair":
            cuda_pair.check(dg, spec, params)
            static = cuda_pair.make_static_inputs(dg)
        else:
            cuda_dense.check(dg, spec, params)
            static = cuda_dense.make_static_inputs(dg, spec)
    had_conn = states.conn_bits is not None
    if path == "general_dense" and static is None:
        states = dense.ensure_conn_bits(dg, spec, states)
    elif path != "general_dense" and not had_conn:
        states = dense.strip_conn_bits(states)
    if record_every < 1:
        raise ValueError(f"record_every must be >= 1, got {record_every}")
    if chunk is None:
        chunk = pick_chunk(n_steps + (0 if record_initial else 1), 4096)
    if record_every > 1:
        chunk = snap_chunk_to(chunk, record_every)

    hist_parts = {} if record_history else None
    done = 0
    if record_initial:
        states, out0 = kstep.record(dg, spec, params, states)
        if analytics is not None:
            # the initial yield is on the recorded grid: fold it so the
            # summary matches the history sample for sample
            analytics.update(cuda_summary.summary_fold(
                analytics.acc, {k: v[None] for k, v in out0.items()}), 1)
        if record_history:
            out0 = maybe_host(out0, history_device)
            hist_parts = {k: [v[:, None]] for k, v in out0.items()}
        done = 1
    waits_total = states.waits_sum.cpu().numpy().astype(np.float64)
    states = states.replace(waits_sum=torch.zeros_like(states.waits_sum))
    while done < n_steps:
        this = min(chunk, n_steps - done)
        states, outs, acc = _run_chunk(
            dg, spec, params, states, this, path, static,
            acc=None if analytics is None else analytics.acc,
            keep_rows=record_history)
        if analytics is not None:
            analytics.update(acc, this)
        if record_history:
            outs = maybe_host(thin_outs(outs, record_every), history_device)
            for k, v in outs.items():
                hist_parts.setdefault(k, []).append(v.T)
        waits_total += states.waits_sum.cpu().numpy().astype(np.float64)
        states = states.replace(waits_sum=torch.zeros_like(states.waits_sum))
        done += this
    history = assemble_history(hist_parts, record_history, history_device)
    if not had_conn:
        states = dense.strip_conn_bits(states)
    return RunResult(state=states, history=history, waits_total=waits_total,
                     n_yields=n_steps)
