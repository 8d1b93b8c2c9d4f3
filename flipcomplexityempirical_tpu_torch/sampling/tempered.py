"""Replica-exchange orchestration: chunked advance and swap rounds.

Port of ``flipcomplexityempirical_tpu/sampling/tempered.py``
(``init_tempered``, ``TemperResult``, ``run_tempered``,
``per_rung_history``), without the obs recorder (ROADMAP.md A11).
``run_tempered`` advances every chain ``swap_every`` transitions, then
runs one even-odd swap round (``tempering.swap_within_batch``) with
alternating parity. Temperatures (StepParams.beta) are exchanged, not
states, so a round is a params update between chunks: the board path's
chunk kernel reads each chain's beta at every launch and its static
inputs are built once a run.

The batch is laid out (ladders, rungs): chain c is rung ``c % n_rungs``
of ladder ``c // n_rungs``. The host keeps, per round, the swap attempts
and accepts of each adjacent rung pair and the beta of every chain
(``beta_hist``), from which ``per_rung_history`` reconstructs rung-r
trajectories: after a swap the physical rung wanders between chains.

Which body runs: the board path (``board_runner``: the lowered-chunk
kernel, or the board pair kernel under 'pair') where
``kernel.board.supports`` holds; elsewhere the general path's legacy
re-propose body (torch ops, ROADMAP.md B9), which the JAX package's
``runner._run_chunk`` runs on a state from ``init_batch`` (one without
conn planes; a state with them is refused).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..convert import to_numpy
from ..kernel import board as kboard
from ..kernel import step as kstep
from ..kernel.step import Spec, StepParams
from . import board_runner, runner
from .runner import thin_outs
from .tempering import make_ladder_params, swap_within_batch


def init_tempered(graph, assignment, *, betas, n_ladders: int, seed: int,
                  spec: Spec, base: float, pop_tol: float, device="cuda"):
    """(graph handle, states, ladder params) for ``run_tempered`` on
    ``device``: C = n_ladders * len(betas) chains laid out rung-fastest,
    on the board path where ``kernel.board.supports`` holds, else on the
    general path."""
    c = n_ladders * len(tuple(betas))
    init = (board_runner.init_board if kboard.supports(graph, spec)
            else runner.init_batch)
    handle, states, params = init(graph, assignment, n_chains=c, seed=seed,
                                  spec=spec, base=base, pop_tol=pop_tol,
                                  device=device)
    return handle, states, make_ladder_params(params, betas, n_ladders)


@dataclasses.dataclass
class TemperResult:
    """RunResult plus the ladder diagnostics."""
    state: object                # final chain state (on the run's device)
    history: dict                # name -> (C, T') recorded history (numpy)
    waits_total: np.ndarray      # f64 (C,)
    n_yields: int
    params: StepParams           # final params (exchanged betas)
    betas: np.ndarray            # (n_rungs,) the ladder, rung 0 first
    n_rungs: int
    swap_every: int
    record_every: int
    general_initial: bool        # general path: extra initial record at t=0
    beta_hist: np.ndarray        # (n_rounds, C) beta of chain c in round r
    swap_attempts: np.ndarray    # (n_rungs-1,) pair (r, r+1) attempts
    swap_accepts: np.ndarray     # (n_rungs-1,) accepted exchanges
    end_parity: int = 0          # swap parity a continuation starts from
    end_swap_key: object = None  # raw key (2,) a continuation starts from

    def host_state(self) -> dict:
        return to_numpy(self.state)

    def swap_rates(self) -> np.ndarray:
        with np.errstate(invalid="ignore"):
            return self.swap_accepts / np.maximum(self.swap_attempts, 1)


def _host_rungs(beta, n_rungs: int) -> np.ndarray:
    """numpy mirror of ``tempering.chain_rungs``: per-chain rank of the
    CURRENT beta within its ladder, rank 0 = coldest (largest beta)."""
    b_lr = np.asarray(beta).reshape(-1, n_rungs)
    pos_of_rank = np.argsort(-b_lr, axis=1, kind="stable")
    return np.argsort(pos_of_rank, axis=1, kind="stable").reshape(-1)


def _accumulate_swaps(accept_mask, rungs, n_rungs, parity, attempts,
                      accepts, n_ladders):
    """Per-pair bookkeeping of one swap round. ``rungs`` is the pre-swap
    rank assignment. Pair (r, r+1) is active when r % 2 == parity; the
    accept mask is symmetric, so the lower rung's entries count each
    exchanged pair once."""
    for r in range(n_rungs - 1):
        if r % 2 != parity % 2:
            continue
        attempts[r] += n_ladders
        accepts[r] += int(accept_mask[rungs == r].sum())


def _chunk_runner(handle, spec: Spec, params: StepParams, states,
                  bits: Optional[bool]):
    """The run's chunk function, static inputs built once: (states,
    steps) -> (states, rows {name: (T, C)})."""
    if isinstance(states, kboard.BoardState):
        kern = board_runner.chunk_module(spec)
        kern.body_for(handle, spec, bits)
        static = kern.make_static_inputs(handle, spec, params)
        return lambda p, s, n: kern.run_chunk(handle, spec, p, s, n, static)
    kstep.check_general(spec)
    if states.conn_bits is not None:
        raise ValueError("run_tempered runs the general path's legacy body, "
                         "as the JAX package's does on init_batch's states: "
                         "pass a state without conn planes")
    return lambda p, s, n: runner._run_chunk(handle, spec, p, s, n,
                                             "general")[:2]


def run_tempered(graph_handle, spec: Spec, params: StepParams, states,
                 n_steps: int, *, betas, n_ladders: int, swap_every: int,
                 swap_seed: int = 0, record_history: bool = True,
                 record_every: int = 1, bits: Optional[bool] = None,
                 segment: bool = False, record_initial: bool = True,
                 start_parity: int = 0, swap_key=None,
                 recorder=None) -> TemperResult:
    """Run C = n_ladders * len(betas) chains for ``n_steps`` yields with a
    replica-exchange round every ``swap_every`` transitions, on the
    states' device.

    ``graph_handle`` is the DeviceGraph (general path) or BoardGraph
    (board path, chosen by the type of ``states``). ``params`` must carry
    the ladder's betas (``tempering.make_ladder_params``); ``spec.anneal``
    must be 'none'. Yield and record semantics are ``run_chains`` /
    ``run_board``'s; the final partial round is advanced without a
    trailing swap.

    Checkpoint segments (the experiment driver's): call with
    ``segment=True`` for every slice but the last, where ``n_steps``
    counts TRANSITIONS (the board path's final record and the omission
    of the trailing swap fall to the last slice) and a between-segment
    swap still fires after the last round; the continuation resumes with
    ``record_initial=False`` (general path),
    ``start_parity=result.end_parity``, ``swap_key=result.end_swap_key``
    and the returned ``params``. Segments are whole numbers of rounds.
    ``recorder`` (obs events) waits for ROADMAP.md A11."""
    if recorder is not None:
        raise ValueError("run_tempered(recorder=...): obs events wait for "
                         "ROADMAP.md A11")
    betas = np.asarray(betas, np.float64)
    n_rungs = betas.shape[0]
    is_board = isinstance(states, kboard.BoardState)
    c = states.cut_count.shape[0]
    dev = states.cut_count.device
    if c != n_ladders * n_rungs:
        raise ValueError(f"batch size {c} != n_ladders*n_rungs "
                         f"{n_ladders}*{n_rungs}")
    if swap_every < 1:
        raise ValueError("swap_every must be >= 1")
    if record_every > 1 and swap_every % record_every:
        raise ValueError("record_every must divide swap_every so the "
                         "record grid survives round boundaries")
    if segment and n_steps % swap_every:
        raise ValueError("a checkpoint segment must be a whole number of "
                         "swap rounds (n_steps % swap_every == 0)")
    if getattr(states, "reject_count", None) is not None:
        raise ValueError("reject_count is not ported: the reject taxonomy "
                         "waits for ROADMAP.md A11")
    attempts = np.zeros(n_rungs - 1, np.int64)
    accepts = np.zeros(n_rungs - 1, np.int64)
    beta_rows = []
    key = (torch.as_tensor(swap_key, dtype=torch.int64, device=dev)
           if swap_key is not None else rng.prng_key(swap_seed, device=dev))
    chunk = _chunk_runner(graph_handle, spec, params, states, bits)

    hist_parts: dict = {}
    waits_total = states.waits_sum.cpu().numpy().astype(np.float64)
    states = states.replace(waits_sum=torch.zeros_like(states.waits_sum))
    pending: list = []

    transitions = n_steps if segment else n_steps - 1
    done = 0
    parity = start_parity
    if not is_board and record_initial:
        states, out0 = kstep.record(graph_handle, spec, params, states)
        if record_history:
            for k, v in out0.items():
                hist_parts.setdefault(k, []).append(
                    v.cpu().numpy()[:, None])
    while done < transitions:
        this = min(swap_every, transitions - done)
        beta_rows.append(params.beta.cpu().numpy().astype(np.float32))
        states, outs = chunk(params, states, this)
        if record_history:
            outs = thin_outs(outs, record_every,
                             offset=0 if is_board else record_every - 1)
            for k, v in outs.items():
                hist_parts.setdefault(k, []).append(v.cpu().numpy().T)
        pending.append(states.waits_sum)
        states = states.replace(waits_sum=torch.zeros_like(states.waits_sum))
        done += this
        if done < transitions or segment:
            # swaps sit BETWEEN rounds: no trailing swap on a full run, so
            # the final yield belongs to beta_hist's last row; a
            # checkpoint segment ends with its between-segment swap
            ks = rng.split(key, 2)
            key, sub = ks[0], ks[1]
            rungs_now = _host_rungs(params.beta.cpu().numpy(), n_rungs)
            params, acc = swap_within_batch(sub, states, params, n_rungs,
                                            parity, spec=spec)
            _accumulate_swaps(acc.cpu().numpy(), rungs_now, n_rungs, parity,
                              attempts, accepts, n_ladders)
            parity ^= 1

    if is_board and not segment:
        res = board_runner.finalize_board_run(
            graph_handle, spec, params, states, hist_parts, waits_total,
            pending, record_history, n_steps, record_every)
        states, history, waits_total = (res.state, res.history,
                                        res.waits_total)
    else:
        for w in pending:
            waits_total += w.cpu().numpy().astype(np.float64)
        history = ({k: np.concatenate(v, axis=1)
                    for k, v in hist_parts.items()}
                   if record_history and hist_parts else {})
    return TemperResult(
        state=states, history=history, waits_total=waits_total,
        n_yields=n_steps, params=params, betas=betas, n_rungs=n_rungs,
        swap_every=swap_every, record_every=record_every,
        general_initial=not is_board,
        beta_hist=(np.stack(beta_rows) if beta_rows
                   else np.zeros((0, c), np.float32)),
        swap_attempts=attempts, swap_accepts=accepts,
        end_parity=parity, end_swap_key=key)


def per_rung_history(res: TemperResult, name: str) -> np.ndarray:
    """Rung-resolved trajectories from a per-chain history: (n_rungs,
    n_ladders, T') where entry [r, l, t] is the value recorded at yield t
    by whichever of ladder l's chains held rung r then (the JAX
    package's, in numpy). Rungs are matched by RANK within each ladder
    column (rank 0 = largest beta); the betas must be pairwise
    distinct."""
    beta32 = res.betas.astype(np.float32)
    if len(set(beta32.tolist())) != res.n_rungs:
        raise ValueError("per_rung_history needs pairwise-distinct betas")
    h = np.asarray(res.history[name])                       # (C, T')
    c, t_rec = h.shape
    nl = c // res.n_rungs
    se = res.swap_every
    n_rounds = res.beta_hist.shape[0]
    # round of each recorded column: the general path records yield t > 0
    # AFTER transition t (round (t-1)//se, with the initial yield 0 in
    # round 0); board chunks record yield t BEFORE transition t+1
    # (round t//se), and the final yield lands in the last round
    yields = np.arange(t_rec) * res.record_every
    if res.general_initial:
        rounds = np.maximum(yields - 1, 0) // se
    else:
        rounds = yields // se
    rounds = np.minimum(rounds, max(n_rounds - 1, 0))
    bh3 = res.beta_hist[rounds].reshape(t_rec, nl, res.n_rungs)
    h3 = h.reshape(nl, res.n_rungs, t_rec)
    rank_of_rung = np.argsort(np.argsort(-beta32, kind="stable"),
                              kind="stable")
    order = np.argsort(-bh3, axis=2, kind="stable")         # (T', nl, R)
    out = np.empty((res.n_rungs, nl, t_rec), h.dtype)
    for r in range(res.n_rungs):
        j = order[:, :, rank_of_rung[r]]                    # (T', nl)
        out[r] = np.take_along_axis(h3, j.T[:, None, :], axis=1)[:, 0]
    return out
