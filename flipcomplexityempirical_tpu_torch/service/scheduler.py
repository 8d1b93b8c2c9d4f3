"""Coalescing scheduler: compatible jobs share one batch of chains.

Port of the coalescing core of
``flipcomplexityempirical_tpu/service/scheduler.py``. The batching
contract rests on two invariants of the port:

1. Chains are independent: every per-chain PRNG key lives in the chain
   state, the chunk kernels (``csrc/lowered_chunk.cu``,
   ``csrc/board_pair_chunk.cu``, ``csrc/general_dense_chunk.cu``,
   ``csrc/general_pair_chunk.cu``) and their plain versions run one
   chain per row, and the StepParams leaves ``log_base`` / ``beta`` /
   ``pop_lo`` / ``pop_hi`` are (C,) tensors read per chain. Concatenating
   two tenants' states and params along the chain axis, running one
   batched segment, and slicing the rows back out is therefore
   BIT-identical to running each tenant alone (tests/test_torch_service_
   batch.py holds it on the lowered-bits and general-dense paths).
2. Jobs with equal ``ExperimentConfig.fingerprint()`` build the same
   graph, Spec and run shape (steps, thinning, so the same chunking), so
   one batch serves them all: one launch a chunk for every tenant where
   solo runs would launch once a chunk each.

A summary-mode config (``analytics='summary'``) is accepted as the JAX
service accepts it: its fingerprint keeps it apart from history-mode
jobs, and its batch runs as the JAX service's ``_run_batch`` runs it, in
history mode (no ``analytics`` is passed), so a tenant equals the JAX
service's output for it.

A job with an existing checkpoint runs solo from its resume point
(coalescing assumes a common step 0), and so does every temper job,
through the driver's ``_run_temper`` (its swap rounds are global to its
ladders), as the JAX service runs them. A job that raises is marked
``failed`` with its error, with no retry, so one pass over the queue's
groups drains it.

Left out, each refused by name where a caller asks for it (ROADMAP.md
A11): the journal and ``recover``, retries and quarantine, deadlines,
drain, the dispatch watchdog, heartbeats, obs events, the compile cache
(the kernels build once a process, ``kernel/_build.py``), the control
loop and fault injection.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..experiments import driver as drv
from ..experiments.config import ExperimentConfig
from ..kernel import cuda_board_pair, cuda_dense, cuda_lowered, cuda_pair
from ..kernel import board as kboard
from ..sampling.board_runner import finalize_board_run, run_board_segment
from ..sampling.runner import resolve_kernel_path, run_chains
from . import queue as q

_A11 = "ROADMAP.md A11 (the host layers: the sweep service)"

# StepParams leaves that carry one value per chain, concatenated along
# the chain axis; every other field (label_values, the anneal constants)
# is shared and taken from the first tenant, equal within a fingerprint
# group by construction. The JAX package reads this split off its
# ``vmap_axes``.
PER_CHAIN_PARAMS = ("log_base", "beta", "pop_lo", "pop_hi")


def concat_states(states_list):
    """Stack tenant chain states (BoardState or ChainState) along the
    chain axis. Every tensor field is per-chain (leading axis C); a field
    that is None (``reject_count``, ``conn_bits``, a rook state's
    ``cut_times_se`` / ``cut_times_sw``) stays None."""
    if len(states_list) == 1:
        return states_list[0]
    s0 = states_list[0]
    fields = {}
    for f in dataclasses.fields(s0):
        vals = [getattr(s, f.name) for s in states_list]
        if all(v is None for v in vals):
            fields[f.name] = None
        elif any(v is None for v in vals):
            raise ValueError(f"state field {f.name!r} is None in some "
                             "tenants only")
        else:
            fields[f.name] = torch.cat(vals, dim=0)
    return type(s0)(**fields)


def concat_params(params_list):
    """Stack StepParams along the chain axis: the ``PER_CHAIN_PARAMS``
    leaves are concatenated (so coalesced tenants may differ in base and
    pop_tol), the shared ones are taken from the first tenant."""
    if len(params_list) == 1:
        return params_list[0]
    p0 = params_list[0]
    fields = {}
    for f in dataclasses.fields(p0):
        vals = [getattr(p, f.name) for p in params_list]
        fields[f.name] = (torch.cat(vals, dim=0)
                          if f.name in PER_CHAIN_PARAMS else vals[0])
    return type(p0)(**fields)


def _slice_chains(tree, lo: int, hi: int):
    """Rows lo:hi of every per-chain leaf: a state dataclass (None fields
    stay None), a dict of arrays, or one array or tensor."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _slice_chains(getattr(tree, f.name), lo, hi)
            for f in dataclasses.fields(tree)
            if getattr(tree, f.name) is not None})
    if isinstance(tree, dict):
        return {k: _slice_chains(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _to_host(state):
    """A state dataclass with every tensor copied to the host once, so
    that slicing it per tenant copies nothing more."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).cpu()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def _launch_count() -> int:
    """Launches of the chunk kernels a sweep runs, so far."""
    return (cuda_lowered.run_lowered_chunk_cuda.launches
            + cuda_board_pair.run_board_pair_chunk_cuda.launches
            + cuda_dense.run_general_dense_chunk_cuda.launches
            + cuda_pair.run_general_pair_chunk_cuda.launches)


@dataclasses.dataclass
class _Prepared:
    """One tenant initialised and ready to join a batch."""

    job: q.Job
    g: object
    spec: object
    use_board: bool
    handle: object
    states: object
    params: object
    n_parts: int = 0


@dataclasses.dataclass
class BatchStats:
    """Host-side record of one executed batch (``bench --service`` and
    the simulation mode read these for tenant-efficiency math).
    ``wall_s`` is the JAX package's: the run through its final record,
    set-up and slicing excluded; ``prepare_s`` is the tenants' set-up
    (graph, plan, initial state: ``_prepare``) and ``assemble_s`` the
    slicing of every tenant's rows into its result. ``launches`` counts
    the chunk kernels' launches in the batch (0 on the CPU)."""

    batch_id: str
    jobs: list
    chains: int
    steps: int
    wall_s: float
    kernel_path: str
    prepare_s: float = 0.0
    assemble_s: float = 0.0
    launches: int = 0


class SweepService:
    """The sweep-as-a-service loop: submit ExperimentConfigs, then
    ``run_until_idle`` drains the queue — coalescing fingerprint-equal
    fresh jobs into shared batches of chains on ``device`` and running
    checkpointed jobs solo through the driver's segmented run."""

    def __init__(self, outdir: str,
                 checkpoint_dir: Optional[str] = None,
                 max_batch_chains: Optional[int] = None,
                 verbose: bool = False, device="cuda",
                 recorder=None, heartbeat=None, compile_cache=None,
                 policy=None, journal=None, dispatch_timeout=None,
                 control=None):
        for name, value in (("recorder", recorder),
                            ("heartbeat", heartbeat),
                            ("compile_cache", compile_cache),
                            ("policy", policy),
                            ("dispatch_timeout", dispatch_timeout),
                            ("control", control)):
            if value is not None:
                raise ValueError(f"SweepService({name}=...) is not ported: "
                                 f"it waits for {_A11}")
        if journal not in (None, False):
            raise ValueError(f"SweepService(journal=...) is not ported: it "
                             f"waits for {_A11}")
        self.device = resolve_device(device)
        self.outdir = outdir
        self.checkpoint_dir = checkpoint_dir
        self.max_batch_chains = max_batch_chains
        self.verbose = verbose
        self.queue = q.JobQueue()
        self.batch_stats: list[BatchStats] = []
        self._batch_seq = 0
        os.makedirs(outdir, exist_ok=True)

    @classmethod
    def recover(cls, outdir: str, **kwargs) -> "SweepService":
        raise ValueError(f"SweepService.recover needs the journal, which "
                         f"is not ported: it waits for {_A11}")

    # -- submission --------------------------------------------------

    def submit(self, config: ExperimentConfig) -> q.Job:
        """Queue one config; a config this package has not ported is
        refused here, naming its ROADMAP.md item, before anything runs."""
        drv._check_ported(config)
        return self.queue.submit(config)

    # -- grouping ----------------------------------------------------

    def _has_checkpoint(self, cfg: ExperimentConfig) -> bool:
        if not self.checkpoint_dir:
            return False
        return any(os.path.exists(os.path.join(self.checkpoint_dir, f))
                   for f in (cfg.tag + ".npz",
                             cfg.tag + ".manifest.json"))

    def _solo_only(self, job: q.Job) -> bool:
        """Jobs the coalescer must not touch: the temper family (its swap
        state is global to the run's ladders), non-flip chains (ReCom
        runs solo through the driver, as in the JAX service) and those
        with an existing checkpoint (resume points differ; coalescing
        assumes a common step 0). The JAX package's other solo jobs,
        isolation retries, wait for ROADMAP.md A11."""
        return (job.config.family == "temper"
                or job.config.chain != "flip"
                or self._has_checkpoint(job.config))

    def _form_groups(self, jobs: list) -> list:
        """Submission-ordered greedy grouping: fingerprint-equal
        batchable jobs share a group (capped at ``max_batch_chains``
        total chains), everything else is a singleton."""
        groups: list[list] = []
        by_key: dict = {}
        for job in jobs:
            if self._solo_only(job):
                groups.append([job])
                continue
            key = job.fingerprint
            grp = by_key.get(key)
            if grp is not None and (
                    self.max_batch_chains is None
                    or sum(j.config.n_chains for j in grp)
                    + job.config.n_chains <= self.max_batch_chains):
                grp.append(job)
            else:
                grp = [job]
                groups.append(grp)
                by_key[key] = grp
        return groups

    # -- the drain loop ----------------------------------------------

    def run_until_idle(self) -> list:
        """Process the queue to quiescence; returns all jobs (terminal
        states set, ``result`` populated on DONE)."""
        for jobs in self._form_groups(self.queue.runnable()):
            self._execute(jobs)
        return self.queue.jobs()

    @property
    def exit_code(self) -> int:
        """0 when every job is done; 2 when any failed."""
        return 2 if any(j.status == q.FAILED
                        for j in self.queue.jobs()) else 0

    # -- execution ---------------------------------------------------

    def _execute(self, jobs: list) -> None:
        """Run one group (1..N jobs) as a single attempt per member."""
        batch_id = f"b{self._batch_seq:04d}"
        self._batch_seq += 1
        for job in jobs:
            job.status = q.RUNNING
            job.batch = batch_id
        t0 = time.perf_counter()
        try:
            if len(jobs) == 1 and self._solo_only(jobs[0]):
                results = [(jobs[0], self._run_solo(jobs[0], batch_id))]
            else:
                prepared = []
                for job in jobs:
                    try:
                        prepared.append(self._prepare(job))
                    except Exception as e:
                        self._fail(job, e)
                prepare_s = time.perf_counter() - t0
                results = (self._run_batch(prepared, batch_id, prepare_s)
                           if prepared else [])
        except Exception as e:
            for job in jobs:
                if job.status == q.RUNNING:
                    self._fail(job, e)
            return
        for job, data in results:
            self._complete(job, data)

    def _prepare(self, job: q.Job) -> _Prepared:
        """Build graph/plan/spec and initialise this tenant's own
        (states, params) through the driver's ``_init_run`` — each tenant
        keeps its own seed-derived per-chain PRNG keys, so coalescing
        changes nothing about any chain's trajectory."""
        cfg = job.config
        if (cfg.checkpoint_every and cfg.record_every > 1
                and cfg.checkpoint_every % cfg.record_every):
            raise ValueError(
                f"checkpoint_every ({cfg.checkpoint_every}) must be a "
                f"multiple of record_every ({cfg.record_every})")
        g, plan, _geo = drv.build_graph_and_plan(cfg)
        spec = drv.spec_for(cfg)
        use_board, (handle, states, params) = drv._init_run(
            cfg, g, plan, spec, self.device)
        return _Prepared(job=job, g=g, spec=spec,
                         use_board=use_board, handle=handle,
                         states=states, params=params)

    @staticmethod
    def _kernel_path(handle, spec, use_board: bool) -> str:
        """The JAX package's body name: 'lowered_bits' on the lowered
        kernel, 'bitboard' / 'board' on the board pair kernel,
        'general_dense' / 'general' on the general path."""
        if use_board:
            return kboard.body_for(handle, spec)
        return resolve_kernel_path(handle, spec)

    def _run_solo(self, job: q.Job, batch_id: str) -> dict:
        """Singleton execution through the driver's segmented run
        (``_run_torch``, or ``_run_temper`` for the temper family): a job
        with a checkpoint resumes from it, exactly as ``run_config``
        would, minus artifact rendering."""
        cfg = job.config
        t0 = time.perf_counter()
        g, plan, _geo = drv.build_graph_and_plan(cfg)
        spec = drv.spec_for(cfg)
        run = drv._init_run(cfg, g, plan, spec, self.device)
        path = self._kernel_path(run[1][0], spec, run[0])
        prepare_s = time.perf_counter() - t0
        launches0 = _launch_count()
        t0 = time.perf_counter()
        solo_run = drv._run_temper if cfg.family == "temper" else drv._run_torch
        data = solo_run(cfg, g, plan, self.checkpoint_dir, device=self.device,
                        run=run)
        wall = time.perf_counter() - t0
        data["seconds"] = wall
        self.batch_stats.append(BatchStats(
            batch_id=batch_id, jobs=[job.job_id],
            chains=int(run[1][1].cut_count.shape[0]),
            steps=cfg.total_steps, wall_s=wall, kernel_path=path,
            prepare_s=prepare_s, launches=_launch_count() - launches0))
        return data

    def _run_batch(self, prepared: list, batch_id: str,
                   prepare_s: float = 0.0) -> list:
        """The coalesced executor: the driver's segment loop
        (``_run_torch``) over the concatenated batch, control off, with
        per-tenant checkpoints (each tenant's sliced rows) and per-tenant
        result slicing at the end. All members are fresh (step 0) with
        equal fingerprints, so spec, graph and run shape agree by
        construction."""
        lead = prepared[0]
        cfg0 = lead.job.config
        spec, use_board, handle = lead.spec, lead.use_board, lead.handle
        counts = [p.job.config.n_chains for p in prepared]
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(int)
        c_total = int(offsets[-1])
        states = concat_states([p.states for p in prepared])
        params = concat_params([p.params for p in prepared])
        every = min(c.checkpoint_every or c.total_steps
                    for c in (p.job.config for p in prepared))
        total = cfg0.total_steps - (1 if use_board else 0)
        path = self._kernel_path(handle, spec, use_board)
        launches0 = _launch_count()

        t0 = time.perf_counter()
        done = 0
        hist_parts: dict = {}
        waits_total = np.zeros(c_total, np.float64)
        while done < total:
            n = min(every, total - done)
            if use_board:
                res = run_board_segment(handle, spec, params, states, n,
                                        record_every=cfg0.record_every,
                                        history_device=True,
                                        device=self.device)
            else:
                res = run_chains(handle, spec, params, states, n_steps=n,
                                 record_initial=(done == 0),
                                 record_every=cfg0.record_every,
                                 history_device=True)
            states = res.state
            # one copy of the segment's history to the host
            seg_hist = {k: v.cpu().numpy() for k, v in res.history.items()}
            for k, v in seg_hist.items():
                hist_parts.setdefault(k, []).append(v)
            waits_total += res.waits_total
            done += n
            if self.checkpoint_dir:
                for i, p in enumerate(prepared):
                    lo, hi = int(offsets[i]), int(offsets[i + 1])
                    p.n_parts = drv.save_checkpoint(
                        self.checkpoint_dir, p.job.config,
                        _slice_chains(states, lo, hi), done=done,
                        waits_total=waits_total[lo:hi],
                        new_hist=_slice_chains(seg_hist, lo, hi),
                        part_idx=p.n_parts)

        # finalise the whole batch once, then slice per tenant
        if use_board:
            res = finalize_board_run(handle, spec, params, states,
                                     hist_parts, waits_total, [], True,
                                     cfg0.total_steps, cfg0.record_every)
            states, history, waits_total = (res.state, res.history,
                                            res.waits_total)
        else:
            history = {k: np.concatenate(v, axis=1)
                       for k, v in hist_parts.items()}
        host = _to_host(states)
        wall = time.perf_counter() - t0
        launches = _launch_count() - launches0
        t1 = time.perf_counter()
        results = []
        for i, p in enumerate(prepared):
            lo, hi = int(offsets[i]), int(offsets[i + 1])
            # the lead's graph for every tenant: fingerprint-equal configs
            # build equal graphs, and one instance keeps the stencil cache
            # (keyed on the graph object) warm across the tenants
            data = drv.assemble_run_data(
                p.job.config, lead.g, handle, _slice_chains(host, lo, hi),
                _slice_chains(history, lo, hi), waits_total[lo:hi].copy(),
                use_board=use_board)
            data["batch"] = batch_id
            data["batch_chains"] = c_total
            data["seconds"] = wall
            results.append((p.job, data))
        self.batch_stats.append(BatchStats(
            batch_id=batch_id, jobs=[p.job.job_id for p in prepared],
            chains=c_total, steps=cfg0.total_steps, wall_s=wall,
            kernel_path=path, prepare_s=prepare_s,
            assemble_s=time.perf_counter() - t1, launches=launches))
        return results

    # -- job terminals -----------------------------------------------

    def _complete(self, job: q.Job, data: dict):
        job.status = q.DONE
        job.result = data
        if self.verbose:
            print(f"[done] {job.job_id} {job.tag} "
                  f"({data['seconds']:.2f}s, {job.batch})", flush=True)

    def _fail(self, job: q.Job, exc: BaseException) -> None:
        """A job that raised ends ``failed`` with its error: retries and
        quarantine wait for ROADMAP.md A11."""
        job.error = f"{type(exc).__name__}: {exc}"
        job.status = q.FAILED
        if self.verbose:
            print(f"[failed] {job.job_id} {job.tag} ({job.error})",
                  flush=True)
