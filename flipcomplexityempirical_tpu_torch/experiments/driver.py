"""Per-config experiment driver: the reference's measurement loop and its
artifacts, for the sec11, Frankengraph, rook-grid k-district (kpair),
triangular, hexagonal, tempered Frankengraph and precinct dual-graph
families.

Port of ``flipcomplexityempirical_tpu/experiments/driver.py`` (its JAX
backend's board and general branches, the checkpoints and the bare sweep
loop). ``run_config`` runs a config's chains (chain 0 renders the
reference's artifacts; every chain feeds the partisan scores), in
checkpoint segments when ``cfg.checkpoint_every > 0``:

- where ``kernel.board.supports(graph, spec)`` holds (sec11, the
  Frankengraph, the triangular lattice without a variant), through
  ``run_board_segment`` on the lowered-chunk kernel, then
  ``finalize_board_run``; the kpair family's k-district pair walk on the
  64 x 64 rook grid the same way, on the board pair kernel;
- the temper family (``_run_temper``): ladders of beta rungs on the
  Frankengraph through ``sampling.tempered.run_tempered`` (a swap round
  every ``swap_every`` transitions), in checkpoint segments of whole
  rounds when asked (``_run_temper_segmented``); its artifacts follow the
  chain that ends holding the coldest beta of ladder 0, with the per-rung
  cut trajectories (``rungs.png``) and the swap statistics;
- elsewhere (the hexagonal lattice, the dual graphs' k-district pair
  walk, a proposal variant of sec11 or the Frankengraph, contiguity
  'exact') through the general runner ``run_chains``: the dense body on
  the general-dense kernel (the pair kernel for the pair walk) where the
  JAX package would take it, else the legacy body;
- ``cfg.chain == 'recom'`` (any family but temper) through
  ``sampling.recom.run_recom`` on the general path's state, the ReCom
  kernel on the card, with the JAX driver's ``epsilon = pop_tol`` and
  ``pop_target = sum(pop) / k``.

``cfg.analytics == 'summary'`` runs either path in summary mode, as the
JAX package's driver does: no history is kept, each chunk's rows are
folded on the card (``stats.accumulators.DeviceAnalytics``,
``kernel/cuda_summary.py``), and chain 0's interface series (sec11 and
frank) come back once at the end, so the artifacts are the history
mode's, byte for byte.

Completion manifest: a config is done when all its artifacts exist
(``artifacts.FAMILY_ARTIFACTS``); ``run_sweep`` skips completed configs. A crash between segments loses at
most ``checkpoint_every`` steps: the next ``run_config`` resumes chain
state, histories and wait totals from the per-config checkpoint, whose
on-disk format is the JAX package's (file names, manifest, ``state_*`` /
``meta_*`` / ``hist_*`` keys and dtypes, the key as uint32[C, 2]), so a
sweep checkpointed by either package resumes in the other.

Refuse, never substitute: a family, chain or spec that this package has
not ported raises ``ValueError`` naming the missing
ROADMAP.md item; no other chain is run in its place.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .. import rng
from ..convert import to_numpy
from ..device import resolve_device
from ..graphs import (PARITY_LABELS, frank_plan, frankengraph,
                      from_geojson, grid_sec11, hex_lattice, sec11_plan,
                      square_grid, stripes_plan, synthetic_precincts,
                      triangular_lattice, voronoi_precincts)
from ..graphs.votes import seed_votes, validate_votes
from ..kernel import board as kboard
from ..kernel.step import Spec, finalize_host
from ..sampling.board_runner import (chunk_module, finalize_board_run,
                                     init_board, run_board_segment)
from ..sampling.recom import run_recom
from ..sampling.runner import init_batch, run_chains
from ..sampling.tempered import (TemperResult, init_tempered,
                                 per_rung_history, run_tempered)
from ..stats import partisan
from ..stats.compactness import polsby_popper
from ..stats.accumulators import DeviceAnalytics, summary_host
from .artifacts import (artifact_kinds, render_all, render_generic,
                        render_rungs, render_start)
from .config import ExperimentConfig

FAMILIES = ("sec11", "frank", "kpair", "tri", "hex", "temper", "dual")


class CheckpointIdentityError(RuntimeError):
    """A checkpoint exists for this tag but was written under a different
    kernel path or Spec: the state fields on disk don't cover the fields
    the current run's state template needs. Resuming would silently mix
    two walks, so this refuses loudly and names both sides plus the
    remedy. (The port's copy of the JAX package's
    ``resilience/errors.py`` class.)"""

    def __init__(self, tag: str, expected_fields, found_fields,
                 identity: str = ""):
        self.tag = tag
        self.expected_fields = tuple(sorted(expected_fields))
        self.found_fields = tuple(sorted(found_fields))
        self.identity = identity
        missing = sorted(set(self.expected_fields)
                         - set(self.found_fields))
        super().__init__(
            f"checkpoint for {tag!r} was written by a different kernel "
            f"path or Spec: it carries state fields "
            f"{list(self.found_fields)} but the current run's state "
            f"template needs {list(self.expected_fields)} "
            f"(missing: {missing}). Remedy: delete the checkpoint "
            f"(fresh start) or rerun under the config that wrote it "
            f"(identity {identity!r}).")


class _SegmentStop(RuntimeError):
    """Raised by _run_torch when _stop_after_segments simulates a crash."""

    def __init__(self, done):
        super().__init__(f"stopped after {done} steps")
        self.done = done


def _check_ported(cfg: ExperimentConfig) -> None:
    """Refuse what this package has not ported, before any work."""
    if cfg.backend != "torch":
        raise ValueError(f"backend {cfg.backend!r}: this package runs "
                         "'torch' only (the python oracle stays in the JAX "
                         "package)")
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r}")
    if cfg.chain not in ("flip", "recom"):
        raise ValueError(f"chain {cfg.chain!r}")
    if cfg.analytics not in ("history", "summary"):
        raise ValueError(f"analytics {cfg.analytics!r}")


def _check_summary(cfg: ExperimentConfig, checkpoint_dir) -> None:
    """The JAX driver's refusals of summary mode, in its words."""
    if cfg.analytics != "summary":
        return
    if checkpoint_dir:
        raise ValueError(
            "analytics='summary' keeps histories on device, so "
            "there is no host history to checkpoint; resumable runs "
            "need analytics='history' (checkpoint_every may still "
            "segment a summary run — it then only sets the control "
            "consult grid)")
    if cfg.record_every != 1:
        raise ValueError(
            "analytics='summary' folds every yield on device; "
            "record_every > 1 only thins a host history that "
            "summary mode never materializes")
    if cfg.chain == "recom":
        raise ValueError(
            "analytics='summary' covers the flip-walk runners "
            "(board/general); the recom chain stays on the "
            "history oracle path")


def build_graph_and_plan(cfg: ExperimentConfig):
    """(graph, initial plan, GeoAttributes or None) for a config: the JAX
    package's triple, whose geometry slot only the dual family fills. The
    temper family runs the Frankengraph (its B333 cell is the slow-mixing
    regime the ladder exists for)."""
    if cfg.family == "sec11":
        g = grid_sec11()
        return g, sec11_plan(g, cfg.alignment), None
    if cfg.family in ("frank", "temper"):
        g = frankengraph()
        return g, frank_plan(g, cfg.alignment), None
    if cfg.family == "kpair":
        g = square_grid(cfg.grid, cfg.grid)
        return g, stripes_plan(g, cfg.n_districts, axis=cfg.alignment), None
    if cfg.family == "tri":
        g = triangular_lattice(cfg.lattice_m, cfg.lattice_n)
        return g, stripes_plan(g, 2, axis=cfg.alignment), None
    if cfg.family == "hex":
        g = hex_lattice(cfg.lattice_m, cfg.lattice_n)
        return g, stripes_plan(g, 2, axis=cfg.alignment), None
    if cfg.family == "dual":
        if cfg.dual_source == "voronoi":
            fc = voronoi_precincts(cfg.dual_nx * cfg.dual_ny, seed=cfg.seed)
        elif cfg.dual_source == "quads":
            fc = synthetic_precincts(cfg.dual_nx, cfg.dual_ny,
                                     seed=cfg.seed)
        elif cfg.dual_source == "fixture":
            from ..workloads.data import load_fixture
            fc = load_fixture()
        else:
            raise ValueError(f"dual_source {cfg.dual_source!r}")
        g, geo = from_geojson(fc, pop_property="POP")
        return g, stripes_plan(g, cfg.n_districts, axis=cfg.alignment), geo
    _check_ported(cfg)          # raises, naming the ROADMAP item
    raise ValueError(f"family {cfg.family!r}")


def spec_for(cfg: ExperimentConfig) -> Spec:
    """The kernel Spec a family's walk runs under: sec11 and frank keep
    the reference's full metric set, the wall-interface slopes included;
    temper, tri and hex record no interface; kpair runs the k-district
    pair walk (slow_reversible_propose, grid_chain_sec11.py:117-130);
    dual runs it (the 2-district 'bi' walk at k = 2) on boundary length
    (``weighted_cut``). ``cfg.variant`` maps onto the Spec's
    proposal-variant flags last."""
    _check_ported(cfg)
    common = dict(contiguity=cfg.contiguity, invalid="repropose",
                  parity_metrics=True, geom_waits=True,
                  propose_parallel=cfg.propose_parallel)
    if cfg.family == "kpair":
        spec = Spec(n_districts=cfg.n_districts, proposal="pair",
                    accept="cut", record_interface=False, **common)
    elif cfg.family == "dual":
        spec = Spec(n_districts=cfg.n_districts,
                    proposal="pair" if cfg.n_districts > 2 else "bi",
                    accept="cut", weighted_cut=True,
                    record_interface=False, **common)
    else:
        spec = Spec(n_districts=2, proposal="bi", accept=cfg.accept,
                    record_interface=cfg.family in ("sec11", "frank"),
                    **common)
    if cfg.variant == "none":
        return spec
    if cfg.variant == "nobacktrack":
        if spec.proposal != "bi":
            raise ValueError(
                f"variant 'nobacktrack' needs the 2-district 'bi' walk; "
                f"family {cfg.family!r} with k={cfg.n_districts} runs "
                f"{spec.proposal!r}")
        return dataclasses.replace(spec, nobacktrack=True)
    if cfg.variant == "lazy":
        return dataclasses.replace(spec, lazy_uniform=True)
    raise ValueError(f"variant {cfg.variant!r}")


def _labels_for(cfg: ExperimentConfig) -> np.ndarray:
    """District -> rendered value: the reference's +1/-1 for 2 districts,
    district ids for k > 2."""
    if cfg.n_districts == 2:
        return np.asarray(PARITY_LABELS)
    return np.arange(cfg.n_districts, dtype=np.int32)


def is_done(cfg: ExperimentConfig, outdir: str) -> bool:
    return all(os.path.exists(os.path.join(outdir, cfg.tag + k))
               for k in artifact_kinds(cfg.family))


def count_artifacts(cfg: ExperimentConfig, outdir: str) -> int:
    """How many of a config's manifest artifacts exist on disk."""
    return sum(os.path.exists(os.path.join(outdir, cfg.tag + k))
               for k in artifact_kinds(cfg.family))


def _init_run(cfg: ExperimentConfig, g, plan, spec: Spec, device):
    """(use_board, (graph handle, state, StepParams)) on ``device``: the
    board path where ``kernel.board.supports`` holds and the chain is the
    flip walk, on the lowered-chunk kernel or, under 'pair', the board
    pair kernel (ValueError where that kernel does not serve the spec),
    else the general runner's triple (ReCom's on any graph, as in the JAX
    driver).
    The temper family's triple is ``init_tempered``'s (its ladders'
    chains)."""
    if cfg.family == "temper":
        _check_temper(cfg)
        handle, states, params = init_tempered(
            g, plan, betas=cfg.betas, n_ladders=cfg.n_chains, seed=cfg.seed,
            spec=spec, base=cfg.base, pop_tol=cfg.pop_tol, device=device)
        use_board = isinstance(states, kboard.BoardState)
    elif cfg.chain != "flip" or not kboard.supports(g, spec):
        return False, init_batch(g, plan, n_chains=cfg.n_chains,
                                 seed=cfg.seed, spec=spec, base=cfg.base,
                                 pop_tol=cfg.pop_tol, device=device)
    else:
        use_board = True
        handle, states, params = init_board(
            g, plan, n_chains=cfg.n_chains, seed=cfg.seed, spec=spec,
            base=cfg.base, pop_tol=cfg.pop_tol, device=device)
    if use_board and not chunk_module(spec).supports(handle, spec):
        raise ValueError(
            f"{cfg.tag}: the board path's chunk kernel does not serve "
            f"{spec}; its accept rules and annealing wait for ROADMAP.md B4")
    return use_board, (handle, states, params)


def _check_temper(cfg: ExperimentConfig) -> None:
    """The temper family's own requirements, in the JAX driver's words."""
    if not cfg.betas:
        raise ValueError("temper family needs cfg.betas")
    if cfg.checkpoint_every and cfg.checkpoint_every % cfg.swap_every:
        raise ValueError(
            f"checkpoint_every ({cfg.checkpoint_every}) must be a "
            f"multiple of swap_every ({cfg.swap_every}): segments are "
            f"whole swap rounds")


def run_config(cfg: ExperimentConfig, outdir: str,
               checkpoint_dir: Optional[str] = None,
               device="cuda") -> dict:
    """Run one config on ``device`` and write its artifacts to
    ``outdir``. Returns the run's data: the JAX package's keys, plus
    ``seconds`` (the chains, from the first segment to the assembled
    result) and ``render_seconds`` (the artifacts)."""
    dev = resolve_device(device)
    _check_summary(cfg, checkpoint_dir)
    _check_ported(cfg)
    g, plan, geo = build_graph_and_plan(cfg)
    spec = spec_for(cfg)
    run = _init_run(cfg, g, plan, spec, dev)
    os.makedirs(outdir, exist_ok=True)
    pos = geo.centroid if geo is not None else None
    t_r = time.monotonic()
    render_start(g, outdir, cfg.tag, _labels_for(cfg)[plan], pos=pos)
    render_s = time.monotonic() - t_r
    t0 = time.monotonic()
    if cfg.family == "temper":
        data = _run_temper(cfg, g, plan, checkpoint_dir, device=dev, run=run)
    else:
        data = _run_torch(cfg, g, plan, checkpoint_dir, device=dev, run=run)
    data["seconds"] = time.monotonic() - t0
    if cfg.n_districts == 2 or cfg.family == "dual":
        data["partisan"] = _partisan_summary(cfg, g, data)
    t_r = time.monotonic()
    if cfg.family in ("sec11", "frank"):
        render_all(g, cfg.family, outdir, cfg.tag,
                   end_signed=data["end_signed"],
                   cut_times=data["cut_times"], part_sum=data["part_sum"],
                   num_flips=data["num_flips"], slopes=data["slopes"],
                   angles=data["angles"], waits_sum=data["waits_sum"])
    else:
        render_generic(g, outdir, cfg.tag, kinds=artifact_kinds(cfg.family),
                       end_signed=data["end_signed"],
                       cut_times=data["cut_times"],
                       num_flips=data["num_flips"],
                       part_sum=data["part_sum"],
                       waits_sum=data["waits_sum"], pos=pos,
                       family=cfg.family)
    if cfg.family == "dual":
        _write_dual_scores(cfg, g, geo, plan, data, outdir)
    if cfg.family == "temper":
        j = lambda kind: os.path.join(outdir, cfg.tag + kind)
        render_rungs(j("rungs.png"), data["rung_cut"], cfg.betas)
        with open(j("swapstats.json"), "w") as f:
            json.dump(data["swapstats"], f, indent=1)
    data["render_seconds"] = render_s + time.monotonic() - t_r
    return data


def _write_dual_scores(cfg: ExperimentConfig, g, geo, plan, data,
                       outdir: str) -> None:
    """The dual family's own artifacts, as the JAX driver writes them:
    Polsby-Popper compactness of every chain's final plan and of the
    initial plan (``compactness.json``), and the partisan summary
    (``partisan.json``)."""
    j = lambda kind: os.path.join(outdir, cfg.tag + kind)
    geom = dict(edges=g.edges, shared_perim=geo.shared_perim,
                node_area=geo.area, node_exterior_perim=geo.exterior_perim)
    pp = polsby_popper(np.asarray(data["assignments"]), cfg.n_districts,
                       **geom)
    data["polsby_popper"] = pp
    with open(j("compactness.json"), "w") as f:
        json.dump({
            "polsby_popper_per_chain_mean": pp.mean(axis=1).tolist(),
            "polsby_popper_batch_mean": float(pp.mean()),
            "initial": polsby_popper(np.asarray(plan)[None],
                                     cfg.n_districts, **geom
                                     ).mean(axis=1).tolist(),
        }, f, indent=1)
    with open(j("partisan.json"), "w") as f:
        json.dump({k: (v.tolist() if hasattr(v, "tolist") else v)
                   for k, v in data["partisan"].items()}, f, indent=1)


def _run_torch(cfg: ExperimentConfig, g, plan, checkpoint_dir=None,
               _stop_after_segments: Optional[int] = None, device="cuda",
               run=None) -> dict:
    """The batched run, in checkpoint segments when cfg.checkpoint_every
    > 0, a checkpoint after each. The board path runs
    ``run_board_segment`` per segment (its history kept on the device and
    copied to the host once a segment), then the final record; the
    general path runs ``run_chains`` per segment, the first recording the
    initial state. The segmented run equals an uninterrupted one bit for
    bit: the PRNG keys live in the chain state. ``_stop_after_segments``
    simulates an interruption for tests; ``run`` is ``_init_run``'s pair
    when the caller made it already. In summary mode (``cfg.analytics``)
    the runners fold on the card and keep no history; the data gains
    ``summary`` and ``readback_bytes``."""
    dev = resolve_device(device)
    _check_summary(cfg, checkpoint_dir)
    spec = spec_for(cfg)
    use_board, (handle, states, params) = (
        run if run is not None else _init_run(cfg, g, plan, spec, dev))
    summary_mode = cfg.analytics == "summary"
    analytics = None
    if summary_mode:
        series_keys = ("slope", "angle") if spec.record_interface else ()
        analytics = DeviceAnalytics(
            cfg.n_chains, observable="cut_count", series_keys=series_keys,
            series_cap=cfg.total_steps if series_keys else 0, device=dev)
    done = 0   # transitions advanced (board) / yields recorded (general)
    n_parts = 0
    hist_parts: dict = {}
    waits_total = np.zeros(cfg.n_chains, np.float64)
    resumed = _load_resume(checkpoint_dir, cfg, states)
    if resumed is not None:
        done, n_parts, states, hist_parts, waits_total, _ = resumed

    every = cfg.checkpoint_every or cfg.total_steps
    if (cfg.checkpoint_every and cfg.record_every > 1
            and cfg.checkpoint_every % cfg.record_every):
        raise ValueError(
            f"checkpoint_every ({cfg.checkpoint_every}) must be a "
            f"multiple of record_every ({cfg.record_every}): each segment "
            f"thins relative to its own start, so off-grid segment "
            f"boundaries would silently skew the recorded time grid")
    total = cfg.total_steps - (1 if use_board else 0)
    segments = 0
    while done < total:
        n = min(every, total - done)
        if use_board:
            res = run_board_segment(handle, spec, params, states, n,
                                    record_history=not summary_mode,
                                    record_every=cfg.record_every,
                                    history_device=True, device=dev,
                                    analytics=analytics)
        elif cfg.chain == "recom":
            # the JAX driver's knobs: epsilon is the config's population
            # tolerance, the target the ideal district population
            res = run_recom(handle, spec, params, states, n_steps=n,
                            record_initial=(done == 0),
                            record_every=cfg.record_every,
                            history_device=True, epsilon=cfg.pop_tol,
                            pop_target=float(np.asarray(g.pop).sum())
                            / cfg.n_districts)
        else:
            res = run_chains(handle, spec, params, states, n_steps=n,
                             record_history=not summary_mode,
                             record_initial=(done == 0),
                             record_every=cfg.record_every,
                             history_device=True, analytics=analytics)
        states = res.state
        seg_hist = {k: v.cpu().numpy() for k, v in res.history.items()}
        for k, v in seg_hist.items():
            hist_parts.setdefault(k, []).append(v)
        waits_total += res.waits_total
        done += n
        segments += 1
        if checkpoint_dir:
            n_parts = save_checkpoint(checkpoint_dir, cfg, states,
                                      done=done, waits_total=waits_total,
                                      new_hist=seg_hist, part_idx=n_parts)
        if _stop_after_segments and segments >= _stop_after_segments:
            raise _SegmentStop(done)

    if use_board:
        # the final yield (no trailing transition) and its wait bookkeeping
        res = finalize_board_run(handle, spec, params, states, hist_parts,
                                 waits_total, [], not summary_mode,
                                 cfg.total_steps, cfg.record_every,
                                 analytics=analytics)
        states, history, waits_total = (res.state, res.history,
                                        res.waits_total)
    else:
        history = {k: np.concatenate(v, axis=1)
                   for k, v in hist_parts.items()}
    if analytics is not None:
        # chain 0's interface series, folded on the card, read back once:
        # the (1, T) arrays the history mode would hand the renderers
        history = dict(history)
        for k, v in analytics.series_host().items():
            history[k] = v[None, :]
    data = assemble_run_data(cfg, g, handle, states, history, waits_total,
                             use_board=use_board)
    if analytics is not None:
        data["summary"] = summary_host(analytics.summary_refs())
        data["readback_bytes"] = analytics.readback_bytes
    return data


def _run_temper(cfg: ExperimentConfig, g, plan, checkpoint_dir=None,
                _stop_after_segments: Optional[int] = None, device="cuda",
                run=None) -> dict:
    """The temper family: ``cfg.n_chains`` LADDERS of ``len(cfg.betas)``
    rungs each (the batch is n_chains * n_rungs chains), a swap round
    every ``swap_every`` transitions. The artifacts follow the chain that
    ENDS holding beta = betas[0] in ladder 0; the per-rung trajectory
    plot and the swap rates come from the reconstructed rung histories (a
    chain's own accumulators mix temperatures by design). Runs in
    segments of whole rounds (``_run_temper_segmented``): one segment
    unless checkpointed."""
    dev = resolve_device(device)
    _check_temper(cfg)
    spec = spec_for(cfg)
    labels = _labels_for(cfg)
    _, (handle, states, params) = (
        run if run is not None else _init_run(cfg, g, plan, spec, dev))
    n_rungs = len(cfg.betas)
    res = _run_temper_segmented(cfg, handle, spec, params, states,
                                checkpoint_dir, _stop_after_segments)
    s = to_numpy(res.state)
    # the PHYSICAL (beta = betas[0]) chain of each ladder: swaps permute
    # betas, so the cold chain's batch row differs per ladder at run end
    beta_lr = res.params.beta.cpu().numpy().reshape(cfg.n_chains, n_rungs)
    cold_rows = (np.arange(cfg.n_chains) * n_rungs
                 + np.argmax(beta_lr == np.float32(cfg.betas[0]), axis=1))
    cold = int(cold_rows[0])
    if isinstance(res.state, kboard.BoardState):
        assign_c = kboard.node_view(handle, s["board"][cold]).astype(
            np.int64)
        cut_times_c = kboard.edge_cut_times(g, res.state)[cold]
        assignments = kboard.node_view(handle, s["board"])[cold_rows]
        cc = SimpleNamespace(
            part_sum=kboard.node_view(handle, s["part_sum"][cold]),
            last_flipped=kboard.node_view(handle, s["last_flipped"][cold]),
            num_flips=kboard.node_view(handle, s["num_flips"][cold]))
    else:
        assign_c = s["assignment"][cold].astype(np.int64)
        cut_times_c = s["cut_times"][cold]
        assignments = s["assignment"][cold_rows]
        cc = SimpleNamespace(part_sum=s["part_sum"][cold],
                             last_flipped=s["last_flipped"][cold],
                             num_flips=s["num_flips"][cold])
    part_sum, _ = finalize_host(cc, labels, cfg.total_steps,
                                assignment=assign_c)
    return {
        "end_signed": labels[assign_c],
        "cut_times": cut_times_c,
        "part_sum": part_sum,
        "num_flips": np.asarray(cc.num_flips),
        "slopes": None,
        "angles": None,
        "waits_sum": float(res.waits_total[cold]),
        "history": res.history,
        "waits_all": res.waits_total,
        "state": s,
        # one physical plan per ladder (partisan summaries must not mix in
        # hot-rung plans)
        "assignments": assignments,
        "rung_cut": per_rung_history(res, "cut_count")[:, 0, :],
        "swapstats": {
            # pair r exchanges the chains holding the (r+1)-th and
            # (r+2)-th LARGEST betas (the rank follows the temperature)
            "betas": list(map(float, cfg.betas)),
            "betas_by_rank": sorted(map(float, cfg.betas), reverse=True),
            "swap_every": cfg.swap_every,
            "attempts": res.swap_attempts.tolist(),
            "accepts": res.swap_accepts.tolist(),
            "rates": res.swap_rates().tolist(),
        },
    }


def _run_temper_segmented(cfg: ExperimentConfig, handle, spec, params,
                          states, checkpoint_dir,
                          _stop_after_segments=None) -> TemperResult:
    """The temper run: whole-round segments through
    ``run_tempered(segment=True)`` (one segment when ``checkpoint_every``
    is 0), the ladder's continuation state
    (exchanged betas, swap key and parity, pair statistics) in the
    checkpoint's extra_* arrays, the per-round beta assignment saved as a
    history part (transposed to the (C, T) part layout). Resumes bit for
    bit: the chain keys live in the state, the swap key and parity in the
    extras."""
    n_rungs = len(cfg.betas)
    c = cfg.n_chains * n_rungs
    dev = states.cut_count.device
    done = 0                     # transitions advanced
    n_parts = 0
    hist_parts: dict = {}
    waits_total = np.zeros(c, np.float64)
    attempts = np.zeros(n_rungs - 1, np.int64)
    accepts = np.zeros(n_rungs - 1, np.int64)
    parity = 0
    swap_key = rng.prng_key(cfg.seed, device=dev)
    resumed = _load_resume(checkpoint_dir, cfg, states)
    if resumed is not None:
        done, n_parts, states, hist_parts, waits_total, ex = resumed
        params = dataclasses.replace(params, beta=torch.as_tensor(
            ex["beta"], dtype=torch.float32, device=dev))
        attempts = ex["swap_attempts"].copy()
        accepts = ex["swap_accepts"].copy()
        parity = int(ex["parity"])
        swap_key = torch.as_tensor(ex["swap_key"].astype(np.int64),
                                   device=dev)

    every = cfg.checkpoint_every or (cfg.total_steps - 1)
    total = cfg.total_steps - 1
    segments = 0
    # a one-yield run (total 0) still takes its one, empty, segment
    while done < total or not hist_parts:
        n = min(every, total - done)
        last = done + n >= total
        res = run_tempered(
            handle, spec, params, states,
            n_steps=(n + 1 if last else n), betas=cfg.betas,
            n_ladders=cfg.n_chains, swap_every=cfg.swap_every,
            record_every=cfg.record_every, segment=not last,
            record_initial=(done == 0), start_parity=parity,
            swap_key=swap_key)
        states, params = res.state, res.params
        parity, swap_key = res.end_parity, res.end_swap_key
        seg_hist = dict(res.history)
        seg_hist["beta_hist"] = res.beta_hist.T       # (C, rounds) part
        for k, v in seg_hist.items():
            hist_parts.setdefault(k, []).append(v)
        waits_total += res.waits_total
        attempts += res.swap_attempts
        accepts += res.swap_accepts
        done += n
        segments += 1
        if checkpoint_dir:
            n_parts = save_checkpoint(
                checkpoint_dir, cfg, states, done=done,
                waits_total=waits_total, new_hist=seg_hist,
                part_idx=n_parts,
                extra={"beta": params.beta.cpu().numpy(),
                       "swap_attempts": attempts,
                       "swap_accepts": accepts,
                       "parity": np.int64(parity),
                       "swap_key": swap_key.cpu().numpy().astype(
                           np.uint32)})
        if _stop_after_segments and segments >= _stop_after_segments:
            raise _SegmentStop(done)

    history = {k: np.concatenate(v, axis=1) for k, v in hist_parts.items()}
    beta_hist = history.pop("beta_hist").T            # (rounds, C)
    return TemperResult(
        state=states, history=history, waits_total=waits_total,
        n_yields=cfg.total_steps, params=params,
        betas=np.asarray(cfg.betas, np.float64), n_rungs=n_rungs,
        swap_every=cfg.swap_every, record_every=cfg.record_every,
        general_initial=not isinstance(states, kboard.BoardState),
        beta_hist=beta_hist, swap_attempts=attempts, swap_accepts=accepts,
        end_parity=parity, end_swap_key=swap_key)


def assemble_run_data(cfg: ExperimentConfig, g, handle, states,
                      history: dict, waits_total,
                      use_board: bool = True) -> dict:
    """The run epilogue: host readback, canvas -> node order on the board
    path (lowered canvases carry hole cells that must not reach the
    artifacts), and the reference's final-accumulator bookkeeping
    (finalize_host, with the reference's t after the loop,
    grid_chain_sec11.py:402). ``state`` in the result holds the final
    state's fields as numpy arrays."""
    labels = _labels_for(cfg)
    s = to_numpy(states)
    if use_board:
        assign0 = kboard.node_view(handle, s["board"][0]).astype(np.int64)
        c0 = SimpleNamespace(
            part_sum=kboard.node_view(handle, s["part_sum"][0]),
            last_flipped=kboard.node_view(handle, s["last_flipped"][0]),
            num_flips=kboard.node_view(handle, s["num_flips"][0]))
        cut_times = kboard.edge_cut_times(g, states)[0]
        assignments = kboard.node_view(handle, s["board"])
    else:
        assign0 = s["assignment"][0].astype(np.int64)
        c0 = SimpleNamespace(part_sum=s["part_sum"][0],
                             last_flipped=s["last_flipped"][0],
                             num_flips=s["num_flips"][0])
        cut_times = s["cut_times"][0]
        assignments = s["assignment"]
    part_sum, _ = finalize_host(c0, labels, cfg.total_steps,
                                assignment=assign0)
    return {
        "end_signed": labels[assign0],
        "cut_times": cut_times,
        "part_sum": part_sum,
        "num_flips": np.asarray(c0.num_flips),
        "slopes": history["slope"][0] if "slope" in history else None,
        "angles": history["angle"][0] if "angle" in history else None,
        "waits_sum": float(waits_total[0]),
        "history": history,
        "waits_all": waits_total,
        "state": s,
        "assignments": assignments,
    }


def _partisan_summary(cfg: ExperimentConfig, g, data) -> dict:
    """Election scores over every chain's final plan, from the
    reference's Bernoulli(1/2) pink/purple vote attributes
    (grid_chain_sec11.py:223-228; Election wiring of line 307); the
    votes are alignment-validated against the graph before tallying."""
    votes = validate_votes(g, seed_votes(g, cfg.seed))
    tallies = partisan.district_vote_tallies(
        np.asarray(data["assignments"]), votes, k=cfg.n_districts)
    return {
        "mean_median": partisan.mean_median(tallies),
        "efficiency_gap": partisan.efficiency_gap(tallies),
        "seats_pink": partisan.seats_won(tallies),
    }


def run_sweep(configs, outdir: str, checkpoint_dir: Optional[str] = None,
              verbose: bool = True, device="cuda") -> list:
    """The bare fail-fast sweep with skip-if-done resume: a config whose
    artifacts all exist is skipped; the first failure propagates. Returns
    [(cfg, data)] of the configs run. A config this package has not
    ported is refused before any config runs."""
    configs = list(configs)
    for cfg in configs:
        _check_ported(cfg)
    results = []
    for cfg in configs:
        if is_done(cfg, outdir):
            if verbose:
                print(f"[skip] {cfg.family} {cfg.tag} (artifacts complete)")
            continue
        t0 = time.monotonic()
        data = run_config(cfg, outdir, checkpoint_dir, device=device)
        if verbose:
            print(f"[done] {cfg.family} {cfg.tag} "
                  f"waits={data['waits_sum']:.4g} "
                  f"({time.monotonic() - t0:.1f}s)", flush=True)
        results.append((cfg, data))
    return results


# ---------------------------------------------------------------------------
# Checkpoints (the JAX package's on-disk format)
# ---------------------------------------------------------------------------

def _state_from_arrays(template, loaded: dict, tag: str = "",
                       identity: str = ""):
    """Rebuild a chain state from checkpoint arrays, each cast to the
    dtype and device of the freshly initialised ``template``'s field. A
    template field missing from the checkpoint means it was written by a
    different kernel path: raise CheckpointIdentityError naming both
    field sets and the remedy instead of resuming corrupt state."""
    names = [f.name for f in dataclasses.fields(template)]
    found = [k[len("state_"):] for k in loaded if k.startswith("state_")]
    expected = [f for f in names if getattr(template, f) is not None]
    if set(expected) - set(found):
        raise CheckpointIdentityError(tag, expected, found,
                                      identity=identity)
    fields = {}
    for f in names:
        t = getattr(template, f)
        if t is None:
            fields[f] = None
            continue
        arr = np.asarray(loaded[f"state_{f}"])
        if arr.dtype == np.uint32:      # the key words
            arr = arr.astype(np.int64)
        fields[f] = torch.as_tensor(arr).to(device=t.device, dtype=t.dtype)
    return type(template)(**fields)


def _load_resume(checkpoint_dir, cfg: ExperimentConfig, states_template):
    """None for a fresh start, else (done, n_parts, states, hist_parts,
    waits_total, extras), ``extras`` the runner's extra_* continuation
    arrays (the temper family's ladder state). A state-field mismatch
    raises ``CheckpointIdentityError``."""
    if not checkpoint_dir:
        return None
    loaded = load_checkpoint(checkpoint_dir, cfg)
    if loaded is None:
        return None
    states = _state_from_arrays(states_template, loaded, tag=cfg.tag,
                                identity=_ckpt_identity(cfg))
    return (int(loaded["meta_done"]),
            int(loaded["meta_n_parts"]),
            states,
            {k[len("hist_"):]: [v] for k, v in loaded.items()
             if k.startswith("hist_")},
            loaded["meta_waits_total"].copy(),
            {k[len("extra_"):]: v for k, v in loaded.items()
             if k.startswith("extra_")})


def _ckpt_identity(cfg: ExperimentConfig) -> str:
    """Everything the tag does not encode (or encodes lossily: the tag
    truncates base/pop_tol to int(100*x)) but resume correctness needs;
    the JAX package's string, so checkpoints move between the packages."""
    return (f"{cfg.family}|steps={cfg.total_steps}|chains={cfg.n_chains}|"
            f"seed={cfg.seed}|contiguity={cfg.contiguity}|"
            f"accept={cfg.accept}|base={cfg.base!r}|pop={cfg.pop_tol!r}|"
            f"kp={cfg.propose_parallel}|k={cfg.n_districts}|"
            f"grid={cfg.grid}|lat={cfg.lattice_m}x{cfg.lattice_n}|"
            f"dual={cfg.dual_nx}x{cfg.dual_ny}"
            f"{'' if cfg.dual_source == 'quads' else '@' + cfg.dual_source}|"
            f"re={cfg.record_every}|"
            f"betas={tuple(map(float, cfg.betas))!r}|"
            f"se={cfg.swap_every}"
            + ("" if cfg.chain == "flip" else f"|chain={cfg.chain}")
            + ("" if cfg.variant == "none" else f"|var={cfg.variant}"))


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 20), b""):
            h.update(blk)
    return h.hexdigest()


def _fsync_dir(d: str):
    """Durably commit a rename: fsync the containing directory (a no-op
    where the platform or filesystem refuses directory fds)."""
    try:
        fd = os.open(d or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        return
    finally:
        os.close(fd)


def _write_npz(path: str, arrays: dict) -> str:
    """write-to-temp + fsync + atomic rename; returns the SHA-256 of the
    bytes written (hashed on the temp file, so any later divergence of
    the renamed file is detectable)."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    digest = _sha256_file(tmp)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    return digest


def _read_npz(path: str) -> Optional[dict]:
    """dict of arrays, or None when the file is unreadable (truncated,
    bit-rotted, not an npz): integrity handling must never crash."""
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None


def _manifest_path(ckpt_dir: str, cfg: ExperimentConfig) -> str:
    return os.path.join(ckpt_dir, cfg.tag + ".manifest.json")


def _load_manifest(ckpt_dir: str, cfg: ExperimentConfig):
    mpath = _manifest_path(ckpt_dir, cfg)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, encoding="utf-8") as f:
            man = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or man.get("version") != 1:
        return None
    man.setdefault("gen", -1)
    man.setdefault("current", None)
    man.setdefault("previous", None)
    man.setdefault("parts", {})
    return man


def _write_manifest(ckpt_dir: str, cfg: ExperimentConfig, man: dict):
    mpath = _manifest_path(ckpt_dir, cfg)
    tmp = mpath + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(man, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mpath)
    _fsync_dir(ckpt_dir)


def _state_arrays(state) -> dict:
    """A chain state's fields as checkpoint arrays in the JAX package's
    dtypes (the key words as uint32); None fields are omitted."""
    arrays = {f"state_{k}": v for k, v in to_numpy(state).items()}
    arrays["state_key"] = arrays["state_key"].astype(np.uint32)
    return arrays


def save_checkpoint(ckpt_dir: str, cfg: ExperimentConfig, state,
                    done: int = 0, waits_total=None, new_hist=None,
                    part_idx: int = 0, extra: Optional[dict] = None) -> int:
    """Per-config checkpoint: ``<tag>.npz`` holds the chain state
    (state_*) and progress + config identity (meta_*); each segment's
    history goes to its own ``<tag>.h<k>.npz`` part file, so a save costs
    O(segment), not O(run so far). The main file is written atomically
    after its part, so meta_n_parts never points at a missing file;
    ``extra`` adds a runner's continuation arrays (extra_*, the temper
    family's ladder state). Returns the next part index.

    Every file goes through write-to-temp + fsync + atomic rename and its
    SHA-256 lands in ``<tag>.manifest.json``; the manifest keeps the last
    two generations (before each save the old main rotates to
    ``<tag>.prev.npz``), so ``load_checkpoint`` can fall back one
    generation when the newest fails verification."""
    os.makedirs(ckpt_dir, exist_ok=True)
    man = _load_manifest(ckpt_dir, cfg)
    if man is None:
        man = {"version": 1, "tag": cfg.tag, "gen": -1,
               "current": None, "previous": None, "parts": {}}
    if new_hist:
        pname = f"{cfg.tag}.h{part_idx:04d}.npz"
        man["parts"][pname] = _write_npz(
            os.path.join(ckpt_dir, pname),
            {k: np.asarray(v) for k, v in new_hist.items()})
        part_idx += 1
    arrays = _state_arrays(state)
    arrays["meta_done"] = np.int64(done)
    arrays["meta_n_parts"] = np.int64(part_idx)
    arrays["meta_identity"] = np.array(_ckpt_identity(cfg))
    if waits_total is not None:
        arrays["meta_waits_total"] = np.asarray(waits_total, np.float64)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    path = os.path.join(ckpt_dir, cfg.tag + ".npz")
    prev_path = os.path.join(ckpt_dir, cfg.tag + ".prev.npz")
    cur = man["current"]
    if cur is not None:
        cur_path = os.path.join(ckpt_dir, cur["file"])
        if os.path.exists(cur_path):
            if os.path.abspath(cur_path) == os.path.abspath(path):
                os.replace(cur_path, prev_path)
                cur = dict(cur, file=os.path.basename(prev_path))
            # else: current already sits at the .prev slot (a
            # post-fallback resume) and simply stays the fallback
            man["previous"] = cur
    digest = _write_npz(path, arrays)
    man["gen"] += 1
    man["current"] = {"gen": man["gen"], "file": cfg.tag + ".npz",
                      "sha256": digest, "done": int(done),
                      "n_parts": int(part_idx)}
    _write_manifest(ckpt_dir, cfg, man)
    return part_idx


def _meta_checks(cfg: ExperimentConfig, d: dict, path: str) -> bool:
    """Format, identity and progress validation of a loaded main file:
    the 'is this checkpoint for this run' gate (a mismatch means a fresh
    start, never a generation fallback)."""
    if "meta_done" not in d or "meta_identity" not in d:
        print(f"[ckpt] ignoring {path}: unrecognized format")
        return False
    if str(d["meta_identity"]) != _ckpt_identity(cfg):
        print(f"[ckpt] ignoring {path}: config mismatch "
              f"({d['meta_identity']} != {_ckpt_identity(cfg)})")
        return False
    if int(d["meta_done"]) > cfg.total_steps:
        print(f"[ckpt] ignoring {path}: more steps than requested")
        return False
    return True


def _read_parts(ckpt_dir: str, cfg: ExperimentConfig, n_parts: int,
                man: Optional[dict]):
    """The history parts 0..n_parts-1 concatenated along T: (hist, None,
    None), or (None, reason, bad path) for the first part that is
    missing, fails its manifest checksum or does not read."""
    hist: dict = {}
    for k in range(n_parts):
        pname = f"{cfg.tag}.h{k:04d}.npz"
        ppath = os.path.join(ckpt_dir, pname)
        if not os.path.exists(ppath):
            return None, f"missing part {pname}", ppath
        want = man["parts"].get(pname) if man is not None else None
        if want is not None and _sha256_file(ppath) != want:
            return None, f"part {pname} checksum mismatch", ppath
        pd = _read_npz(ppath)
        if pd is None:
            return None, f"unreadable part {pname}", ppath
        for name, arr in pd.items():
            hist.setdefault(name, []).append(arr)
    return ({f"hist_{name}": np.concatenate(parts, axis=1)
             for name, parts in hist.items()}, None, None)


def _generation_payload(ckpt_dir, cfg, man, entry):
    """Verify + load one manifest generation. Returns (d, None, None) on
    success (parts concatenated into hist_*), else (None, reason,
    bad_path) naming the file that failed."""
    epath = os.path.join(ckpt_dir, entry["file"])
    if not os.path.exists(epath):
        return None, "missing main file", epath
    if _sha256_file(epath) != entry["sha256"]:
        return None, "main file checksum mismatch", epath
    d = _read_npz(epath)
    if d is None:
        return None, "unreadable main file", epath
    hist, reason, bad = _read_parts(ckpt_dir, cfg, int(entry["n_parts"]),
                                    man)
    if hist is None:
        return None, reason, bad
    d.update(hist)
    return d, None, None


def _quarantine_generation(ckpt_dir, cfg, man, entry, reason, bad_path):
    """A generation failed verification: move its main file (and the
    specific bad file) into ``.corrupt/`` and promote the previous
    generation to current. Shared history parts the fallback generation
    still references are left in place (if the bad file is shared, the
    fallback fails its own check next and resume degrades to a fresh
    start, never a crash)."""
    cdir = os.path.join(ckpt_dir, ".corrupt")
    os.makedirs(cdir, exist_ok=True)
    prev = man.get("previous")
    prev_parts = int(prev["n_parts"]) if prev else 0
    moved = []
    epath = os.path.join(ckpt_dir, entry["file"])
    for k in range(prev_parts, int(entry["n_parts"])):
        pname = f"{cfg.tag}.h{k:04d}.npz"
        ppath = os.path.join(ckpt_dir, pname)
        if os.path.exists(ppath):
            moved.append(ppath)
        man["parts"].pop(pname, None)
    if bad_path and bad_path not in moved and os.path.exists(bad_path) \
            and bad_path != epath:
        moved.append(bad_path)
    if os.path.exists(epath):
        moved.append(epath)
    for src in moved:
        dst = os.path.join(
            cdir, f"g{int(entry['gen']):04d}.{os.path.basename(src)}")
        os.replace(src, dst)
    print(f"[ckpt] {cfg.tag}: generation {entry['gen']} corrupt "
          f"({reason}); quarantined {len(moved)} file(s) to {cdir}, "
          f"falling back to generation "
          f"{prev['gen'] if prev else 'none (fresh start)'}")
    man["current"] = prev
    man["previous"] = None
    _write_manifest(ckpt_dir, cfg, man)


def load_checkpoint(ckpt_dir: str, cfg: ExperimentConfig):
    """Load and validate a checkpoint; None (fresh start) when absent,
    written by an incompatible config, or in an unrecognized format: the
    recovery path must never crash on stale files.

    With a manifest present every generation is SHA-256-verified before
    use; a corrupt or truncated generation is quarantined to
    ``.corrupt/`` and the previous generation is tried instead.
    Checkpoints without a manifest load through the unverified path."""
    path = os.path.join(ckpt_dir, cfg.tag + ".npz")
    man = _load_manifest(ckpt_dir, cfg)
    if man is None:
        if not os.path.exists(path):
            return None
        d = _read_npz(path)
        if d is None:
            print(f"[ckpt] ignoring {path}: unreadable "
                  "(no manifest, no fallback generation)")
            return None
        if not _meta_checks(cfg, d, path):
            return None
        hist, reason, _ = _read_parts(ckpt_dir, cfg,
                                      int(d["meta_n_parts"]), None)
        if hist is None:
            print(f"[ckpt] ignoring {path}: {reason}")
            return None
        d.update(hist)
        return d
    while man["current"] is not None:
        entry = man["current"]
        d, reason, bad_path = _generation_payload(ckpt_dir, cfg, man,
                                                  entry)
        if d is None:
            _quarantine_generation(ckpt_dir, cfg, man, entry, reason,
                                   bad_path)
            continue
        epath = os.path.join(ckpt_dir, entry["file"])
        if not _meta_checks(cfg, d, epath):
            return None
        return d
    return None
