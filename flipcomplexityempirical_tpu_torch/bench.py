"""The port's benchmark: aggregate flip throughput of ``bench.py``'s board
and general paths, on the card.

    python -m flipcomplexityempirical_tpu_torch.bench
        [--graph square|sec11|frank|hex] [--pallas] [--general] [--cpu]
        [--grid N] [--k K] [--chains C] [--steps S] [--warmup W] [--chunk T]
        [--base B] [--pop-tol P] [--repeats R] [--body bits]
        [--ess [--ess-host] [--record-every K]]
    or: ... --service [--tenants N] [--chains C] [--steps S]
        [--graph sec11|frank] [--cpu]

The port of the root ``bench.py``'s default measurement, with its defaults:
2-district single-node-flip chains with the full reference semantics
(boundary proposal, re-propose on invalid, patch contiguity, population
bounds, the literal ``base**(-dcut)`` accept, geometric waits, parity
bookkeeping, no interface recording) on the 64 x 64 rook grid from a
stripes start (``--graph square``), the sec11 grid from
``sec11_plan(alignment=0)``, the Frankengraph from
``frank_plan(alignment=0)`` or the ``--grid`` x ``--grid`` hexagonal
lattice from a stripes start (``--graph hex``).

- Default, the board path: ``run_board`` on the lowered-chunk kernel, at
  8192 chains (4096 under ``--k``). On square it equals the JAX package's ``bitboard`` body
  (``_scan_bits``) draw for draw, on sec11 and frank its ``lowered_bits``
  body.
- ``--pallas``: ``run_board_cuda`` on the board-chunk kernel (the Pallas
  kernel's twin, on the port's Philox stream), square only, at 4096 chains.
- The general path, where the board path does not serve the graph (hex)
  or ``--general`` asks for it: ``run_chains`` at 4096 chains, racing the
  rejection-free dense body (the general-dense kernel) against the legacy
  re-propose body (torch ops) and reporting the faster, as ``bench.py``
  does; ``kernel_path`` names the body that won. ``--general`` alone runs
  the legacy body.
- ``--k K`` (K > 2): the k-district pair walk from a K-stripe start, as
  ``bench.py`` runs it: on square the board path, ``run_board`` on the
  board pair kernel (``board_pair_chunk``, the JAX package's
  ``_scan_bits_pair`` draw for draw) at 4096 chains under
  ``flips_per_sec_per_chip_64x64_pair_k{K}``; ``--graph hex --k 4`` races
  the general path's pair kernel (``general_pair_chunk``) against the
  legacy body under ``flips_per_sec_per_chip_hex``; ``--general --k 4``
  runs the legacy body alone on the rook grid.
- ``--cpu``: the same path through the kernels' plain PyTorch versions on
  the host, at 4096 chains, tagged ``device`` "cpu". Without a card and
  without ``--cpu`` the program exits 1: it never measures the host in
  place of the card.
- ``--service``: the sweep service's tenant-efficiency record instead of
  a kernel's throughput (``bench.py``'s ``_service_bench``): the service
  CLI's ``run_simulation`` with ``--tenants`` tenants of ``--chains``
  chains (default 2) each, ``--steps`` steps, on ``--graph``'s family
  (sec11 or frank; square maps to frank). It prints a meta line on stderr
  with the card's name, then the record on stdout, which carries
  ``cpu_fallback`` under ``--cpu``.

It runs the warm-up (the first kernel build included), zeroes the accept,
tries and exhausted counters, warms every other raced body, then times
``--repeats`` runs of ``--steps`` steps of each body from the warmed
state, each ending in a synchronise, and keeps the best. It prints a meta
line on stderr (``bench.py``'s fields, the port's kernel, its launches in
the timed runs and the best seconds of each raced body) and on stdout one headline,
``{"metric", "value", "unit", "device", "path", "kernel_path", "kernel",
"repeats", "repeat_policy"}``, under ``bench.py``'s metric names, so that
``tools/bench_compare.py`` reads it. ``bench.py``'s other flags are refused
with exit code 2, each naming the ROADMAP.md item that ports it.

``--ess`` (``bench.py``'s recorded pass) then runs the winning body once
more from the warmed state with its history recorded and reports the
effective samples of the cut-count trajectory per second, ``{"metric":
"cut_ess_per_sec", ...}``, on stderr before the meta line. On the card
the history stays there (``history_device``) and the Sokal ESS is
computed there (``stats.ess_device``) inside the timed window; the
host's float64 estimator checks it outside (``ess_host_check``, a
relative difference), beside the bottleneck ratio of the same
trajectory (``bottleneck_phi``, ``bottleneck_r``). Under ``--pallas``,
``--cpu`` or ``--ess-host`` the history is copied to the host and the
host estimators run instead. A warm-up pass, whose history is released,
comes first. ``--record-every K`` thins the recorded history (K must
divide ``--chunk``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import graphs
from .kernel import board as kboard
from .kernel import cuda_board as cboard
from .kernel import cuda_board_pair as cbpair
from .kernel import cuda_dense as cdense
from .kernel import cuda_lowered as clow
from .kernel import cuda_pair as cpair
from .kernel import dense as kdense
from .kernel.step import Spec
from .sampling import (init_batch, init_board, run_board, run_board_cuda,
                       run_chains)

# bench.py's flags that this program does not port, by the ROADMAP.md item
# that ports each; a "flag value" key refuses that value only
_NOT_PORTED = {
    "--devstats": "A11 (the host layers: obs events)",
    "--mesh": "A10 (multiple GPUs)",
    "--adaptive": "A11 (the host layers: the control plane)",
    "--target-rhat": "A11 (the host layers: the control plane)",
    "--target-ess": "A11 (the host layers: the control plane)",
    "--workload-matrix": "A11 (the host layers: workloads)",
    "--workloads": "A11 (the host layers: workloads)",
    "--fleet": "A11 (the host layers: the fleet)",
    "--events": "A11 (the host layers: obs events)",
    "--profile": "A11 (the host layers: obs profiling)",
    "--body int8": "B7 (the JAX package's int8 bodies)",
}


def _not_ported(argv) -> str | None:
    """Why ``argv`` asks for a flag of ``bench.py`` that this program does
    not port, or None."""
    toks = [t for a in argv
            for t in (a.split("=", 1) if a.startswith("--") else [a])]
    for flag, value in zip(toks, toks[1:] + [""]):
        for key in (f"{flag} {value}", flag):
            if key in _NOT_PORTED:
                return f"{key} is not ported: ROADMAP.md {_NOT_PORTED[key]}"
    return None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m flipcomplexityempirical_tpu_torch.bench",
        description="Aggregate flip throughput of bench.py's board path "
                    "on the card.")
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--graph", choices=["square", "sec11", "frank", "hex"],
                    default="square")
    ap.add_argument("--chains", type=int, default=None,
                    help="default 8192 on the board path, 4096 with "
                         "--pallas, --cpu or the general path (bench.py's "
                         "rule)")
    ap.add_argument("--steps", type=int, default=3001)
    ap.add_argument("--warmup", type=int, default=501)
    ap.add_argument("--chunk", type=int, default=500)
    ap.add_argument("--base", type=float, default=2.63815853)
    ap.add_argument("--pop-tol", type=float, default=0.1)
    ap.add_argument("--k", type=int, default=2,
                    help="districts; k > 2 runs the k-district pair walk "
                         "on the general path")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    ap.add_argument("--pallas", action="store_true",
                    help="the board-chunk kernel (run_board_cuda), square "
                         "only")
    ap.add_argument("--general", action="store_true",
                    help="the general path's legacy body, even where the "
                         "board path serves the graph")
    ap.add_argument("--body", choices=["bits"], default=None)
    ap.add_argument("--repeats", type=int, default=2,
                    help="timed runs; the best is reported")
    ap.add_argument("--ess", action="store_true",
                    help="also run a recorded pass and report effective "
                         "samples of the cut-count trajectory per second "
                         "(cut_ess_per_sec) on stderr")
    ap.add_argument("--ess-host", action="store_true",
                    help="--ess with the history copied to the host and "
                         "the host's float64 estimator")
    ap.add_argument("--record-every", type=int, default=1,
                    help="history thinning of the --ess recorded pass")
    ap.add_argument("--service", action="store_true",
                    help="the sweep service's tenant_efficiency record: "
                         "--tenants coalescible jobs drained as one batch "
                         "against a solo tenant; --chains means chains per "
                         "tenant (default 2), --graph the family "
                         "(sec11/frank; square maps to frank)")
    ap.add_argument("--tenants", type=int, default=4,
                    help="--service: coalescible tenants sharing the card")
    return ap


def _refusal(args) -> str | None:
    """Why this program does not run ``args``, or None."""
    if args.service:
        for flag, name in ((args.pallas, "--pallas"),
                           (args.general, "--general"),
                           (args.ess, "--ess"),
                           (args.body is not None, "--body")):
            if flag:
                return (f"{name} is incompatible with --service (the "
                        "service benchmark drives whole sweep jobs, not "
                        "one kernel path)")
        return None
    if args.body is not None and (args.pallas or args.general):
        return ("--body selects a board-path body; it cannot be combined "
                "with --pallas or --general")
    if args.pallas and args.general:
        return "--pallas runs the board path; drop --general"
    if args.k < 2:
        return f"--k {args.k}: at least 2 districts"
    if args.k > 2:
        if args.graph in ("sec11", "frank"):
            return ("--graph sec11/frank runs the reference 2-district bi "
                    "walk; drop --k")
        if args.pallas:
            return ("the board-chunk kernel serves the 2-district bi walk "
                    "only; drop --pallas or --k")
    if args.pallas and args.graph != "square":
        return ("the board-chunk kernel runs the plain rook grid; sec11 and "
                "frank run the board path (drop --pallas)")
    if ((args.steps - 1) % args.chunk or (args.warmup - 1) % args.chunk
            or args.warmup - 1 < args.chunk):
        return (f"--chunk {args.chunk} must divide steps-1 "
                f"({args.steps - 1}) and warmup-1 ({args.warmup - 1}), and "
                "warmup-1 must be >= chunk")
    if args.repeats < 1:
        return "--repeats must be >= 1"
    if args.record_every < 1 or args.chunk % args.record_every:
        return (f"--record-every {args.record_every} must divide --chunk "
                f"({args.chunk})")
    return None


def _workload(args):
    """(graph, plan) of ``--graph``, as ``bench.py`` builds them."""
    if args.graph == "sec11":
        g = graphs.grid_sec11()
        return g, graphs.sec11_plan(g, alignment=0)
    if args.graph == "frank":
        g = graphs.frankengraph()
        return g, graphs.frank_plan(g, alignment=0)
    if args.graph == "hex":
        g = graphs.hex_lattice(args.grid, args.grid)
        return g, graphs.stripes_plan(g, args.k)
    g = graphs.square_grid(args.grid, args.grid)
    return g, graphs.stripes_plan(g, args.k)


def _metric(graph: str, k: int = 2) -> str:
    """``bench.py``'s headline name."""
    if graph != "square":
        return f"flips_per_sec_per_chip_{graph}"
    if k == 2:
        return "flips_per_sec_per_chip_64x64"
    return f"flips_per_sec_per_chip_64x64_pair_k{k}"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    why = _not_ported(argv)
    if why is None:
        args = _parser().parse_args(argv)
        why = _refusal(args)
    if why is not None:
        print(f"bench: {why}", file=sys.stderr)
        return 2
    if not args.cpu and not torch.cuda.is_available():
        print("bench: no CUDA device is available; pass --cpu to run the "
              "plain PyTorch versions on the host", file=sys.stderr)
        return 1
    if args.service:
        return _service_bench(args)
    dev = torch.device("cpu" if args.cpu else "cuda")
    spec = Spec(n_districts=args.k, proposal="bi" if args.k == 2 else "pair",
                contiguity="patch",
                invalid="repropose", accept="cut", parity_metrics=True,
                geom_waits=True, record_interface=False)
    g, plan = _workload(args)
    use_board = kboard.supports(g, spec) and not args.general
    if args.chains is None:
        args.chains = (8192 if use_board and args.k == 2
                       and not (args.pallas or args.cpu) else 4096)
    try:
        bench = (_board_bench(args, g, plan, spec, dev) if use_board
                 else _general_bench(args, g, plan, spec, dev))
    except ValueError as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    run, state, variants, wrapper = bench

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # the warm-up, outside the timed window: the kernel's first build and
    # steady boundary sizes; then zero the counters the rates below read,
    # and warm every other raced body
    state = run(state, args.warmup, variants[0], seed=0).state
    state = state.replace(
        accept_count=torch.zeros_like(state.accept_count),
        tries_sum=torch.zeros_like(state.tries_sum),
        exhausted_count=torch.zeros_like(state.exhausted_count))
    for variant in variants[1:]:
        run(state, args.warmup, variant, seed=0)
    sync()
    launches0 = wrapper.launches if wrapper is not None else 0
    dt, best, seconds = float("inf"), variants[0], {}
    for variant in variants:
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            res = run(state, args.steps, variant, seed=1)
            sync()
            d = time.perf_counter() - t0
            seconds[variant] = min(seconds.get(variant, d), d)
            if d < dt:
                dt, best = d, variant
    fps = args.chains * (args.steps - 1) / dt
    s = res.state
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if use_board:
        path = "pallas" if args.pallas else "board"
        kernel = ("board_chunk" if args.pallas else "lowered_chunk"
                  if args.k == 2 else "board_pair_chunk")
        kernel_path = best
    else:
        path, kernel_path = "general", best
        kernel = (None if best != "general_dense" else "general_dense_chunk"
                  if args.k == 2 else "general_pair_chunk")
    meta = {
        "device": device, "path": path, "kernel_path": kernel_path,
        "kernel": kernel, "graph": args.graph, "chains": args.chains,
        "steps": args.steps, "chunk": args.chunk, "grid": args.grid,
        "k": args.k, "seconds": round(dt, 3), "repeats": args.repeats,
        "repeat_policy": "best",
        "mean_tries_per_step": float(s.tries_sum.double().mean())
        / (args.steps - 1),
        "accept_rate": float(s.accept_count.double().mean())
        / (args.steps - 1),
        # the kernel's launches in the timed runs (0 for the plain versions)
        "launches": (wrapper.launches - launches0 if wrapper is not None
                     else 0),
    }
    if len(variants) > 1:
        meta["seconds_by_body"] = {k: round(v, 3) for k, v in seconds.items()}
    if args.ess:
        print(json.dumps(_ess_record(args, run, state, best, sync)),
              file=sys.stderr)
    print(json.dumps(meta), file=sys.stderr)
    headline = {
        "metric": _metric(args.graph, args.k), "value": round(fps, 1),
        "unit": "flips/s", "device": device, "path": path,
        "kernel_path": kernel_path, "kernel": kernel,
        "repeats": args.repeats, "repeat_policy": "best",
    }
    if args.graph != "square":
        headline["graph"] = args.graph
    if args.body is not None:
        headline["body"] = kernel_path
    print(json.dumps(headline))
    return 0


def _ess_record(args, run, state, best, sync) -> dict:
    """``bench.py``'s ``--ess`` record: the winning body ``best`` from the
    warmed ``state``, its history recorded, effective samples of the cut
    trajectory per second of the recorded pass (module docstring)."""
    from .stats import (bottleneck_ratio, bottleneck_ratio_device, ess,
                        ess_device, integer_thresholds)
    dev_hist = not (args.pallas or args.cpu or args.ess_host)
    # the warm-up pass, its history released before the timed one
    warm = run(state, args.steps if dev_hist else args.warmup, best, seed=1,
               record=True, device_hist=dev_hist)
    if dev_hist:
        ess_device(warm.history["cut_count"])[1].item()
    sync()
    del warm
    t0 = time.perf_counter()
    res = run(state, args.steps, best, seed=1, record=True,
              device_hist=dev_hist)
    if dev_hist:
        hist = res.history["cut_count"]
        ess_total = ess_device(hist)[1].item()
    else:
        sync()
        hist64 = np.asarray(res.history["cut_count"], np.float64)
        _, ess_total = ess(hist64)
    d_rec = time.perf_counter() - t0
    # outside the timed window: the bottleneck ratio of the same
    # trajectory on the integer level-set grid, on the history's side
    if dev_hist:
        phi, r_star = (v.item() for v in bottleneck_ratio_device(
            hist, integer_thresholds(hist)))
    else:
        phi, r_star = bottleneck_ratio(
            hist64, np.arange(hist64.min(), hist64.max() + 1.0))
    record = {
        "metric": "cut_ess_per_sec",
        "ess_total": round(float(ess_total), 1),
        "recorded_seconds": round(d_rec, 3),
        "value": round(float(ess_total) / d_rec, 2),
        "ess_on_device": dev_hist,
        # null (not NaN, which is invalid JSON) for a frozen observable
        "bottleneck_phi": None if np.isnan(phi) else round(float(phi), 6),
        "bottleneck_r": None if np.isnan(r_star) else float(r_star),
    }
    if dev_hist:
        _, host_total = ess(hist.cpu().numpy().astype(np.float64))
        record["ess_host_check"] = round(
            abs(float(host_total) - ess_total) / max(float(host_total), 1.0),
            6)
    if args.record_every > 1:
        record["record_every"] = args.record_every
    return record


def _service_bench(args) -> int:
    """--service: the sweep service's tenant-efficiency record, through
    the service CLI's ``run_simulation`` (the coalesced round first, then
    a solo tenant, each through a fresh service)."""
    import tempfile

    from .service.__main__ import run_simulation
    family = args.graph if args.graph in ("sec11", "frank") else "frank"
    device = "cpu" if args.cpu else "cuda"
    with tempfile.TemporaryDirectory(prefix="bench_service_") as outdir:
        record = run_simulation(tenants=args.tenants,
                                chains=args.chains or 2, steps=args.steps,
                                family=family, outdir=outdir, device=device)
    meta = {"mode": "service",
            "device": (torch.cuda.get_device_name(0) if device == "cuda"
                       else "cpu"),
            "n_devices": torch.cuda.device_count() if device == "cuda"
            else 1}
    print(json.dumps(meta), file=sys.stderr)
    if record["device"] == "cpu":
        record["cpu_fallback"] = True
    print(json.dumps(record))
    return 0


def _board_bench(args, g, plan, spec, dev):
    """(run, state, [body], wrapper) of the board path."""
    bg, state, params = init_board(g, plan, n_chains=args.chains, seed=0,
                                   spec=spec, base=args.base,
                                   pop_tol=args.pop_tol, device=dev)
    bits = True if args.body == "bits" else None
    if args.pallas:
        cboard.check(spec, params)
        body, wrapper = "pallas", cboard.run_board_chunk_cuda
    elif spec.proposal == "pair":
        body = cbpair.body_for(bg, spec, bits)
        cbpair.check(bg, spec, params)
        wrapper = cbpair.run_board_pair_chunk_cuda
    else:
        body = clow.body_for(bg, spec, bits)
        clow.check(bg, spec, params)
        wrapper = clow.run_lowered_chunk_cuda

    def run(st, n_steps: int, variant, seed: int, record=False,
            device_hist=False):
        if args.pallas:
            return run_board_cuda(bg, spec, params, st, n_steps=n_steps,
                                  record_history=record, chunk=args.chunk,
                                  seed=seed, device=dev)
        return run_board(bg, spec, params, st, n_steps=n_steps,
                         record_history=record, chunk=args.chunk, bits=bits,
                         record_every=args.record_every if record else 1,
                         history_device=device_hist, device=dev)
    return run, state, [body], wrapper


def _general_bench(args, g, plan, spec, dev):
    """(run, state, bodies, wrapper) of the general path: the dense body
    raced against the legacy one where ``dense.supported`` holds, the
    legacy body alone under ``--general``."""
    dg, state, params = init_batch(g, plan, n_chains=args.chains, seed=0,
                                   spec=spec, base=args.base,
                                   pop_tol=args.pop_tol, device=dev)
    if args.general or not kdense.supported(g, spec):
        variants = ["general"]
    else:
        variants = ["general_dense", "general"]
        if dev.type == "cuda":
            (cpair if spec.proposal == "pair" else cdense).check(
                dg, spec, params)

    def run(st, n_steps: int, variant, seed: int, record=False,
            device_hist=False):
        return run_chains(dg, spec, params, st, n_steps=n_steps,
                          record_history=record, chunk=args.chunk,
                          record_every=args.record_every if record else 1,
                          history_device=device_hist, kernel_path=variant)
    wrapper = (cpair.run_general_pair_chunk_cuda if spec.proposal == "pair"
               else cdense.run_general_dense_chunk_cuda)
    return run, state, variants, (wrapper if "general_dense" in variants
                                  else None)


if __name__ == "__main__":
    sys.exit(main())
