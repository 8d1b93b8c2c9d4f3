"""CLI: python -m flipcomplexityempirical_tpu_torch.service
         --family frank --out DIR [--steps N] [--chains C] [--seed S]
         [--record-every K] [--only TAG ...] [--checkpoint-dir DIR]
         [--max-batch-chains N] [--cpu]
     or: ... --simulate --out DIR [--tenants 4] [--chains 2] [--steps 400]

The port of the JAX package's flat service CLI
(``flipcomplexityempirical_tpu/service/__main__.py``). A reference sweep
family is submitted through ``SweepService``: its fingerprint-equal
configs coalesce into one batch of chains on the card, each config's
rows are sliced back out, and the process prints one ``[done]`` line a
job and one ``[batch]`` line a batch (chains, kernel path, the set-up,
run and slicing seconds, the chunk kernels' launches). The exit code is
0 when every job is done and 2 when any failed. ``--out`` is created;
nothing is rendered there (the service returns each job's data in
process, as the JAX package's does).

``--simulate`` is the tenant-efficiency measurement (``run_simulation``):
N coalescible tenants drained as ONE batch against one solo tenant, each
through a fresh service, printed as a ``tenant_efficiency`` record (also
reachable as ``bench --service``).

Without ``--cpu`` it runs on the card, and without a card it exits 1;
``--cpu`` runs the kernels' plain PyTorch versions on the host. The JAX
CLI's other flags (``--events``, ``--heartbeat``, ``--compile-cache``,
``--faults``, ``--retries``, ``--quarantine-after``, ``--deadline``,
``--dispatch-timeout``, ``--recover``) and its ``serve`` / ``worker`` /
``submit`` / ``status`` subcommands exit 2 naming ROADMAP.md A11.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..experiments.config import SWEEPS, ExperimentConfig
from .scheduler import SweepService

_A11 = "ROADMAP.md A11 (the host layers of the sweep service)"
# the JAX CLI's flags and subcommands that this program does not port
_NOT_PORTED = ("--events", "--heartbeat", "--compile-cache", "--faults",
               "--retries", "--quarantine-after", "--deadline",
               "--dispatch-timeout", "--recover")
_SUBCOMMANDS = ("serve", "worker", "submit", "status")

# families whose (alignment, base) grid gives coalescible-but-distinct
# tenants: alignment varies the initial plan, base the per-chain params
# — neither moves ExperimentConfig.fingerprint(), both move the tag
_SIM_FAMILIES = ("frank", "sec11")


def tenant_configs(tenants: int, chains: int, steps: int,
                   family: str = "frank", seed: int = 3,
                   record_every: int = 1) -> list:
    """N fingerprint-equal tenant configs with distinct tags and seeds —
    the service coalesces them into one batch."""
    if family not in _SIM_FAMILIES:
        raise ValueError(f"simulation families are {_SIM_FAMILIES}, "
                         f"got {family!r}")
    return [ExperimentConfig(family=family, alignment=(2, 1, 0)[i % 3],
                             base=0.3 + 0.01 * i, pop_tol=0.1,
                             total_steps=steps, n_chains=chains,
                             seed=seed + 13 * i,
                             record_every=record_every)
            for i in range(tenants)]


def _drain_cold(configs, outdir: str, device="cuda") -> tuple:
    """Submit ``configs`` to a fresh service and drain; returns
    (turnaround_s, service)."""
    svc = SweepService(outdir=outdir, device=device)
    jobs = [svc.submit(c) for c in configs]
    t0 = time.perf_counter()
    svc.run_until_idle()
    if svc.device.type == "cuda":
        torch.cuda.synchronize(svc.device)
    wall = time.perf_counter() - t0
    bad = [(j.tag, j.status, j.error) for j in jobs if j.status != "done"]
    if bad:
        raise RuntimeError(f"simulation jobs did not complete: {bad}")
    return wall, svc


def run_simulation(tenants: int = 4, chains: int = 2, steps: int = 400,
                   family: str = "frank", seed: int = 3,
                   outdir: str = ".", device="cuda") -> dict:
    """The N-tenant coalescing measurement; returns the bench record.

    The coalesced round runs FIRST, so the process's one-time costs (the
    kernels' build, the first launches) land on the batch side — the
    reported efficiency is the conservative one."""
    cfgs = tenant_configs(tenants, chains, steps, family=family,
                          seed=seed)
    wall_batch, svc_b = _drain_cold(cfgs, os.path.join(outdir, "tenants"),
                                    device=device)
    stats = svc_b.batch_stats
    if len(stats) != 1 or len(stats[0].jobs) != tenants:
        raise RuntimeError(
            f"expected one coalesced batch of {tenants} tenants, got "
            f"{[(s.batch_id, s.jobs) for s in stats]}")
    wall_solo, svc_s = _drain_cold(cfgs[:1], os.path.join(outdir, "solo"),
                                   device=device)
    eff = wall_solo / wall_batch
    return {
        "metric": "tenant_efficiency",
        "value": round(eff, 4),
        "unit": "ratio",
        "tenants": tenants,
        "chains_per_tenant": chains,
        "steps": steps,
        "family": family,
        "kernel_path": stats[0].kernel_path,
        "solo_turnaround_s": round(wall_solo, 3),
        "batch_turnaround_s": round(wall_batch, 3),
        # run-only occupancy view (excludes set-up): how much slower the
        # coalesced pass is than a solo pass
        "solo_run_s": round(svc_s.batch_stats[0].wall_s, 4),
        "batch_run_s": round(stats[0].wall_s, 4),
        "serial_service_s": round(tenants * wall_solo, 3),
        "device": "gpu" if svc_b.device.type == "cuda" else "cpu",
    }


def _not_ported(argv) -> str | None:
    """Why ``argv`` asks for something of the JAX CLI that this program
    does not port, or None."""
    if argv and argv[0] in _SUBCOMMANDS:
        return (f"the {argv[0]!r} subcommand is not ported: it waits for "
                f"{_A11}")
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in _NOT_PORTED:
            return f"{flag} is not ported: it waits for {_A11}"
    return None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m flipcomplexityempirical_tpu_torch.service",
        description="Run a sweep family through the coalescing service on "
                    "the card.")
    ap.add_argument("--simulate", action="store_true",
                    help="N-tenant coalescing measurement; prints a "
                         "tenant_efficiency bench record")
    ap.add_argument("--family", choices=sorted(SWEEPS), default="frank",
                    help="sweep family to submit through the service "
                         "(simulation mode: frank|sec11)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--tenants", type=int, default=4,
                    help="simulation: coalescible tenants sharing the card")
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--record-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--only", nargs="*", default=None,
                    help="config tags to submit, e.g. 2B30P10")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--max-batch-chains", type=int, default=None,
                    help="cap on total chains per coalesced batch "
                         "(default: unbounded)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the host")
    return ap


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    why = _not_ported(argv)
    if why is not None:
        print(f"service: {why}", file=sys.stderr)
        return 2
    args = _parser().parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("service: no CUDA device is available; pass --cpu to run the "
              "plain PyTorch versions on the host", file=sys.stderr)
        return 1
    device = "cpu" if args.cpu else "cuda"
    os.makedirs(args.out, exist_ok=True)
    if args.simulate:
        record = run_simulation(tenants=args.tenants, chains=args.chains,
                                steps=args.steps, family=args.family,
                                seed=args.seed, outdir=args.out,
                                device=device)
        print(json.dumps(record))
        return 0
    configs = list(SWEEPS[args.family](
        total_steps=args.steps, n_chains=args.chains, seed=args.seed,
        record_every=args.record_every))
    if args.only:
        configs = [c for c in configs if c.tag in set(args.only)]
        if not configs:
            print(f"service: no {args.family} config has a tag in "
                  f"{args.only}", file=sys.stderr)
            return 2
    svc = SweepService(outdir=args.out, checkpoint_dir=args.checkpoint_dir,
                       max_batch_chains=args.max_batch_chains, verbose=True,
                       device=device)
    try:
        for cfg in configs:
            svc.submit(cfg)
    except ValueError as exc:
        print(f"service: {exc}", file=sys.stderr)
        return 2
    svc.run_until_idle()
    for s in svc.batch_stats:
        print(f"[batch] {s.batch_id} {len(s.jobs)} jobs {s.chains} chains "
              f"{s.steps} steps {s.kernel_path}: prepare {s.prepare_s:.3f} "
              f"s, run {s.wall_s:.3f} s, assemble {s.assemble_s:.3f} s, "
              f"launches {s.launches}", flush=True)
    return svc.exit_code


if __name__ == "__main__":
    sys.exit(main())
