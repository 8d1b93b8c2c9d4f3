"""CLI: python -m flipcomplexityempirical_tpu_torch.experiments
         --family sec11|frank|kpair|tri|hex|temper|dual --out plots/sec11
         [--steps N]
         [--chains C] [--only 2B30P10 ...] [--variant nobacktrack|lazy]
         [--contiguity patch|exact] [--analytics history|summary]
         [--device cuda|cpu]

Runs the sweep grid of a family (150 sec11 configs, 24 Frankengraph
configs, 8 kpair configs: k = 4 and 8 districts on the 64 x 64 rook grid,
4 triangular- and 4 hexagonal-lattice configs, 3 temper configs: 10-rung
beta ladders on the Frankengraph, ``--chains`` ladders each, 4 dual-graph
configs: k = 4 and 8 districts on a 12 x 12 synthetic precinct map) on
the card, with
skip-if-done resume, writing each config's artifacts under the
reference's file names (``--analytics summary``: the same files, with
the history folded on the card instead of copied to the host). The bare
fail-fast loop: the first failure ends the process with a nonzero exit.
``--device cpu`` runs the plain PyTorch versions on the host, and only
when asked; without a card the default ``cuda`` exits nonzero.
"""

import argparse
import sys

from ..device import resolve_device
from .config import SWEEPS
from .driver import run_sweep

FAMILIES = ("sec11", "frank", "kpair", "tri", "hex", "temper", "dual")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m flipcomplexityempirical_tpu_torch.experiments",
        description="Run the paper's sweep of a family on the card.")
    ap.add_argument("--family", choices=FAMILIES, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=100_000,
                    help="total yields per config (default 100000)")
    ap.add_argument("--chains", type=int, default=8,
                    help="batched chains per config (default 8; chain 0 "
                         "renders; temper: ladders of len(betas) chains)")
    ap.add_argument("--record-every", type=int, default=1,
                    help="history thinning (yields 0, k, 2k, ... recorded; "
                         "accumulators exact)")
    ap.add_argument("--analytics", choices=["history", "summary"],
                    default="history",
                    help="'history' copies each segment's history to the "
                         "host; 'summary' folds it on the card and reads "
                         "back chain 0's interface series once (the same "
                         "artifacts; incompatible with --checkpoint-dir "
                         "and --record-every > 1)")
    ap.add_argument("--contiguity", choices=["patch", "exact"],
                    default="patch",
                    help="the radius-r patch check, or the exact "
                         "whole-graph check (the general path's legacy "
                         "body)")
    ap.add_argument("--variant", choices=["none", "nobacktrack", "lazy"],
                    default="none",
                    help="proposal variant (the general path; "
                         "nobacktrack needs the 2-district walk)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between mid-config checkpoints (0: none); "
                         "an interrupted config resumes from the last "
                         "saved segment")
    ap.add_argument("--only", nargs="*", default=None,
                    help="config tags to run, e.g. 2B30P10")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        sys.exit(f"error: {exc}")
    overrides = dict(total_steps=args.steps, n_chains=args.chains,
                     seed=args.seed, record_every=args.record_every,
                     contiguity=args.contiguity,
                     checkpoint_every=args.checkpoint_every,
                     variant=args.variant)
    if args.analytics != "history":
        overrides["analytics"] = args.analytics
    configs = list(SWEEPS[args.family](**overrides))
    if args.only:
        configs = [c for c in configs if c.tag in set(args.only)]
        if not configs:
            sys.exit(f"error: no {args.family} config has a tag in "
                     f"{args.only}")
    run_sweep(configs, args.out, checkpoint_dir=args.checkpoint_dir,
              device=args.device)


if __name__ == "__main__":
    main()
