"""Time the chunk kernels' fused summary fold against an earlier version
of it, in turns, on one card.

    git archive <commit> flipcomplexityempirical_tpu_torch | tar -x -C build/old
    python3 fold_turns.py --old build/old

The earlier package is copied to ``build/turns/fce_old_torch`` and its
kernels built from its own sources. At the fold's four chunk shapes
(``chip_smoke.py``'s ``fold_inputs``: sec11's main path, C=4096, T=500,
and the experiment path, C=8, T=369, on ``lowered_chunk``; the hex
sweep's batch, C=32, T=2439, and hex 64x64, C=4096, T=500, on
``general_dense_chunk``), both versions run the fused chunk without a
history from the same state and accumulator, and must give equal outputs
and bit-equal accumulators; then each is timed with CUDA events behind a
device sleep, old, new, new, old, ``--rounds`` times, and the new
version's history-mode chunk once a round beside them. Prints the card's
name and power limit and each round's ms a chunk. Needs a CUDA card;
exits 1 without one.
"""

import argparse
import pathlib
import shutil
import sys

import chip_smoke as cs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="a directory holding an "
                    "earlier flipcomplexityempirical_tpu_torch/")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fold_turns.py: no CUDA card", file=sys.stderr)
        sys.exit(1)
    import flipcomplexityempirical_tpu_torch as port
    from flipcomplexityempirical_tpu_torch import experiments as ex
    from flipcomplexityempirical_tpu_torch import sampling
    from flipcomplexityempirical_tpu_torch.experiments import driver as drv
    from flipcomplexityempirical_tpu_torch.kernel import cuda_dense as cd
    from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl
    from flipcomplexityempirical_tpu_torch.stats import accumulators as sacc
    dst = cs.ROOT / "build" / "turns" / "fce_old_torch"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(
        pathlib.Path(opts.old) / "flipcomplexityempirical_tpu_torch", dst)
    sys.path.insert(0, str(dst.parent))
    from fce_old_torch.kernel import cuda_dense as old_cd
    from fce_old_torch.kernel import cuda_lowered as old_cl
    print(cs.card_line())
    for shape in cs.fold_inputs(port, ex, drv, sampling, cd):
        label, kind = shape[:2]
        history, new = cs.fold_route(cl, cd, *shape)
        _, old = cs.fold_route(old_cl, old_cd, *shape)
        c, t_len = shape[5].key.shape[0], shape[6]
        keys = ("slope", "angle") if kind == "lowered" else ()
        acc0 = sacc.init_summary(c, series_keys=keys,
                                 series_cap=cs.EXP_STEPS, device=cs.DEVICE)
        (got, got_acc), (want, want_acc) = new(acc0.clone()), old(
            acc0.clone())
        torch.cuda.synchronize()
        cs.same_fused_outputs(got, want, f"{label}: new against old")
        cs.same_fold(got_acc, want_acc, f"{label}: new against old")
        times = {"old": [], "new": [], "history": []}
        for _ in range(opts.rounds):
            for name, fn in (("old", old), ("new", new), ("history", None),
                             ("new", new), ("old", old)):
                if fn is None:
                    times[name].append(cs.device_ms(history, opts.reps))
                    continue
                accs = [acc0.clone() for _ in range(opts.reps)]
                times[name].append(cs.device_ms(lambda: fn(accs.pop()),
                                                opts.reps))
        print(f"{kind} {label} C={c} T={t_len}: fused outputs and "
              f"accumulators equal; fused old "
              + ", ".join(f"{x:.4f}" for x in times["old"]) + " ms; new "
              + ", ".join(f"{x:.4f}" for x in times["new"])
              + " ms; history-mode chunk "
              + ", ".join(f"{x:.4f}" for x in times["history"])
              + f" ms (CUDA events behind a device sleep, {opts.reps} "
              f"launches each, in turns old, new, history, new, old)",
              flush=True)


if __name__ == "__main__":
    main()
