"""Time ``general_dense_chunk``, ``general_pair_chunk`` and
``board_pair_chunk`` against earlier versions of themselves, in turns, on
one card.

    git archive <commit> flipcomplexityempirical_tpu_torch | tar -x -C build/old
    python3 dense_turns.py --old build/old

The earlier package is copied to ``build/turns/fce_old_torch`` and its
kernels built from its own sources. At each kernel's main-path shapes
(``chip_smoke.py``'s; the dense kernel: a hex config's chunk, hex 14x28,
C=8, T=2439, the hex sweep's batch, and the general main path's, hex
64x64, C=4096, T=500 after a warm-up; the pair kernel: the dual sweep's
K4 and K8 configs, C=8, T=2439, and hex 64x64, k = 4, C=4096, T=500 after
a warm-up; the rook board's pair kernel: the kpair main path's 64x64,
k = 4, C=4096, T=500 after a warm-up, and the kpair K4 config's start,
C=8, T=369), both versions run the same chunk from the same state and
must give equal outputs; then each is timed with CUDA events, old, new,
new, old, ``--rounds`` times. ``board_pair_chunk`` is timed twice a
shape: the kernel alone (the earlier one, which wrote the flip log's rows,
against the new one without parity_metrics) and the chunk as
``run_chunk`` pays for it under parity_metrics (the earlier kernel and
its flip log replayed by ``apply_flip_log``, against the new kernel,
which closes the log's runs itself). Prints the card's name and power
limit, each round's ms a chunk, and the SM clock under the new kernel
with its cycles a step and launch shape.

Needs a CUDA card; exits 1 without one.
"""

import argparse
import dataclasses
import pathlib
import shutil
import sys

import chip_smoke as cs

FIELDS = ("key", "assignment", "cut", "cut_deg", "dist_pop", "cut_count",
          "b_count", "cur_wait", "cur_flip_node", "t_yield", "part_sum",
          "last_flipped", "num_flips", "cut_times", "waits_sum",
          "accept_count", "conn_bits")


def shapes(port, sampling, ex):
    """(label, graph handle, spec, params, state, T) of the dense kernel's
    three shapes."""
    out = []
    for label, mn, chains, tol, base, t_len, warm in (
            ("hex 14x28 C=8", (14, 28), 8, 0.1, 1 / 0.3, 2439, 0),
            ("hex 64x64 C=4096", (cs.GRID, cs.GRID), cs.CHAINS, cs.POP_TOL,
             cs.BASE, cs.CHUNK, cs.WARMUP)):
        _, spec, dg, st, params = cs.general_inputs(
            port, sampling, "hex_lattice", mn, chains, tol, base)
        if warm:
            st = sampling.run_chains(dg, spec, params, st, n_steps=warm,
                                     chunk=t_len, record_history=False).state
        out.append((label, dg, spec, params, st, t_len))
    prepared, states, params = cs.sweep_batch(ex, "hex")
    out.insert(1, (f"the hex sweep's batch C={states.key.shape[0]}",
                   prepared[0].handle, prepared[0].spec, params, states,
                   2439))
    return out


def same_chunk(got, rows, want, wrows) -> bool:
    import torch
    return (all(torch.equal(getattr(got, f), getattr(want, f))
                for f in FIELDS)
            and all(torch.equal(rows[k], wrows[k]) for k in wrows))


def same_outputs(got, want) -> bool:
    import torch
    return len(got) == len(want) and all(torch.equal(x, y)
                                         for x, y in zip(got, want))


def bpair_cases(port, drv, ex, sampling) -> list:
    """(label, BoardGraph, spec, params, state, T) of board_pair_chunk's
    two main-path shapes: the kpair main path's (chip_smoke.py's
    BPAIR_MAIN) after a 501-step warm-up, and the kpair K4 config's start
    at the experiment path's chunk."""
    m, k = cs.BPAIR_MAIN["grid"], cs.BPAIR_MAIN["k"]
    _, bg, spec, params, st = cs.bpair_inputs(
        port, sampling, m, m, k, cs.BPAIR_MAIN["chains"],
        cs.BPAIR_MAIN["tol"], cs.BASE, {}, cs.WARMUP, 0)
    out = [(f"{m}x{m} k={k} C={cs.BPAIR_MAIN['chains']} (the kpair main "
            "path)", bg, spec, params, st, cs.CHUNK)]
    cfg = cs.experiment_config(ex, "kpair", cs.KPAIR_RUNS[0],
                               total_steps=cs.EXP_STEPS,
                               n_chains=cs.EXP_CHAINS)
    g, plan, _ = drv.build_graph_and_plan(cfg)
    spec = drv.spec_for(cfg)
    _, (bg, st, params) = drv._init_run(cfg, g, plan, spec, cs.DEVICE)
    out.append((f"{cfg.tag} C={cs.EXP_CHAINS} (the experiment path)", bg,
                spec, params, st,
                sampling.runner.pick_chunk(cs.EXP_STEPS, 512)))
    return out


def bpair_turns(port, drv, ex, sampling, opts) -> None:
    """board_pair_chunk against the earlier package's at bpair_cases:
    the kernel alone, then the chunk under parity_metrics."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_board_pair as cbp
    from fce_old_torch.kernel import board as old_tb
    from fce_old_torch.kernel import cuda_board_pair as old_cbp
    for label, bg, spec, params, st, t_len in bpair_cases(port, drv, ex,
                                                          sampling):
        c = st.board.shape[0]
        static, args = cs.bpair_args(cbp, bg, spec, params, st, t_len)
        ins, flips = args[4:9], args[9]
        old_args = (bg, old_cbp.make_static_inputs(bg, spec, params), spec,
                    t_len, *ins)
        bare = dataclasses.replace(spec, parity_metrics=False)

        def old_kernel():
            outs = old_cbp.run_board_pair_chunk_cuda(*old_args)
            return outs[:5] + outs[7:]

        def old_chunk():
            outs = old_cbp.run_board_pair_chunk_cuda(*old_args)
            return outs[:5] + outs[7:] + old_tb.apply_flip_log(
                *flips, outs[5], outs[6], ins[4][3])

        def line(ms, mhz, c=c, n=bg.n, t_len=t_len):
            cyc = (f"{ms * 1e3 * mhz / t_len:.1f} cycles a step at "
                   f"{mhz:.0f} MHz" if mhz else "cycles a step not measured")
            return f"{cs.bpair_shape(cbp, n, c)[1]}; {ms:.4f} ms, {cyc}"

        in_turns(f"board_pair_chunk {label}, the kernel alone", t_len,
                 lambda: cbp.run_board_pair_chunk_cuda(bg, static, bare,
                                                       t_len, *ins),
                 old_kernel, line, opts, same_outputs)
        in_turns(f"board_pair_chunk {label}, the chunk with its flip log "
                 "(new: in the kernel; old: apply_flip_log after it)", t_len,
                 lambda: cbp.run_board_pair_chunk_cuda(*args), old_chunk,
                 line, opts, same_outputs)


def in_turns(label, t_len, new, old, line_of, opts, same=None) -> None:
    """Equal outputs (``same``; by default the general kernels' (state,
    rows)), then old, new, new, old ``opts.rounds`` times."""
    got, want = new(), old()
    if not (same(got, want) if same else same_chunk(*got, *want)):
        cs.fail(f"{label}: the two kernels' outputs differ")
    times = {"old": [], "new": []}
    for _ in range(opts.rounds):
        for name, fn in (("old", old), ("new", new), ("new", new),
                         ("old", old)):
            fn()
            times[name].append(cs.event_ms(fn, opts.reps))
    ms = sorted(times["new"])[len(times["new"]) // 2]
    clocks = cs.clocks_under_load(new, max(20, int(400 / ms)))
    print(f"{label} T={t_len}: outputs equal; old "
          + ", ".join(f"{x:.4f}" for x in times["old"]) + " ms; new "
          + ", ".join(f"{x:.4f}" for x in times["new"])
          + f" ms (CUDA events, {opts.reps} launches each, in turns "
          f"old, new, new, old); SM clock, power under the new "
          f"kernel: {clocks}; new {line_of(ms, cs.sm_mhz(clocks))}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, help="a directory holding an "
                    "earlier flipcomplexityempirical_tpu_torch/")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=10)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("dense_turns.py: no CUDA card", file=sys.stderr)
        sys.exit(1)
    import flipcomplexityempirical_tpu_torch as port
    from flipcomplexityempirical_tpu_torch import experiments as ex
    from flipcomplexityempirical_tpu_torch import sampling
    from flipcomplexityempirical_tpu_torch.experiments import driver as drv
    from flipcomplexityempirical_tpu_torch.kernel import cuda_dense as cd
    from flipcomplexityempirical_tpu_torch.kernel import cuda_pair as cp
    dst = cs.ROOT / "build" / "turns" / "fce_old_torch"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(
        pathlib.Path(opts.old) / "flipcomplexityempirical_tpu_torch", dst)
    sys.path.insert(0, str(dst.parent))
    from fce_old_torch.kernel import cuda_dense as old_cd
    from fce_old_torch.kernel import cuda_pair as old_cp
    print(cs.card_line())
    for label, dg, spec, params, st, t_len in shapes(port, sampling, ex):
        static, old_static = (cd.make_static_inputs(dg),
                              old_cd.make_static_inputs(dg))
        st, _ = cd.run_general_dense_chunk_cuda(dg, static, spec, params,
                                                st, t_len)
        in_turns(
            label, t_len,
            lambda: cd.run_general_dense_chunk_cuda(
                dg, static, spec, params, st, t_len),
            lambda: old_cd.run_general_dense_chunk_cuda(
                dg, old_static, spec, params, st, t_len),
            lambda ms, mhz: cs.dense_shape(cd, dg, st.key.shape[0], ms,
                                           t_len, mhz)[1], opts)
    cases = cs.pair_cases(port, drv, ex, sampling)
    for label, dg, spec, params, st, t_len in cases:
        static, old_static = (cp.make_static_inputs(dg),
                              old_cp.make_static_inputs(dg))
        k = spec.n_districts

        def line(ms, mhz, dg=dg, c=st.key.shape[0], t_len=t_len, k=k):
            shape = cp.launch_shape(dg, c, k)
            cyc = (f"{ms * 1e3 * mhz / t_len:.1f} cycles a step at "
                   f"{mhz:.0f} MHz" if mhz else "cycles a step not measured")
            return (f"{shape['chain_bytes']} B a chain, "
                    f"{shape['chains_per_block']} chain(s) a block, "
                    f"{shape['blocks_per_sm']} block(s) an SM; {ms:.4f} ms, "
                    f"{cyc}")

        in_turns(
            f"general_pair_chunk {label} C={st.key.shape[0]}", t_len,
            lambda: cp.run_general_pair_chunk_cuda(dg, static, spec, params,
                                                   st, t_len),
            lambda: old_cp.run_general_pair_chunk_cuda(
                dg, old_static, spec, params, st, t_len), line, opts)
    bpair_turns(port, drv, ex, sampling, opts)


if __name__ == "__main__":
    main()
