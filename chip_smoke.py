#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` (no
arguments; needs one CUDA card). It builds every kernel of the port from
``flipcomplexityempirical_tpu_torch/csrc``, holds each against its plain
PyTorch version on the card, drives the port's main path through the
entry points a user calls, checks what comes out, and prints:

  1. the card's name and power limit (``nvidia-smi``) and the build time;
  2. host-bits exactness of the board-chunk kernel against its plain
     version at 64x64, C=256, T=64 (integers bit-equal, differing waits 0);
  3. device-RNG exactness at the same shape (the plain version draws
     through ``rng.py``'s Philox twin): bit-equal;
  4. the main path at ``bench.py --pallas``'s configuration (64x64 rook
     grid, stripes plan, patch contiguity, base 2.63815853, pop_tol 0.1,
     C=4096, chunk 500, a 501-step warmup, 3001 timed steps) through
     ``run_board_cuda``: flips/s, the kernel's ms per chunk, the wall ms
     of ``apply_flip_log`` and ``record_final``, peak memory, the kernel's
     launches (which must equal the chunks run), result checks, and the
     accept rate and mean cut count beside a 501-step plain-version run;
  5. one JSON line per kernel table (``{"kernels": [...]}``), then as the
     last line ``{"ok": true, "device": {...}}``.

Any failed phase exits nonzero before the last line. Without a CUDA card,
or without the port's package beside it, the script exits nonzero and
prints no result.
"""

import json
import subprocess
import sys
import time
from collections import deque

GRID = 64
BASE = 2.63815853
POP_TOL = 0.1
CHAINS = 4096
CHUNK = 500
WARMUP = 501
STEPS = 3001
EXACT_CHAINS, EXACT_T = 256, 64
PLAIN_CHAINS = 256
DEVICE = "cuda"
ACCEPT_BAND = (0.40, 0.55)      # accepted share of transitions
ACCEPT_AGREE = 0.02             # |kernel - plain| accept rate, 501 steps
CUT_AGREE = 0.05                # relative |kernel - plain| mean cut count

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the non-tensor
# FP32 rate, the sheet's only row for CUDA-core arithmetic (the int32 pipe
# is narrower, so the bound below is a floor).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations per cell and step of the board-chunk function: 8 neighbour
# compares and 8 existence masks, 3 adds for same_deg, diff_deg and the
# boundary test (2), cut_e/cut_s (4), the ring criterion (15), contiguity
# (3), the population gate (7), validity (2), the counts (3), the score
# (2), the argmax (2) and the cut_times adds (2): 61; plus the Philox
# draw, 10 rounds of ~10 operations per 4 cells: 25.
OPS_PER_CELL_STEP = 61 + 25


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_abs_diff(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()) if g.numel()
               else 0.0 for g, w in zip(got, want))


def compare_chunk(cb, args, label: str) -> float:
    """Kernel vs plain version on the same inputs; returns max |diff|."""
    import torch
    got = cb.run_board_chunk_cuda(*args)
    torch.cuda.synchronize()
    want = cb.board_chunk_reference(*args)
    torch.cuda.synchronize()
    names = ("board", "dist_pop", "scal", "ints", "log_f", "log_s",
             "hist_cut", "hist_b", "hist_wait", "hist_acc", "cut_e",
             "cut_s")
    wait_diff = int((got[8] != want[8]).sum()) + int(
        (got[2] != want[2]).sum())
    print(f"{label}: differing waits {wait_diff}")
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w.to(g.dtype)):
            fail(f"{label}: {name} differs from the plain version")
    return max_abs_diff(got, want)


def districts_connected(board_row, h: int, w: int) -> bool:
    """Host BFS: each of the two districts is one rook-connected set."""
    for d in (0, 1):
        cells = [i for i in range(h * w) if board_row[i] == d]
        if not cells:
            return False
        seen = {cells[0]}
        todo = deque([cells[0]])
        while todo:
            i = todo.popleft()
            x, y = divmod(i, w)
            for nx, ny in ((x + 1, y), (x - 1, y), (x, y + 1), (x, y - 1)):
                j = nx * w + ny
                if (0 <= nx < h and 0 <= ny < w and j not in seen
                        and board_row[j] == d):
                    seen.add(j)
                    todo.append(j)
        if len(seen) != len(cells):
            return False
    return True


def plain_run(cb, bg, spec, params, state, n_steps: int, seed: int):
    """The runner's chunk loop over the kernel's plain version on the
    card: (accept rate, mean recorded cut count)."""
    pop, deg = cb.make_static_inputs(bg)
    cuts, done, idx = [], 0, 0
    acc0 = state.accept_count.clone()
    while done < n_steps - 1:
        this = min(CHUNK, n_steps - 1 - done)
        dp, scal, ints = cb.pack_state(state, params)
        outs = cb.board_chunk_reference(spec, bg.h, bg.w, this, seed, idx,
                                        state.board, pop, deg, dp, scal,
                                        ints)
        state = cb.unpack_state(state, bg, outs, this)
        cuts.append(outs[6].double().mean().item())
        done += this
        idx += 1
    rate = ((state.accept_count - acc0).double().mean().item()
            / (n_steps - 1))
    return rate, sum(cuts) / len(cuts)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import flipcomplexityempirical_tpu_torch as port
        from flipcomplexityempirical_tpu_torch.kernel import _build
        from flipcomplexityempirical_tpu_torch.kernel import board as tb
        from flipcomplexityempirical_tpu_torch.kernel import cuda_board as cb
    except ImportError as exc:
        fail(f"the port's package is not importable here: {exc}")

    card = card_line()
    print(card)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} kernel source(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    dev = DEVICE
    g = port.graphs.square_grid(GRID)
    plan = port.graphs.stripes_plan(g, 2)
    spec = port.Spec(contiguity="patch")

    # ---- 2/3: exactness against the plain version --------------------
    bg, st, params = port.init_board(g, plan, n_chains=EXACT_CHAINS, seed=1,
                                     spec=spec, base=BASE, pop_tol=POP_TOL,
                                     device=dev)
    pop, deg = cb.make_static_inputs(bg)
    dp, scal, ints = cb.pack_state(st, params)
    gen = torch.Generator(device=dev).manual_seed(1234)
    n = bg.n
    bits = (cb.bits_tensor(torch.randint(0, 2 ** 32, (EXACT_T, EXACT_CHAINS,
                                                      n), device=dev,
                                         generator=gen), dev),
            cb.bits_tensor(torch.randint(0, 2 ** 32, (EXACT_T, 2,
                                                      EXACT_CHAINS),
                                         device=dev, generator=gen), dev))
    common = (spec, bg.h, bg.w, EXACT_T, 99, 3, st.board, pop, deg, dp, scal,
              ints)
    err = compare_chunk(cb, (*common, *bits), "host-bits exactness")
    err = max(err, compare_chunk(cb, (*common, None, None),
                                 "device-rng exactness"))
    del bits

    # ---- 4: the main path ---------------------------------------------
    bg, st, params = port.init_board(g, plan, n_chains=CHAINS, seed=0,
                                     spec=spec, base=BASE, pop_tol=POP_TOL,
                                     device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.run_board_chunk_cuda.launches = 0
    warm = port.run_board_cuda(bg, spec, params, st, n_steps=WARMUP,
                               chunk=CHUNK, seed=0, device=dev)
    state = warm.state.replace(
        accept_count=torch.zeros_like(warm.state.accept_count),
        tries_sum=torch.zeros_like(warm.state.tries_sum),
        exhausted_count=torch.zeros_like(warm.state.exhausted_count))
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    res = port.run_board_cuda(bg, spec, params, state, n_steps=STEPS,
                              record_history=False, chunk=CHUNK, seed=1,
                              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = cb.run_board_chunk_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-(WARMUP - 1) // CHUNK) + -(-(STEPS - 1) // CHUNK)
    fps = CHAINS * (STEPS - 1) / wall
    print(f"main path: {CHAINS} chains x {STEPS} steps in {wall:.3f} s, "
          f"{fps:.6e} flips/s; peak memory {peak / 2 ** 20:.1f} MiB; "
          f"board_chunk launches {launches} for {chunks} chunks")
    if launches != chunks:
        fail(f"board_chunk launched {launches} times for {chunks} chunks")

    # result checks
    fs = res.state
    if not torch.equal(fs.cut_count, tb.recount_cuts(bg, fs.board)):
        fail("cut_count disagrees with a recount from the board")
    pop0 = ((fs.board == 0) * bg.pop).sum(dim=1)
    if not torch.equal(fs.dist_pop[:, 0].to(torch.int64), pop0):
        fail("dist_pop disagrees with a recount from the board")
    if not bool((fs.t_yield == WARMUP + STEPS).all()):
        fail(f"t_yield != {WARMUP + STEPS}")
    # waits_total sums per-chunk f32 partial sums: equal to the exact sum
    # of the recorded waits up to f32 accumulation over a chunk
    hist_sum = warm.history["wait"].astype("float64").sum(axis=1)
    if not (abs(warm.waits_total - hist_sum)
            <= 1e-4 * abs(hist_sum).clip(min=1.0)).all():
        fail("waits_total disagrees with the history's wait sum")
    boards = fs.board[:16].cpu().numpy()
    if not all(districts_connected(b, bg.h, bg.w) for b in boards):
        fail("a sampled chain has a disconnected district")
    rate = fs.accept_count.double().mean().item() / (STEPS - 1)
    if not ACCEPT_BAND[0] <= rate <= ACCEPT_BAND[1]:
        fail(f"accept rate {rate:.4f} outside {ACCEPT_BAND}")
    k_rate = (warm.state.accept_count.double().mean().item()
              / (WARMUP - 1))
    k_cut = float(warm.history["cut_count"][:, :-1].mean())
    p_bg, p_st, p_par = port.init_board(g, plan, n_chains=PLAIN_CHAINS,
                                        seed=0, spec=spec, base=BASE,
                                        pop_tol=POP_TOL, device=dev)
    p_rate, p_cut = plain_run(cb, p_bg, spec, p_par, p_st, WARMUP, 5)
    print(f"timed accept rate {rate:.6f}; first {WARMUP} steps: kernel "
          f"(C={CHAINS}) accept {k_rate:.6f} mean cut {k_cut:.4f}, plain "
          f"(C={PLAIN_CHAINS}) accept {p_rate:.6f} mean cut {p_cut:.4f}")
    if (abs(k_rate - p_rate) > ACCEPT_AGREE
            or abs(k_cut - p_cut) > CUT_AGREE * p_cut):
        fail("kernel and plain version disagree in distribution")

    # ---- timings at the main path's shape ------------------------------
    dp, scal, ints = cb.pack_state(fs, params)
    pop, deg = cb.make_static_inputs(bg)
    args = (spec, bg.h, bg.w, CHUNK, 7, 0, fs.board, pop, deg, dp, scal, ints)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    reps = 3
    ev[0].record()
    for _ in range(reps):
        outs = cb.run_board_chunk_cuda(*args)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / reps
    ev[0].record()
    plain = cb.board_chunk_reference(*args)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    for name, a, b in zip(range(12), outs, plain):
        if not torch.equal(a, b.to(a.dtype)):
            fail(f"main-path shape: output {name} differs from the plain "
                 "version")
    err = max(err, max_abs_diff(outs, plain))
    t_a = time.perf_counter()
    tb.apply_flip_log(fs.part_sum, fs.last_flipped, fs.num_flips, outs[4],
                      outs[5], fs.t_yield)
    torch.cuda.synchronize()
    flip_log_ms = 1e3 * (time.perf_counter() - t_a)
    t_a = time.perf_counter()
    tb.record_final(bg, spec, params, fs)
    torch.cuda.synchronize()
    final_ms = 1e3 * (time.perf_counter() - t_a)
    print(f"board_chunk: {ms:.3f} ms per {CHUNK}-step chunk (CUDA events, "
          f"mean of {reps}); plain version {plain_ms:.3f} ms; "
          f"apply_flip_log {flip_log_ms:.3f} ms wall; record_final "
          f"{final_ms:.3f} ms wall")

    n_cells = bg.n
    ops = OPS_PER_CELL_STEP * n_cells * CHAINS * CHUNK
    nbytes = (2 * CHAINS * n_cells            # board in, out (int8)
              + 8 * n_cells                   # pop, deg
              + 4 * CHAINS * (2 + 5 + 7 + 2 + 2 + 7)  # per-chain in, out
              + 4 * 6 * CHUNK * CHAINS        # six (T, C) rows
              + 8 * CHAINS * n_cells)         # cut_e, cut_s out
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    kernels = [{
        "name": "board_chunk", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/board_chunk.cu",
        "replaces": "flipcomplexityempirical_tpu/kernel/pallas_board.py:105",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
