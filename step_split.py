"""Where a ``board_pair_chunk`` step goes, by clock64 marks, on one card.

    python3 step_split.py

Copies the package to ``build/split/fce_split_torch``, inserts a mark at
each phase boundary of ``csrc/board_pair_chunk.cu`` (lane 0 reads
``clock64()`` and adds the cycles since the last mark to a per-chain
counter in device memory), builds that copy from its own sources, and runs
it at ``dense_turns.py``'s two board pair shapes (the kpair main path's
64x64, k = 4, C=4096, T=500 after a warm-up, and the kpair K4 config's
start, C=8, T=369). Its outputs must equal the kernel's own; then it prints
the card's name and power limit, both builds' ms a chunk (CUDA events) and
each phase's mean cycles a step and share of a chain's cycles. The marks
slow the kernel, so the shares are of the instrumented run.

Needs a CUDA card; exits 1 without one.
"""

import ctypes
import shutil
import sys

import chip_smoke as cs
import dense_turns as dt

SLOTS = 4096  # chains counted (chain c in slot c mod SLOTS)
# (phase name, the source line the mark goes before, its index)
MARKS = (
    ("start: board, copies, planes",
     "  // per-chain state, warp-uniform; lane d < k holds", 10),
    ("start: state, full count", "  int n_recounts = 0;", 11),
    ("draws", "    // ---- 2. wait, record ---", 0),
    ("wait, record", "    // ---- 3. select the m-th valid slot in three", 1),
    ("round 1", "      // round 2: the owner's word", 2),
    ("round 2", "      // round 3: the slot in that word's mask", 3),
    ("round 3", "      const int fr = row_of(flat, a.w_magic), fc = ", 4),
    ("dcut, accept", "      // ---- 4. commit ---", 5),
    ("commit: old bits, cut, parity",
     "        __syncwarp();\n        if (lane == 0) B[flat] =", 6),
    ("commit: board, new bits, b, tallies", "        uint32_t fm2, tm2;", 7),
    ("commit: masks, counts or recount",
     "        __syncwarp();\n        my_cnt = LC[lane];", 8),
    ("commit: prefix, tail", "    pending = accept;", 9),
    ("end: the last run, outputs", "}\n\n// the most shared memory", 12),
)


def instrument(src: str) -> str:
    """``src`` with the marks and a ``fce_split_io`` entry to zero and read
    the counters."""
    head = "namespace {\n\nusing namespace fce;"
    src = src.replace(head, (
        f"__device__ unsigned long long g_split[16 * {SLOTS}];\n" + head
        + "\n#define MARK(i) if (lane == 0) { const unsigned long long _t = "
        f"clock64(); atomicAdd(g_split + (i) * {SLOTS} + (c % {SLOTS}), "
        "_t - t_last); t_last = _t; }"), 1)
    start = "  // ---- the chunk's first board; the cut planes"
    src = src.replace(start, "  unsigned long long t_last = clock64();\n"
                      + start, 1)
    for _, anchor, i in MARKS:
        if src.count(anchor) != 1:
            sys.exit(f"step_split.py: no single {anchor!r} in the source")
        src = src.replace(anchor, f"MARK({i})\n" + anchor, 1)
    return src.replace('extern "C" {', (
        'extern "C" {\n\nint fce_split_io(unsigned long long* host, int zero)'
        " {\n  static unsigned long long z[16 * " + str(SLOTS) + "];\n"
        "  if (zero) return int(cudaMemcpyToSymbol(g_split, z, sizeof(z)));\n"
        "  return int(cudaMemcpyFromSymbol(host, g_split, sizeof(z)));\n}"),
        1)


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("step_split.py: no CUDA card", file=sys.stderr)
        sys.exit(1)
    import flipcomplexityempirical_tpu_torch as port
    from flipcomplexityempirical_tpu_torch import experiments as ex
    from flipcomplexityempirical_tpu_torch import sampling
    from flipcomplexityempirical_tpu_torch.experiments import driver as drv
    from flipcomplexityempirical_tpu_torch.kernel import cuda_board_pair as cbp
    dst = cs.ROOT / "build" / "split" / "fce_split_torch"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(cs.ROOT / "flipcomplexityempirical_tpu_torch", dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "csrc" / "board_pair_chunk.cu"
    cu.write_text(instrument(cu.read_text()))
    sys.path.insert(0, str(dst.parent))
    from fce_split_torch.kernel import _build as sbuild
    from fce_split_torch.kernel import cuda_board_pair as scbp
    io = sbuild.load("board_pair_chunk").fce_split_io
    io.argtypes = [ctypes.c_void_p, ctypes.c_int]
    print(cs.card_line())
    for label, bg, spec, params, st, t_len in dt.bpair_cases(port, drv, ex,
                                                             sampling):
        _, args = cs.bpair_args(cbp, bg, spec, params, st, t_len)
        c = st.board.shape[0]
        if not dt.same_outputs(scbp.run_board_pair_chunk_cuda(*args),
                               cbp.run_board_pair_chunk_cuda(*args)):
            cs.fail(f"{label}: the instrumented kernel's outputs differ")
        ms = cs.event_ms(lambda: scbp.run_board_pair_chunk_cuda(*args), 5)
        ms0 = cs.event_ms(lambda: cbp.run_board_pair_chunk_cuda(*args), 5)
        torch.cuda.synchronize()
        io(None, 1)
        got = scbp.run_board_pair_chunk_cuda(*args)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (16 * SLOTS))()
        io(ctypes.addressof(buf), 0)
        cyc = np.frombuffer(buf, dtype=np.uint64).reshape(16, SLOTS)
        cyc = cyc[:, :min(c, SLOTS)].astype(np.float64) / (c // SLOTS or 1)
        total = cyc.sum(axis=0).mean()
        accepted = (got[4][5] - args[8][5]).double().mean().item()
        print(f"board_pair_chunk {label} T={t_len}: instrumented {ms:.4f} "
              f"ms, the kernel {ms0:.4f} ms a chunk (CUDA events, 5 "
              f"launches); {accepted:.1f} accepted moves a chain; "
              f"{total / t_len:.1f} cycles a step a chain")
        for name, _, i in MARKS:
            v = cyc[i].mean()
            print(f"  {name:38s} {v / t_len:9.1f} cycles a step "
                  f"({100 * v / total:5.1f} %)")


if __name__ == "__main__":
    main()
