#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` (needs one
CUDA card). It builds every kernel of the port from
``flipcomplexityempirical_tpu_torch/csrc``, holds each against its plain
PyTorch version on the card, drives the port's main path through the
entry points a user calls, checks what comes out, and prints:

  1. the card's name and power limit (``nvidia-smi``), the build time of
     all kernel sources (one nvcc each, started together) and each
     kernel's registers and spills;
  2. the probe path: ``python -m flipcomplexityempirical_tpu_torch.kernel.
     probes``'s ``run`` with the launch counts zeroed before and read
     after (one launch of each probe), then each probe kernel against its
     plain version with host bits and with Philox, bit-equal;
  3. the board-chunk kernel against its plain version, every output
     bit-equal, in both RNG modes: 64x64 at C=256, T=64; a non-uniform
     population plane; a width that straddles words (40x65); an empty
     valid set (pop_tol 0 on the balanced start);
  4. the main path at ``bench.py --pallas``'s configuration (64x64 rook
     grid, stripes plan, patch contiguity, base 2.63815853, pop_tol 0.1,
     C=4096, chunk 500, a 501-step warmup, 3001 timed steps) through
     ``run_board_cuda``: flips/s, peak memory, the kernel's launches
     (which must equal the chunks run), result checks, and the accept
     rate and mean cut count beside a 501-step plain-version run; then at
     that shape the kernel against its plain version in both RNG modes,
     bit-equal, the kernel's ms per chunk and the wall ms of
     ``apply_flip_log`` and ``record_final``; the kernel's bound, its
     valid cells counted by replaying the chunk's flip log; the device's
     idle share over 1001 main-path steps (``torch.profiler``); the SM
     clock and power draw under the kernel's load (``nvidia-smi``);
  5. the lowered-chunk kernel (the paper's experiment chains) against its
     plain version, every output bit-equal except counted log ties in the
     waits: sec11 and the Frankengraph at C=64, T=64, an empty valid set
     (pop_tol 0), contiguity 'none', accept 'always' (the resident planes
     updated after every step) and random starts where most cells are
     candidates; the rook route (plain rook grids on their stencil, the
     JAX package's ``_scan_bits`` draw for draw): 64x64 at C=256, T=64, a
     width that straddles words (40x65) and contiguity 'none', with the SE
     and SW cut planes zero and the launches counted; then against the
     JAX package's own 50-step sec11 chunk kept in
     ``tests/fixtures/torch/lowered_sec11.npz``;
  6. the lowered main path for sec11 (config 0B263P10), the Frankengraph
     (0B30P10) and the 64x64 rook grid (``bench.py``'s spec, no
     interface), each through ``run_board`` at C=4096, chunk
     500, a 501-step warmup and 3001 timed steps: flips/s, peak memory,
     the kernel's launches (equal to the chunks run) and the calls of
     ``apply_flip_log``, result checks (cut_count and dist_pop against
     recounts, both districts connected, accept rate and mean cut beside
     a 501-step plain run at C=256 whose chains must match the kernel's
     first 256 exactly), then at that shape the kernel against its plain
     version, the kernel's ms per chunk and the plain version's, the wall
     ms of ``apply_flip_log`` and its bound, the kernel's bound in two
     forms (the candidate form, its candidate cells replayed from the flip
     log, and the resident-plane form, its accepted moves counted), the
     idle share of 1001 steps and the SM clock under load; at the bench's
     spec (sec11 and the Frankengraph without the interface, checked
     against the plain version at C=4096 with its launch counted) one
     chunk at the bench's C=8192, the state twice over, whose halves must
     each equal the checked C=4096 outputs bit for bit, timed with its
     bound;
  7. the paper's experiment driver: the CLI as a user calls it
     (``python -m flipcomplexityempirical_tpu_torch.experiments --family
     frank --only 0B30P10`` at 100,000 steps, 8 chains) must leave the
     13 artifacts, and a second call must skip the config and leave every
     file as it was; the kernel against its plain version at that
     path's own shape (C=8, one 369-step chunk) for sec11 0B263P10 and
     the Frankengraph 2B333P90, from each config's start and from its
     state after 25,000 steps, then timed there beside the plain version
     with its bound; ``run_config`` for the same two configs at the
     paper's shape: seconds split into run, render and set-up, flips/s,
     the kernel's launches (equal to the chunks run), the calls of
     ``apply_flip_log`` (one a chunk and one in the final record) and
     checks on all 8 chains (cut_count against a recount, both
     districts connected, |part_sum| <= T, wait.txt from chain 0's wait
     total); the sec11 config stopped after two 25,000-step segments and
     resumed through ``run_config``, equal to the uninterrupted run in
     every history key and state field; the JAX package's Frankengraph
     run (``tests/fixtures/torch/experiment_frank.npz``) and its
     checkpoint after one segment, resumed, both equal under the CPU
     tests' tolerance; the device's idle share over a 10,001-step config
     and that config's time split (kernel, ``apply_flip_log``, host);
  8. the bench entry point as a user runs it, in a subprocess
     (``python -m flipcomplexityempirical_tpu_torch.bench``): ``--graph
     square``, ``--pallas``, ``--graph sec11 --ess`` and ``--graph frank``
     each print bench.py's headline with this card's name, the JAX
     package's body and the port's kernel, launched once a timed chunk,
     and sec11 its ``cut_ess_per_sec`` record, the ESS computed on the card
     (``ess_on_device``) within 1 % of the host's (``ess_host_check``);
     ``--grid 65`` exits nonzero naming ROADMAP B2;
  9. both rook routes against the exact stationary distribution of the
     3x4 grid of ``tests/test_enumeration.py`` (``tests/_torch_
     enumeration.py``): after each kernel is held against its plain
     version there, 4096 chains of the board-chunk kernel's Philox mode
     and of the lowered kernel's threefry route each run 2000 steps, then
     200 one-step calls whose boards are pooled; TV < 0.06 and E|cut|
     within 2 % (``test_enumeration.py``'s bar), the pool's TV < 0.03, and
     E|cut| and each node's district-1 share within 6 standard errors of
     their exact values, the errors measured across 32 groups of chains
     (``group_t``), at bases 0.5, 1.0 and 2.0;
  10. the general path's kernel, ``general_dense_chunk`` (the JAX
     package's rejection-free dense step, ``kernel/dense.py:303``),
     against its plain version, every state field and history row equal
     (log ties counted) with one launch counted a call: hex 64x64 at
     C=256 after a 501-step warm-up, T=500; hex 14x28 at C=8 and the
     experiment path's 2439-step chunk (its plain version held after
     phase 23); tri 14x28 with ``nobacktrack``;
     ``lazy_uniform``; contiguity 'none'; no valid move; a random
     population plane (the kernel's per-node population gate); the 1x2
     hex of phase 13; each case's launch shape (tables staged in shared
     memory or read through L1, which must be the 14x28 and 64x64
     lattices' paths respectively; shared memory a block; chains a block;
     resident blocks an SM) and its cycles a step (one timed launch x the
     SM clock read under the experiment path's load / T); then
     ``run_chains`` from the JAX package's own general_dense run
     (``tests/fixtures/torch/general_dense_hex.npz``), equal;
  11. the general main path: ``run_chains`` on hex_lattice(64, 64) at
     C=4096, chunk 500, 3001 steps after 501, the launch counts zeroed
     just before and read just after (one ``general_dense_chunk`` a
     chunk, no other kernel): flips/s, peak memory, the state against a
     recount, 16 chains connected; the kernel's ms per chunk (CUDA
     events) with the conn planes carried and filled, its plain
     version's ms and output from the same state (every state field and
     history row equal), its bound, the idle share of 1001 steps and the
     SM clock, its launch shape and cycles a step; the legacy body's ms a
     step over 20 steps; then ``bench --graph hex --ess --steps 1001
     --repeats 1`` in a subprocess (the bench's two repeats of 3001 timed
     steps cut to one of 1001: the legacy body's leg of its race would
     take most of the time limit):
     the dense body raced against the legacy one, the dense body winning,
     its kernel launched once a timed chunk, and its ``cut_ess_per_sec``
     record as phase 8's;
  12. the tri and hex families: one config of each at the paper's shape
     (100,000 steps, 8 chains) through ``run_config``, seconds split into
     run, render and set-up, the 7 artifacts, the counts zeroed before
     and read after (tri on ``lowered_chunk``, hex on
     ``general_dense_chunk``); the hex config stopped after 50,000 steps
     and resumed, equal to the clean run; the JAX package's four family
     runs and its hex checkpoint
     (``tests/test_torch_general_families.py``), equal under the CPU
     tests' rule; ``lowered_chunk`` at the tri config's own shape (14x28,
     C=8, a 369-step chunk from the start and after 25,000 steps) against
     its plain version, one launch counted a call, as phase 7 does;
  13. the dense chain on hex_lattice(1, 2) against its exact stationary
     distribution (``tests/_torch_enumeration.py``'s
     ``build_dense_transition``), phase 9's bars, at bases 0.7, 1.0 and
     1.4;
  14. the sweep service (``service/``), every line beside the card's name
     and power limit: the CLI as a user calls it (``python -m
     flipcomplexityempirical_tpu_torch.service --family frank --chains 8
     --steps 100000``) in a subprocess, exit 0, 24 ``[done]`` lines, one
     batch of 192 chains whose lowered_chunk launches equal its chunks;
     ``SweepService`` in-process on the sec11, frank, tri and hex sweeps
     at the paper's shape (seed 0), the counts zeroed just before and read
     just after: one batch a sweep, seconds split into prepare, run and
     slice/assemble, flips/s, peak memory, launches equal to the chunks,
     and the tenants 0B263P10, 2B333P90, tri-0B333P10 and hex-0B333P10
     equal field for field, in every history key, to phases 7 and 12's
     solo runs of the same configs; the idle share of each sweep's batch
     over 10,001 steps; lowered_chunk at the frank batch's shape (C=192,
     the 24 tenants' parameters, its 369-step chunk) and
     general_dense_chunk at the hex batch's (C=32, its 2439-step chunk,
     its plain version held after phase 24), each against its plain
     version with one launch counted and timed beside its bound, the
     dense kernel's
     launch shape and cycles a step; ``bench --service --steps 400`` in
     a subprocess, its tenant_efficiency record;
  15. the device analytics: ``summary_fold`` (``csrc/summary_fold.cu``)
     against its plain version (``stats/accumulators.py::fold_block``),
     every field, the buffer and the series bit-equal (NaN for NaN), one
     launch counted a call, two folds in turn, at sec11's main-path rows
     (C=4096, T=500), the experiment path's (C=8, T=369), the hex batch's
     dense rows (C=32, T=2439), the general main path's (hex 64x64,
     C=4096, T=500), a buffer cap of 8 that decimates inside a chunk and
     rows without waits, each timed with CUDA events beside its byte
     bound; at the same cases but the last (no chunk kernel records
     without a wait) the chunk kernel that makes the rows
     (``lowered_chunk``, ``general_dense_chunk``: its wide form at C=32,
     its narrow form at C=4096, the fold instantiation's launch shape
     printed) folding its own records without a history (on a fold warp,
     on the chains' warps in the dense narrow form; the form printed),
     its state, flip log and outputs bit-equal to its history-mode launch
     and its accumulator to the standalone fold, and the history chunk,
     the fused chunk and the history chunk plus the standalone fold timed
     in turns; then
     ``run_config`` in summary mode for sec11 0B263P10, frank 2B333P90 and
     hex-0B333P10 at the paper's shape, the counts zeroed just before and
     read just after: every artifact byte-equal to phases 7 and 12's
     history-mode runs, one fused launch a chunk and one standalone fold
     launch (the run's one-row record), the seconds split, the readback
     bytes, and ``data["summary"]`` bit-equal to the plain fold of the
     history-mode run's history on the card (held after phase 24);
  16. ``general_dense_chunk``'s interface form (``record_interface``:
     the slope and angle rows from a wall bitset a chain) against its plain
     version, every state field and row bit-equal, NaN for NaN, one launch
     counted a call and timed beside its bound: sec11 with
     ``nobacktrack`` and the Frankengraph with ``lazy_uniform`` at the
     experiment path's shape (C=8, T=2439; their plain versions held
     after phase 24), sec11 at C=4096,
     T=500 (``dense_turns.py`` times the hex instantiations, which have
     no walls, in turns against an earlier kernel);
  17. the pair walk's kernel, ``general_pair_chunk`` (the JAX package's
     dense step under proposal 'pair', ``kernel/dense.py:257``), against
     its plain version, bit-equal, one launch counted a call: the dual
     sweep's K4 and K8 configs at their shape (144 nodes, C=8, T=2439;
     their plain versions held after phase 24),
     hex 64x64 at k=4, C=4096, T=500 (timed beside its bound), each with
     its launch shape (tables staged or read through L1, bytes a chain,
     chains a block, blocks an SM: more than 8 chains resident an SM at
     hex 64x64), cycles a step at the SM clock under load and the full
     recounts of its valid pairs in the chunk; then
     ``run_chains`` at that shape with the count zeroed just before and
     read just after (one launch a chunk): flips/s, peak memory, the
     distinct-pair count against a recount, the idle share;
  18. the pair kernel's chains against the exact stationary law of the
     pair chain (``_torch_enumeration.build_pair_transition``): the 3x3
     grid at k = 3 and a 12-node dual map at k = 3 with ``weighted_cut``,
     phase 13's bars;
  19. ``run_config`` at the paper's shape for dual-K4-0B263P25,
     dual-K8-0B263P25 and sec11 0B263P10 with ``--variant
     nobacktrack``, the counts zeroed before each (one launch a chunk),
     seconds split into run, render and set-up, every artifact written;
     the card's 401-step runs of dual-K4 and sec11 ``nobacktrack`` equal
     to the JAX-made fixtures (``tests/test_torch_general_experiments.
     py``); the dual sweep through ``SweepService`` (one batch a k), its
     K4 and K8 tenants equal to their solo runs; sec11 with contiguity
     'exact' (the legacy body, 8 chains, 250 steps) equal to its run on
     the host;
  20. the rook board's pair kernel, ``board_pair_chunk`` (the JAX
     package's ``_scan_bits_pair``, ``kernel/board.py:1406``, and its int8
     form, with the flip log's replay ``apply_flip_log``), against its
     plain version, bit-equal on every output, part_sum / last_flipped /
     num_flips included (log ties counted), one launch counted a call,
     the inputs left as they were, from states the kernel advanced first:
     64x64 at k=4 (C=256, T=64), 40x65 at k=3, 8x16 at k=8 with gates that
     bind (C=125: the last block holds one of its two chains),
     contiguity 'none', accept 'always',
     parity_metrics off and pop_tol 0 on the balanced start (an empty
     valid set); each case's launch shape (bytes a chain, chains resident
     an SM, waves, registers) and full recounts a chunk;
  21. the kpair main path: ``run_board`` on the 64x64 rook grid at k=4,
     C=4096, chunk 500, 1001 steps, the counts zeroed just before and read
     just after (one ``board_pair_chunk`` a chunk, no ``lowered_chunk``,
     ``apply_flip_log`` in the final record only): flips/s, peak memory, cut_count and dist_pop against recounts, 16
     chains' districts connected, the idle share (after a traced warm-up
     run; not measured where the trace drops a counted launch twice);
     then at that shape from
     its final state the kernel timed beside its bound, its launch shape,
     full recounts and cycles a step, and held to its plain version (after
     phase 23);
     ``bench --k 4 --repeats 1`` in a subprocess (its headline
     ``flips_per_sec_per_chip_64x64_pair_k4``, one launch a timed chunk);
     the 3x3 grid at k=3 on the board route against the pair chain's
     exact law, phase 18's bars;
  22. the kpair family: the kernel at the experiment path's shape (kpair
     K4's start, C=8, T=369), timed with its full recounts, and held to
     its plain version (after phase 24);
     ``run_config`` for kpair-K4-0B263P50 and kpair-K8-0B263P50 at the
     paper's shape (100,000 steps, 8 chains), the count zeroed before each
     (one launch a chunk): seconds split into run, render and set-up,
     every artifact, cut_count against a recount and every district
     connected on all 8 chains; the card's 401-step run equal to the JAX
     package's (``tests/fixtures/torch/experiment_kpair.npz``);
  23. the temper family: ``run_config`` for temper-0B333P10R10S50 at the
     paper's shape (8 ladders of 10 rungs, 100,000 steps, a swap round
     every 50 transitions), the ``lowered_chunk`` count zeroed just before
     and read just after (one launch a round): seconds split, the swap
     rate of each adjacent rung pair, ``rungs.png`` and every artifact;
     the swap round's wall ms at that batch; ``lowered_chunk`` at that
     batch (C=80, T=50) from the state and the permuted betas of three
     swap rounds, timed beside its bound, and held to its plain version
     (after phase 24);
     the card's 201-step run
     equal to ``tests/fixtures/torch/experiment_temper.npz``; each rung's
     cut-count law against the exact joint tempered law on the 3x4 grid
     (beta 1.0 / 0.5, base 3, a swap round after every transition, 2048
     ladders, 600 recorded steps after 600; ``tests/test_tempered.py:139``'s
     setting), phase 13's bars;
  24. ReCom, the spanning-tree recombination chain, on its kernel
     ``recom_chunk`` (the JAX package's ``sampling/recom.py:55-338``),
     every line beside the card's name and power limit: the kernel
     against its plain version (``sampling/recom.py::
     recom_chunk_reference``), every state field and row bit-equal, the
     waits included (both take CUDA's logf, so any difference fails), the
     wrapper's shared-memory formula equal to the kernel's layout, one
     launch counted a call, from states the kernel
     advanced first: 64x64 at k=4 (C=64, T=16), 32x32 at k=4 (two sort
     rounds), 8x8 at k=2 (one), the dual fixture map at k=4 (populations
     that vary by node) and 6x6 at k=2 with eps 0.06 and one tree attempt
     (moves that find no balanced edge); the kernel at C=1024, T=32 on
     64x64 timed beside its bound, its launch shape, the plain version at
     C=1024, T=2, and the BFS levels of 16 chains' next spanning trees;
     ``run_recom`` at that shape, 65 steps, the count
     zeroed just before and read just after (one launch a chunk): moves/s,
     peak memory, the idle share, cut / cut_deg / dist_pop / cut_count /
     b_count against a recount, 16 chains' districts connected and within
     epsilon of the target; ``run_config`` for kpair-recom K4 on the 64x64
     grid at 8 chains and 1,000 steps (seconds split, every artifact); the
     card's runs of the JAX-made fixtures
     (``tests/fixtures/torch/experiment_recom*.npz``) equal under
     ``tests/test_torch_recom.py``'s rule;
  25. the plain versions held in phases 10, 14-17 and 21-23 (the
     experiment path's 2439-step chunks at C=8 and C=32, whose plain
     versions take ~13-18 ms a step on the host, the plain folds of phase
     15's 100,000-step histories, the board pair chunk at C=4096,
     T=500 and at C=8, T=369, and the temper path's lowered chunk),
     run at once after phase 24, one worker process each (nothing is
     timed meanwhile; each plain time is a host clock's beside the
     others'), each held to its kernel's output as in its phase;
  26. the script's own total seconds, one JSON line per kernel table
     (``{"kernels": [...]}``), then as the last line ``{"ok": true,
     "device": {...}}``.

``--baseline PATH`` also builds an earlier ``board_chunk.cu`` (the first
version's C interface), checks that its outputs equal the current
kernel's at the main path's shape and times the two in turn (baseline,
current, current, baseline; three rounds) in the same call.
``--baseline-lowered PATH`` does the same for an earlier
``lowered_chunk.cu`` (the same C interface; one from before the fold's
two trailing arguments takes the first, null, as its stream: the default
stream, which this script runs on) at both lowered main paths.

Any failed phase exits nonzero before the last line. Without a CUDA card,
or without the port's package beside it, the script exits nonzero and
prints no result.
"""

import contextlib
import io
import json
import pathlib
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
# (label, h, w, chains, pop_tol, random population plane): the extra
# board-chunk cases of phase 3
EXTRA_CASES = (("non-uniform pop", 48, 48, 128, 0.05, True),
               ("word-straddling width", 40, 65, 128, 0.1, False),
               ("empty valid set", 64, 64, 64, 0.0, False))
PLAIN_CHAINS = 256
DEVICE = "cuda"
ACCEPT_BAND = (0.40, 0.55)      # accepted share of transitions
ACCEPT_AGREE = 0.02             # |kernel - plain| accept rate, 501 steps
CUT_AGREE = 0.05                # relative |kernel - plain| mean cut count
PROBE_REPS = 100                # launches per probe timing

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the non-tensor
# FP32 rate, the sheet's only row for CUDA-core arithmetic (the int32 pipe
# is narrower, so the bounds below are floors).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations the board-chunk function needs in its packed form, counted on
# this run's data (a floor, so every count is a lower bound):
#   ops = C * T * (K_WORD * ceil(N / 32) + K_TAIL)
#         + K_BWORD * sum(ceil(h_b / 32)) + K_CELL * sum(valid)
# K_WORD, every word of 32 cells and step: 4 rook funnel shifts, the 4
# "differ" planes (xor, and: 8), the boundary (3 or), 3 popcounts and 3
# adds: 21.
# K_BWORD, each word that holds a boundary cell (at least ceil(h_b / 32)
# of them a chain-step, h_b the step's boundary count): 4 diagonal funnel
# shifts, the same-district planes (4 rook and-not, 4 diagonal xor and 8
# mask ands: 16), 4 run planes (and, and-not: 8), two at-most-one tests
# (7 each: 14), contiguity and candidates (2), the group mask and its
# popcount (8): 52. Other words need no ring criterion.
# K_TAIL, per chain-step: the scalar draw (one Philox block, 100, and two
# logs, ~40), the wait (~25), the population gate of a uniform plane (8),
# the accept test (~15) and the commit with its cut_times events (~60):
# 250.
# K_CELL, per valid cell (replayed from the chunk's flip log): a quarter
# of a Philox block (25) and the key and its compare (3): 28; K_GATE more
# (the per-cell population gate) where the plane is not uniform.
K_WORD, K_BWORD, K_TAIL, K_CELL, K_GATE = 21, 52, 250, 28, 8
# The per-cell design's figure, kept for comparison: 61 operations a
# cell-step plus 25 for a Philox draw per cell.
PER_CELL_OPS = 61 + 25
# Probes, per element and step: a quarter of a Philox block (25), the sign
# flip and the max (2); probe B adds the mask test, select and or (3).
K_PROBE = {"a": 27, "b": 30}


# The lowered path: (name, builder, plan, base) of the paper's two
# experiment graphs at alignment 0 and pop_tol POP_TOL, configs 0B263P10
# and 0B30P10 (experiments/config.py), with the families' spec
# (experiments/driver.py::spec_for: record_interface on).
LOWERED = (("sec11", "grid_sec11", "sec11_plan", 2.63815853),
           ("frankengraph", "frankengraph", "frank_plan", 0.3))
LOWERED_EXACT_C, LOWERED_EXACT_T = 64, 64
LOWERED_FIXTURE = "tests/fixtures/torch/lowered_sec11.npz"
FIXTURE_SEED, FIXTURE_C, FIXTURE_T = 11, 4, 50
FIXTURE_WAIT_SHARE = 0.02       # wait rows off by a log tie, at most
# The experiment driver (phase 7): the paper's shape (100,000 steps, 8
# chains, chain 0 renders), the configs run in-process (the families'
# 0B263P10 and 2B333P90) and by the CLI, the resume's segment, the steps
# of the profiled config, and the JAX package's Frankengraph run and its
# checkpoint after the first segment (tests/test_torch_experiments_
# fixture.py), held under the CPU tests' tolerance.
EXP_STEPS, EXP_CHAINS = 100_000, 8
# The plain versions held (run in plain_jobs, all at once after phase 24,
# one worker process each) rather than in their phase: those of the
# experiment path's 2439-step chunks (phases 10, 14, 16 and 17), host-bound
# at ~13-18 ms a step at C=8, and phase 15's plain folds of a 100,000-step
# history; each is held to its kernel's output there
PLAIN_JOBS = []
PLAIN_JOB_TIMEOUT = 900
EXP_RUNS = (("sec11", "0B263P10"), ("frank", "2B333P90"))
EXP_CLI_TAG = "0B30P10"
EXP_CKPT_EVERY = 25_000
EXP_PROFILE_STEPS = 10_001
EXP_FIXTURE = "tests/fixtures/torch/experiment_frank.npz"
EXP_FIXTURE_CKPT = "tests/fixtures/torch/experiment_frank_ckpt"
EXP_FIXTURE_CFG = dict(family="frank", alignment=0, base=0.3, pop_tol=0.5,
                       total_steps=401, n_chains=2, seed=0)
EXP_FIXTURE_CKPT_EVERY = 200
# The rook route through lowered_chunk: (label, h, w, chains, pop_tol,
# spec overrides) of its exactness cases
ROOK_EXACT_CASES = (("64x64", GRID, GRID, EXACT_CHAINS, POP_TOL, {}),
                    ("word-straddling width 40x65", 40, 65, 128, POP_TOL,
                     {}),
                    ("64x64 contiguity none", GRID, GRID, EXACT_CHAINS,
                     POP_TOL, {"contiguity": "none"}))
# The bench entry point's runs: (label, arguments, bench.py's metric, the
# JAX package's body, the port's kernel)
BENCH_RUNS = (
    ("square", [], "flips_per_sec_per_chip_64x64", "bitboard",
     "lowered_chunk"),
    ("square --pallas", ["--pallas"], "flips_per_sec_per_chip_64x64",
     "pallas", "board_chunk"),
    ("sec11", ["--graph", "sec11", "--ess"], "flips_per_sec_per_chip_sec11",
     "lowered_bits", "lowered_chunk"),
    ("frank", ["--graph", "frank"], "flips_per_sec_per_chip_frank",
     "lowered_bits", "lowered_chunk"))
# The stationary-distribution check (tests/test_enumeration.py's grid and
# bar): bases, chains, burn-in steps and pooled one-step samples
ENUM_BASES = (0.5, 1.0, 2.0)
ENUM_BURN = 2000        # chains and samples: _torch_enumeration's
# Operations the lowered-chunk function needs, counted on this run's data
# (a floor), in two forms; the bound takes the smaller.
# The candidate form checks the patch of every candidate cell each step:
#   ops = C * T * (K_LWORD * ceil(N / 32) + K_LTAIL + 6 * K_BLOCK)
#         + (K_BLOCK + K_WAIT) * accepted moves + K_CAND * candidates
# The resident form keeps the boundary and the patch verdicts in planes
# and brings them up to date around each accepted move:
#   ops = C * T * (K_RWORD * ceil(N / 32) + K_LTAIL + 6 * K_BLOCK)
#         + (K_BLOCK + K_WAIT + K_MOVE) * accepted moves
# K_LWORD, every word of 32 cells and step in the candidate form: 8
# direction funnel shifts, xor, and, or (32), 4 wall-plane ands, the
# population gate (3), a popcount and an add: 41.
# K_RWORD, the same in the resident form: the population gate (and,
# and-not, or: 3), the ands with bnd and ok (2), a popcount and an add: 7.
# K_BLOCK, one threefry2x32 block: 20 rounds of add, rotate, xor and 5 key
# injections of 3: 77. Six a chain-step: the four-way split, the proposal
# and the accept uniforms; a seventh (the wait's) and the wait itself
# (K_WAIT ~30, logs included) after each accepted move.
# K_LTAIL, per chain-step: the selection scan, the accept test with its
# log, the commit and the record: ~100.
# K_CAND, per candidate cell (boundary & population gate, replayed from
# the flip log): the 5 x 5 window as five 5-bit fields (25) and the member
# and seed masks (5): 30. The worklist, data-dependent, is left out.
# K_MOVE, per accepted move in the resident form: the 25 patch verdicts of
# the flipped cell's window (K_CAND each, worklists left out), the 9
# boundary bits of the cell and its ring neighbours (8 directions of
# neighbour bit, xor, adjacency and, or; then the old bit, a compare and
# the boundary count's update: 35 each) and the wall-edge test (8 edges of
# adjacency bit, wall bit, and: 24): 25 * 30 + 9 * 35 + 24 = 1089. The
# wall rescan after a move with a wall edge is left out.
K_LWORD, K_BLOCK, K_LTAIL, K_WAIT, K_CAND = 41, 77, 100, 30, 30
K_RWORD, K_BCELL, K_WALL = 7, 35, 24
K_MOVE = 25 * K_CAND + 9 * K_BCELL + K_WALL


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


def event_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, with the card kept
    busy (``torch.cuda._sleep``) while the host enqueues them, so a call
    whose wrapper takes longer on the host than its kernel on the card
    is timed by the kernel, not by the gaps between launches."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000 * reps)        # ~1 ms a call at 2 GHz
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def event_ms_once(fn) -> tuple:
    """(device ms, result) of one call of ``fn`` (CUDA events)."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), out


def hold_plain(name: str, ref, args, check, defer: bool = False) -> float:
    """The plain version ``ref(*args)`` (a module-level function of the
    port) of kernel ``name`` and its host seconds handed to
    ``check(want, seconds)``, which holds it to the kernel's output and
    returns the largest difference: here and now, returning that, or with
    ``defer`` queued for plain_jobs, the inputs saved as they are now
    (returning 0.0; plain_jobs returns the difference)."""
    import torch
    if defer:
        buf = io.BytesIO()
        torch.save({"module": ref.__module__, "name": ref.__name__,
                    "args": args}, buf)
        PLAIN_JOBS.append((name, ref.__name__, buf.getvalue(), check))
        return 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref(*args)
    torch.cuda.synchronize()
    return check(want, time.perf_counter() - t0)


def plain_jobs(card: str) -> dict:
    """Run every queued plain version at once, one worker process each
    (``chip_smoke.py --plain-job IN OUT``: the call and its output go
    through ``torch.save`` files under build/), then hand each output to
    its check. Nothing is timed while they run; each worker times its own
    call on the host's clock, beside the others. Returns the largest
    difference the checks found, by kernel name."""
    import tempfile

    import torch
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        procs, paths = [], []
        t0 = time.perf_counter()
        try:
            for i, (_, _, job, _) in enumerate(PLAIN_JOBS):
                base = pathlib.Path(tmp) / f"plain{i}"
                pathlib.Path(f"{base}.in").write_bytes(job)
                err = open(f"{base}.err", "w")
                procs.append(subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--plain-job", f"{base}.in", f"{base}.out"],
                    cwd=ROOT, stdout=subprocess.DEVNULL, stderr=err))
                err.close()
                paths.append(base)
            deadline = time.monotonic() + PLAIN_JOB_TIMEOUT
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            fail(f"the plain versions did not finish within "
                 f"{PLAIN_JOB_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        print(f"[{card}] plain versions held after phase 24: "
              f"{len(procs)} at once, one worker process each, in "
              f"{wall:.3f} s wall")
        out = {}
        for (name, ref, _, check), p, base in zip(PLAIN_JOBS, procs, paths):
            if p.returncode != 0:
                tail = pathlib.Path(f"{base}.err").read_text()[-2000:]
                fail(f"the plain version {ref} of {name} exited "
                     f"{p.returncode}:\n{tail}")
            res = torch.load(f"{base}.out", map_location=DEVICE,
                             weights_only=False)
            out[name] = max(out.get(name, 0.0),
                            check(res["out"], res["seconds"]))
    PLAIN_JOBS.clear()
    return out


def plain_job(inp: str, out: str) -> None:
    """A plain_jobs worker: load the call, run it, save its output and
    host seconds."""
    import importlib

    import torch
    job = torch.load(inp, weights_only=False)
    ref = getattr(importlib.import_module(job["module"]), job["name"])
    sync = (torch.cuda.synchronize if torch.cuda.is_available()
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    res = ref(*job["args"])
    sync()
    torch.save({"out": res, "seconds": time.perf_counter() - t0}, out)


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
    print(f"{label}: differing waits {wait_diff}, accepts "
          f"{int((got[3][5] - args[11][5]).sum())}")
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w.to(g.dtype)):
            fail(f"{label}: {name} differs from the plain version")
    return max_abs_diff(got, want)


def host_bits(cb, t_len: int, chains: int, n: int, seed: int):
    """(T, C, N) and (T, 2, C) int32 bit patterns of uniform uint32 draws,
    made on the card one step at a time."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    plane = torch.empty((t_len, chains, n), dtype=torch.int32,
                        device=DEVICE)
    for t in range(t_len):
        plane[t] = cb.bits_tensor(torch.randint(
            0, 2 ** 32, (chains, n), device=DEVICE, generator=gen), DEVICE)
    scal = cb.bits_tensor(torch.randint(0, 2 ** 32, (t_len, 2, chains),
                                        device=DEVICE, generator=gen),
                          DEVICE)
    return plane, scal


def chunk_cases(cb, port, t_len: int, chains: int, h: int, w: int,
                tol: float, random_pop: bool, label: str) -> float:
    """The board-chunk kernel against its plain version in both RNG modes
    from the stripes start of an h x w grid; returns max |diff|."""
    import numpy as np
    import torch
    g = port.graphs.square_grid(h, w)
    spec = port.Spec(contiguity="patch")
    bg, st, params = port.init_board(g, port.graphs.stripes_plan(g, 2),
                                     n_chains=chains, seed=1, spec=spec,
                                     base=BASE, pop_tol=tol, device=DEVICE)
    pop, deg = cb.make_static_inputs(bg)
    dp, scal, ints = cb.pack_state(st, params)
    if random_pop:
        rs = np.random.default_rng(h * w)
        pop = torch.as_tensor(rs.integers(1, 20, h * w), dtype=torch.int32,
                              device=DEVICE)
        p1 = (st.board.long() * pop).sum(dim=1)
        dp = torch.stack([pop.sum() - p1, p1]).to(torch.int32)
        ideal = float(pop.sum()) / 2
        scal = scal.clone()
        scal[2], scal[3] = ideal * (1 - tol), ideal * (1 + tol)
    common = (spec, h, w, t_len, 99, 3, st.board, pop, deg, dp, scal, ints)
    bits = host_bits(cb, t_len, chains, h * w, 1234)
    err = compare_chunk(cb, (*common, *bits), f"{label} host bits")
    del bits
    return max(err, compare_chunk(cb, (*common, None, None),
                                  f"{label} device rng"))


def valid_cells(tb, bg, spec, board, pop, dist_pop, scal, outs):
    """Sum over the chunk's steps and chains of the valid cells (boundary,
    contiguity, population gate) before each step, replayed on the card
    from the chunk's flip log (``outs`` of a chunk from ``board``); the
    replay must give the kernel's boundary counts and final board."""
    import torch
    t_len, c = outs[7].shape
    b = board.clone()
    dp = dist_pop.to(torch.int64).clone()
    popn, pop64 = pop.to(torch.float32), pop.to(torch.int64)
    pop_lo, pop_hi = scal[2][:, None], scal[3][:, None]
    ar = torch.arange(c, device=b.device)
    # accept count and last flipped cell after each step
    acc = torch.cat([outs[9][1:], outs[3][5][None]])
    flip = torch.cat([outs[4][1:], outs[3][1][None]]).long()
    before = outs[9][0]
    total = torch.zeros((), dtype=torch.int64, device=b.device)
    for t in range(t_len):
        same = tb.same_planes(bg, b)
        same_deg = sum(same[i].to(torch.int32) for i in (0, 2, 4, 6))
        ok = bg.deg[None] - same_deg > 0
        if not torch.equal(ok.sum(dim=1).to(torch.int32), outs[7][t]):
            fail(f"valid-cell replay: boundary counts differ at step {t}")
        if spec.contiguity == "patch":
            ok &= tb.ring_contig_ok(same)
        is1 = b == 1
        pop_of = torch.where(is1, dp[1][:, None], dp[0][:, None])
        pop_to = torch.where(is1, dp[0][:, None], dp[1][:, None])
        ok &= ((pop_of.to(torch.float32) - popn >= pop_lo)
               & (pop_to.to(torch.float32) + popn <= pop_hi))
        total += ok.sum()
        moved = acc[t] != before
        before = acc[t]
        d_from = b[ar, flip[t]]
        b[ar, flip[t]] = torch.where(moved, 1 - d_from, d_from)
        pv = torch.where(moved, pop64[flip[t]], 0)
        sign = torch.where(d_from == 0, 1, -1)
        dp[0] -= sign * pv
        dp[1] += sign * pv
    if not torch.equal(b, outs[0]):
        fail("valid-cell replay: final board differs from the kernel's")
    return int(total)


def idle_share(run, counted=None) -> str:
    """``run()`` (some steps of a main path) under ``torch.profiler``: the
    device's busy ms by kernel against the wall. With ``counted`` =
    (kernel name, its wrapper) ``run()`` runs twice in one profile, the
    first as the trace's warm-up (traced and discarded), and the second's
    trace must hold every launch of that kernel the wrapper counted in
    it: a trace that dropped one is taken once more, and where that one
    drops one too the idle share is not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    warm = schedule(wait=0, warmup=1, active=1, repeat=1) if counted else None
    for _ in range(2 if counted else 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=warm) as prof:
            if counted:
                run()
                torch.cuda.synchronize()
                prof.step()
            n0 = counted[1].launches if counted else 0
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            if counted:
                prof.step()
        busy, seen = {}, 0
        for ev in prof.key_averages():
            dt = getattr(ev, "device_time_total", None)
            if dt is None:
                dt = getattr(ev, "cuda_time_total", 0.0)
            # the schedule's step ranges are on the device's timeline too
            step = (getattr(ev, "is_user_annotation", False)
                    or ev.key.startswith("ProfilerStep"))
            if (dt and ev.device_type == torch.autograd.DeviceType.CUDA
                    and not step):
                busy[ev.key[:60]] = dt / 1e3
                if counted and counted[0] in ev.key:
                    seen += ev.count
        if not counted or seen == counted[1].launches - n0:
            break
    else:
        return (f"wall {wall:.3f} ms; device time not measured (the trace "
                f"holds {seen} of the {counted[1].launches - n0} "
                f"{counted[0]} launches)")
    if not busy:
        return f"wall {wall:.3f} ms; device time not measured (no trace)"
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:3]
    return (f"wall {wall:.3f} ms, device busy {sum(busy.values()):.3f} ms, "
            f"idle share {1 - sum(busy.values()) / wall:.4f}; top: "
            + "; ".join(f"{k} {v:.3f} ms" for k, v in top))


def clocks_under_load(fn, launches: int) -> str:
    """``nvidia-smi``'s SM clock and power draw, read while ``launches``
    calls of ``fn`` run on the card."""
    import torch
    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    torch.cuda.synchronize()
    return out.stdout.strip() or "not measured"


def build_baseline(path: str, stem: str):
    """Build an earlier kernel source with the package's flags into the
    build directory; returns the loaded library."""
    import ctypes
    from flipcomplexityempirical_tpu_torch.kernel import _build
    lib_path = _build.build_dir() / f"{stem}.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path), path], capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        fail(f"{stem} build failed:\n{out.stdout}{out.stderr}")
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line:
            print(f"  {stem}: {line.strip()}")
    return ctypes.CDLL(str(lib_path))


def timed_rounds(base, cur, label: str) -> None:
    """Time baseline, current, current, baseline, three rounds."""
    for r in range(3):
        for which, fn in (("baseline", base), ("current", cur),
                          ("current", cur), ("baseline", base)):
            fn()
            print(f"{label}round {r} {which}: {event_ms(fn, 3):.3f} ms per "
                  f"{CHUNK}-step chunk (CUDA events, mean of 3)")


def baseline_rounds(cb, args, path: str) -> None:
    """Build an earlier board_chunk.cu (the first version's interface, no
    last-flip scratch), check that its outputs equal the current kernel's,
    and time the two in turns in this call."""
    import torch
    lib = build_baseline(path, "baseline_board_chunk")
    base = lambda: cb._launch(lib, (*args, None, None),  # noqa: E731
                              scratch=False)
    cur = lambda: cb.run_board_chunk_cuda(*args)  # noqa: E731
    if not all(torch.equal(g, w) for g, w in zip(base(), cur())):
        fail("the baseline kernel's outputs differ from the current one's")
    print("baseline outputs equal the current kernel's")
    timed_rounds(base, cur, "")


def baseline_lowered_rounds(cl, lib, args, which: str) -> None:
    """An earlier lowered_chunk.cu (``lib``, the same C interface) against
    the current kernel on the same inputs: every output equal (NaN where
    NaN), then the two timed in turns in this call."""
    import torch
    base = lambda: cl._launch(lib, *args)  # noqa: E731
    cur = lambda: cl.run_lowered_chunk_cuda(*args)  # noqa: E731
    got_b, got_c = base(), cur()
    torch.cuda.synchronize()
    for name, b, c in zip(cl.OUT_NAMES, got_b, got_c):
        same = b == c
        if b.dtype.is_floating_point:
            same |= torch.isnan(b) & torch.isnan(c)
        if not bool(same.all()):
            fail(f"baseline lowered {which}: {name} differs from the "
                 "current kernel's")
    print(f"baseline lowered {which}: outputs equal the current kernel's")
    timed_rounds(base, cur, f"lowered {which} ")


@contextlib.contextmanager
def count_calls(modules, name: str):
    """Count the calls of ``name`` made inside the block through any of
    ``modules`` (each module that imported it by name): yields a list that
    grows by one a call."""
    calls = []
    origs = [getattr(m, name) for m in modules]

    def counting(orig):
        def counted(*args, **kw):
            calls.append(1)
            return orig(*args, **kw)
        return counted

    for m, orig in zip(modules, origs):
        setattr(m, name, counting(orig))
    try:
        yield calls
    finally:
        for m, orig in zip(modules, origs):
            setattr(m, name, orig)


def flip_log_bound(state, log_f, log_s) -> str:
    """The bytes ``apply_flip_log`` must move for one chunk (the (T, C)
    flip-log rows and the t0 row read once, the (C, N) part_sum,
    last_flipped and num_flips planes read and written once) and their
    time at the card's memory rate."""
    def size(*xs):
        return sum(x.numel() * x.element_size() for x in xs)
    nbytes = (size(log_f, log_s, state.t_yield)
              + 2 * size(state.part_sum, state.last_flipped,
                         state.num_flips))
    return (f"apply_flip_log bound: {nbytes:.4e} bytes -> "
            f"{1e3 * nbytes / PEAK_BYTES_PER_S:.4f} ms (bytes)")


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


def probe_phase(probes) -> list:
    """Drive the probe entry point with the counts zeroed, then hold each
    probe kernel against its plain version; returns the kernel rows."""
    import numpy as np
    import torch
    probes.probe_a.launches = probes.probe_b.launches = 0
    probes.run(DEVICE)
    launches = {"a": probes.probe_a.launches, "b": probes.probe_b.launches}
    print(f"probe path: probe_a launches {launches['a']}, probe_b launches "
          f"{launches['b']}")
    if launches != {"a": 1, "b": 1}:
        fail(f"the probe path launched {launches}, expected one each")
    rs = np.random.default_rng(7)
    rows, cols, steps = probes.ROWS, probes.COLS, probes.STEPS
    x_np = rs.integers(-3, 4, (rows, cols)).astype(np.int32)
    x_np[::5] = 0                       # some rows have no valid entry
    x = torch.as_tensor(x_np, device=DEVICE)
    bits = torch.as_tensor(rs.integers(0, 2 ** 32, (steps, rows, cols),
                                       dtype=np.uint32).view(np.int32),
                           device=DEVICE)
    rows_out = []
    for which, fn, line in (("a", probes.probe_a, 27),
                            ("b", probes.probe_b, 40)):
        err = 0.0
        for mode in (bits, None):
            got = fn(x, steps, probes.SEED, mode)
            want = probes.probe_reference(which, x, steps, probes.SEED,
                                          mode)
            torch.cuda.synchronize()
            label = "host bits" if mode is not None else "philox"
            err = max(err, float((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                fail(f"probe {which} ({label}) differs from its plain "
                     "version")
            print(f"probe {which} {label}: bit-equal to the plain version")
        ms = event_ms(lambda: fn(x, steps, probes.SEED), PROBE_REPS)
        plain_ms = event_ms(lambda: probes.probe_reference(
            which, x, steps, probes.SEED), 3)
        ops = K_PROBE[which] * rows * cols * steps
        nbytes = 4 * rows * cols * (which == "b") + 4 * rows
        t_ops = 1e3 * ops / PEAK_OPS_PER_S
        t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
        print(f"probe {which}: {ms:.4f} ms per launch (CUDA events, mean "
              f"of {PROBE_REPS}); plain version {plain_ms:.3f} ms")
        rows_out.append({
            "name": f"probe_{which}", "route": "cuda",
            "source": "flipcomplexityempirical_tpu_torch/csrc/probes.cu",
            "replaces": f"tools/mosaic_probes.py:{line}",
            "launches": launches[which], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})
    return rows_out


# ---------------------------------------------------------------------------
# The lowered path: sec11 and the Frankengraph through lowered_chunk
# ---------------------------------------------------------------------------

def lowered_workload(port, which: str, n_chains: int, seed: int,
                     pop_tol: float = POP_TOL, random_start: bool = False,
                     h: int = GRID, w: int = GRID, **spec_kw):
    """(graph, bg, state, params, spec) of one of ``LOWERED``'s graphs,
    from the family's plan, or of the plain h x w rook grid ("square")
    from its stripes plan with ``bench.py``'s spec (no interface), or,
    with ``random_start``, from a seeded random assignment (most cells on
    the boundary)."""
    import numpy as np
    if which == "square":
        g = port.graphs.square_grid(h, w)
        plan, base = port.graphs.stripes_plan(g, 2), BASE
        kw = dict(contiguity="patch", accept="cut")
    else:
        _, builder, plan_fn, base = next(x for x in LOWERED
                                         if x[0] == which)
        g = getattr(port.graphs, builder)()
        plan = getattr(port.graphs, plan_fn)(g, 0)
        kw = dict(contiguity="patch", accept="cut", record_interface=True)
    if random_start:
        plan = np.random.default_rng(seed).integers(0, 2, g.n_nodes)
    kw.update(spec_kw)
    spec = port.Spec(**kw)
    bg, st, params = port.init_board(g, plan, n_chains=n_chains, seed=seed,
                                     spec=spec, base=base, pop_tol=pop_tol,
                                     device=DEVICE)
    return g, bg, st, params, spec


def compare_lowered(cl, got, want, label: str) -> float:
    """The lowered kernel's outputs against its plain version's: integers
    and interface metrics bit-equal (NaN where NaN), waits equal except
    log ties (torch's ``log`` and the kernel's ``logf`` rounding one input
    apart moves a wait by exactly 1.0), which are counted; returns the
    largest |difference| of any other output."""
    import torch
    names = list(cl.OUT_NAMES)
    g, w = got[names.index("hist_wait")], want[names.index("hist_wait")]
    off = (g - w)[g != w].abs()
    if not bool((off == 1.0).all()):
        fail(f"{label}: a wait differs by other than a log tie")
    ties = int(off.numel())
    err = 0.0
    for name, g, w in zip(names, got, want):
        w = w.to(g.dtype)
        if g.dtype.is_floating_point:
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        else:
            same = g == w
        if name == "hist_wait":
            continue
        if name == "scal":      # cur_wait (a tie moves it by 1), waits_sum
            if not bool((same[0] | ((g[0] - w[0]).abs() == 1.0)).all()):
                fail(f"{label}: cur_wait differs by other than a log tie")
            if bool((~same[1]).any()) and ties == 0:
                fail(f"{label}: waits_sum differs without a log tie")
            continue
        if not bool(same.all()):
            fail(f"{label}: {name} differs from the plain version")
        if g.numel():
            d = (g.double() - w.double())[~torch.isnan(g.double())]
            err = max(err, float(d.abs().max()) if d.numel() else 0.0)
    print(f"{label}: bit-equal to the plain version; wait rows off by a "
          f"log tie {ties}")
    return err


def lowered_exactness(port, cl) -> float:
    """The lowered kernel against its plain version at C=64, T=64."""
    import torch
    err = 0.0
    for label, which, tol, kw in (
            ("sec11", "sec11", POP_TOL, {}),
            ("frankengraph", "frankengraph", POP_TOL, {}),
            ("sec11 empty valid set", "sec11", 0.0, {}),
            ("sec11 contiguity none", "sec11", POP_TOL,
             {"contiguity": "none"}),
            ("sec11 accept always", "sec11", POP_TOL, {"accept": "always"}),
            ("sec11 dense candidates", "sec11", POP_TOL,
             {"random_start": True}),
            ("frankengraph dense candidates, accept always", "frankengraph",
             POP_TOL, {"random_start": True, "accept": "always"})):
        _, bg, st, params, spec = lowered_workload(
            port, which, LOWERED_EXACT_C, 1, pop_tol=tol, **kw)
        static = cl.make_static_inputs(bg, spec, params)
        args = (bg, static, spec, LOWERED_EXACT_T, st.board,
                *cl.pack_state(st, params))
        got = cl.run_lowered_chunk_cuda(*args)
        torch.cuda.synchronize()
        want = cl.lowered_chunk_reference(*args)
        torch.cuda.synchronize()
        err = max(err, compare_lowered(
            cl, got, want, f"lowered {label} C={LOWERED_EXACT_C} "
            f"T={LOWERED_EXACT_T}"))
        moved = int((got[4][5] - st.accept_count).sum())
        b0 = float(got[8][0].double().mean())
        print(f"  {label}: boundary cells at step 0 {b0:.1f} of "
              f"{bg.n_real} a chain, accepted moves {moved} of "
              f"{LOWERED_EXACT_C * LOWERED_EXACT_T} chain-steps")
        if tol == 0.0 and moved:
            fail("the empty valid set moved a chain")
        if tol > 0.0 and not moved:
            fail(f"lowered {label}: no chain moved")
    return err


def rook_exactness(port, cl) -> float:
    """The lowered kernel on plain rook grids (the route of the JAX
    package's ``_scan_bits``) against its plain version: every output
    bit-equal except counted log ties in the waits, and the SE and SW cut
    planes zero (a rook grid has no diagonal edges); launches counted."""
    import torch
    err = 0.0
    cl.run_lowered_chunk_cuda.launches = 0
    for label, h, w, chains, tol, kw in ROOK_EXACT_CASES:
        _, bg, st, params, spec = lowered_workload(
            port, "square", chains, 1, pop_tol=tol, h=h, w=w, **kw)
        static = cl.make_static_inputs(bg, spec, params)
        args = (bg, static, spec, EXACT_T, st.board,
                *cl.pack_state(st, params))
        got = cl.run_lowered_chunk_cuda(*args)
        torch.cuda.synchronize()
        want = cl.lowered_chunk_reference(*args)
        torch.cuda.synchronize()
        err = max(err, compare_lowered(
            cl, got, want, f"rook {label} C={chains} T={EXACT_T}"))
        if bool(got[13][1].any()) or bool(got[13][3].any()):
            fail(f"rook {label}: a diagonal cut plane is not zero")
        moved = int((got[4][5] - st.accept_count).sum())
        if not moved:
            fail(f"rook {label}: no chain moved")
        print(f"  rook {label}: SE and SW planes zero; accepted moves "
              f"{moved} of {chains * EXACT_T} chain-steps")
    launches = cl.run_lowered_chunk_cuda.launches
    print(f"rook route: lowered_chunk launches {launches} for "
          f"{len(ROOK_EXACT_CASES)} cases")
    if launches != len(ROOK_EXACT_CASES):
        fail(f"the rook cases launched lowered_chunk {launches} times")
    return err


def lowered_fixture(port, cl, tb) -> None:
    """The kernel against the JAX package's 50-step sec11 chunk (made on
    the CPU, kept in the repository): integers bit-equal, slope and angle
    within 4 ulp, waits equal except counted log ties."""
    import pathlib

    import numpy as np
    path = pathlib.Path(__file__).resolve().parent / LOWERED_FIXTURE
    want = dict(np.load(path))
    g, bg, st, params, spec = lowered_workload(port, "sec11", FIXTURE_C,
                                               FIXTURE_SEED)
    launches = cl.run_lowered_chunk_cuda.launches
    st, rows = cl.run_chunk(bg, spec, params, st, FIXTURE_T)
    if cl.run_lowered_chunk_cuda.launches != launches + 1:
        fail("the fixture chunk did not launch the kernel")
    got = {f"row_{k}": rows[k].cpu().numpy()
           for k in ("cut_count", "b_count", "accepts", "wait", "slope",
                     "angle")}
    for k in ("key", "dist_pop", "cut_count", "cur_wait", "wait_pending",
              "cur_flip", "cur_sign", "t_yield", "move_clock",
              "accept_count", "exhausted_count", "waits_sum"):
        got[f"state_{k}"] = getattr(st, k).cpu().numpy()
    got["board_nodes"] = tb.node_view(bg, st.board)
    got["edge_cut_times"] = tb.edge_cut_times(g, st).astype(np.int16)
    if sorted(got) != sorted(want):
        fail("the fixture's keys are not the ones compared")
    bad = got["row_wait"] != want["row_wait"]
    ties = int(bad.sum())
    if (ties > FIXTURE_WAIT_SHARE * bad.size or not
            (np.abs(got["row_wait"][bad] - want["row_wait"][bad])
             == 1.0).all()):
        fail(f"fixture: waits differ beyond log ties ({ties})")
    for k in ("slope", "angle"):
        gv, wv = got[f"row_{k}"], want[f"row_{k}"]
        nan = np.isnan(wv)
        ulps = np.abs(gv[~nan].view(np.int32).astype(np.int64)
                      - wv[~nan].view(np.int32).astype(np.int64))
        if (not np.array_equal(np.isnan(gv), nan)
                or not ((gv[~nan] == wv[~nan]) | (ulps <= 4)).all()):
            fail(f"fixture: {k} differs by more than 4 ulp")
    chain_tied = bad.any(axis=0)
    for k, wv in want.items():
        if k in ("row_wait", "row_slope", "row_angle"):
            continue
        gv = np.asarray(got[k]).astype(wv.dtype)
        if k in ("state_cur_wait", "state_waits_sum"):
            gv, wv = gv[~chain_tied], wv[~chain_tied]
        if not np.array_equal(gv, wv):
            fail(f"fixture: {k} differs from the JAX package's")
    print(f"fixture (the JAX package's sec11 chunk, C={FIXTURE_C}, "
          f"T={FIXTURE_T}): equal; wait rows off by a log tie {ties}")


def lowered_plain_run(cl, bg, spec, params, state, n_steps: int):
    """The runner's chunk loop over the kernel's plain version on the
    card: (final state, mean recorded cut count)."""
    static = cl.make_static_inputs(bg, spec, params)
    cuts, done = [], 0
    while done < n_steps - 1:
        this = min(CHUNK, n_steps - 1 - done)
        args = (bg, static, spec, this, state.board,
                *cl.pack_state(state, params))
        outs = cl.lowered_chunk_reference(*args)
        state = cl.unpack_state(state, outs, this)
        cuts.append(outs[7].double().mean().item())
        done += this
    return state, sum(cuts) / len(cuts)


def lowered_candidates(tb, bg, spec, board, dist_pop, scal, outs, unit):
    """Sum over a chunk's steps and chains of the candidate cells
    (boundary & population gate) whose contiguity the kernel checks,
    replayed from the chunk's flip log (``outs`` of a lowered chunk from
    ``board``); the replay must give the kernel's boundary counts and its
    final board."""
    import dataclasses

    import torch
    t_len, c = outs[8].shape
    b = board.clone()
    dp = dist_pop.T.to(torch.int32).clone()
    gate_only = dataclasses.replace(spec, contiguity="none")
    ar = torch.arange(c, device=b.device)
    acc = torch.cat([outs[10][1:], outs[4][5][None]])
    flip = torch.cat([outs[5][1:], outs[4][1][None]]).long()
    before = outs[10][0]
    total = torch.zeros((), dtype=torch.int64, device=b.device)
    for t in range(t_len):
        planes = tb.planes_stencil(bg, gate_only, scal[2], scal[3], b, dp)
        if not torch.equal(planes["b_count"], outs[8][t]):
            fail(f"candidate replay: boundary counts differ at step {t}")
        total += planes["valid"].sum()
        moved = acc[t] != before
        before = acc[t]
        d_from = b[ar, flip[t]]
        b[ar, flip[t]] = torch.where(moved, 1 - d_from, d_from)
        step = torch.where(moved & (d_from == 0), unit, 0) - torch.where(
            moved & (d_from == 1), unit, 0)
        dp = torch.stack([dp[:, 0] - step, dp[:, 1] + step], dim=1)
    if not torch.equal(b, outs[0]):
        fail("candidate replay: final board differs from the kernel's")
    return int(total)


def graph_connected(graph, nodes, k: int = 2) -> bool:
    """Host BFS over the graph's edges: each of the k districts of a
    node-order assignment is one connected, nonempty set."""
    nbrs = [[] for _ in range(graph.n_nodes)]
    for a, b in graph.edges.tolist():
        nbrs[a].append(b)
        nbrs[b].append(a)
    for d in range(k):
        cells = [i for i in range(graph.n_nodes) if nodes[i] == d]
        if not cells:
            return False
        seen = {cells[0]}
        todo = deque([cells[0]])
        while todo:
            for j in nbrs[todo.popleft()]:
                if j not in seen and nodes[j] == d:
                    seen.add(j)
                    todo.append(j)
        if len(seen) != len(cells):
            return False
    return True


def lowered_bound(tb, cl, bg, spec, static, board, ins, outs,
                  label: str):
    """The least time of one lowered chunk from ``board`` with the packed
    per-chain inputs ``ins`` (``pack_state``'s) that gave ``outs``: the
    larger of its bytes over the memory rate and its operations (the
    smaller of the candidate and resident forms, counted on this chunk's
    data) over the peak rate. Prints both forms; returns (ms, bound_by)."""
    chains, n = board.shape
    t_len = outs[8].shape[0]
    nw = -(-n // 32)
    moved = int((outs[4][5] - ins[3][5]).sum())
    n_cand = 0
    if spec.contiguity == "patch":
        n_cand = lowered_candidates(tb, bg, spec, board, ins[1], ins[2],
                                    outs, static.unit_pop)
    ops_cand = (chains * t_len * (K_LWORD * nw + K_LTAIL + 6 * K_BLOCK)
                + (K_BLOCK + K_WAIT) * moved + K_CAND * n_cand)
    ops_res = (chains * t_len * (K_RWORD * nw + K_LTAIL + 6 * K_BLOCK)
               + (K_BLOCK + K_WAIT + K_MOVE) * moved)
    ops = min(ops_cand, ops_res)
    nbytes = (2 * chains * n                   # board in, out (int8)
              + 4 * chains * 2 * (2 + 2 + 8)    # keys, dist_pop, ints
              + 4 * chains * (6 + 2)            # scalars in, out
              + 4 * 8 * t_len * chains          # eight (T, C) rows
              + 16 * chains * n                 # four cut planes out
              + 4 * (13 * nw + n + 4 * n))      # static planes, classes
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    print(f"lowered_chunk {label} bound (C={chains}, T={t_len}): candidate "
          f"form {ops_cand:.4e} operations -> "
          f"{1e3 * ops_cand / PEAK_OPS_PER_S:.4e} ms; resident form "
          f"{ops_res:.4e} operations -> "
          f"{1e3 * ops_res / PEAK_OPS_PER_S:.4e} ms (accepted moves "
          f"{moved}, candidate cells {n_cand}); the smaller, the "
          f"{'resident' if ops_res <= ops_cand else 'candidate'} form, "
          f"{t_ops:.4e} ms; {nbytes:.4e} bytes -> {t_bytes:.4e} ms")
    return max(t_bytes, t_ops), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def lowered_main_path(port, cl, tb, which: str, baseline=None) -> dict:
    """One graph's lowered main path with its checks and timings (and,
    given ``baseline``, an earlier kernel's library, that kernel timed
    beside the current one); returns the numbers of the kernel row."""
    import dataclasses

    import torch
    g, bg, st, params, spec = lowered_workload(port, which, CHAINS, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cl.run_lowered_chunk_cuda.launches = 0
    with count_calls((cl, tb), "apply_flip_log") as flip_calls:
        t_w = time.perf_counter()
        warm = port.run_board(bg, spec, params, st, n_steps=WARMUP,
                              chunk=CHUNK, device=DEVICE)
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t_w
        state = warm.state.replace(
            accept_count=torch.zeros_like(warm.state.accept_count),
            tries_sum=torch.zeros_like(warm.state.tries_sum),
            exhausted_count=torch.zeros_like(warm.state.exhausted_count))
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        res = port.run_board(bg, spec, params, state, n_steps=STEPS,
                             record_history=False, chunk=CHUNK,
                             device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
    launches = cl.run_lowered_chunk_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-(WARMUP - 1) // CHUNK) + -(-(STEPS - 1) // CHUNK)
    fps = CHAINS * (STEPS - 1) / wall
    print(f"lowered main path {which}: {CHAINS} chains x {STEPS} steps in "
          f"{wall:.3f} s, {fps:.6e} flips/s (warmup {WARMUP} steps "
          f"{warm_wall:.3f} s with history); peak memory "
          f"{peak / 2 ** 20:.1f} MiB; lowered_chunk launches {launches} for "
          f"{chunks} chunks; apply_flip_log calls {len(flip_calls)} (one "
          f"a chunk and one in each run's final record)")
    if launches != chunks:
        fail(f"lowered_chunk launched {launches} times for {chunks} chunks")
    if len(flip_calls) != chunks + 2:    # and each run's final record
        fail(f"apply_flip_log ran {len(flip_calls)} times for {chunks} "
             "chunks and 2 final records")

    # result checks
    fs = res.state
    if not torch.equal(fs.cut_count, tb.recount_cuts(bg, fs.board)):
        fail(f"{which}: cut_count disagrees with a recount from the board")
    pop0 = ((fs.board == 0) * bg.pop).sum(dim=1)
    if not torch.equal(fs.dist_pop[:, 0].to(torch.int64), pop0):
        fail(f"{which}: dist_pop disagrees with a recount from the board")
    if not bool((fs.t_yield == WARMUP + STEPS).all()):
        fail(f"{which}: t_yield != {WARMUP + STEPS}")
    if not bool((fs.board[:, ~bg.node_mask] == -1).all()):
        fail(f"{which}: a hole left district -1")
    hist_sum = warm.history["wait"].astype("float64").sum(axis=1)
    if not (abs(warm.waits_total - hist_sum)
            <= 1e-4 * abs(hist_sum).clip(min=1.0)).all():
        fail(f"{which}: waits_total disagrees with the history's wait sum")
    nodes = tb.node_view(bg, fs.board[:16])
    if not all(graph_connected(g, row) for row in nodes):
        fail(f"{which}: a sampled chain has a disconnected district")
    rate = fs.accept_count.double().mean().item() / (STEPS - 1)
    k_rate = (warm.state.accept_count.double().mean().item()
              / (WARMUP - 1))
    k_cut = float(warm.history["cut_count"][:, :-1].mean())
    _, p_bg, p_st, p_par, _ = lowered_workload(port, which, PLAIN_CHAINS, 0)
    p_state, p_cut = lowered_plain_run(cl, p_bg, spec, p_par, p_st, WARMUP)
    p_rate = p_state.accept_count.double().mean().item() / (WARMUP - 1)
    print(f"{which}: timed accept rate {rate:.6f}; first {WARMUP} steps: "
          f"kernel (C={CHAINS}) accept {k_rate:.6f} mean cut {k_cut:.4f}, "
          f"plain (C={PLAIN_CHAINS}) accept {p_rate:.6f} mean cut "
          f"{p_cut:.4f}")
    if (abs(k_rate - p_rate) > ACCEPT_AGREE
            or abs(k_cut - p_cut) > CUT_AGREE * p_cut):
        fail(f"{which}: kernel and plain version disagree in distribution")
    # the same seed gives the plain run's chains the kernel's first keys
    if not (torch.equal(p_state.accept_count,
                        warm.state.accept_count[:PLAIN_CHAINS])
            and torch.equal(p_state.board, warm.state.board[:PLAIN_CHAINS])):
        fail(f"{which}: the plain run's chains differ from the kernel's")

    # exactness and timings at the main path's shape
    static = cl.make_static_inputs(bg, spec, params)
    dp_scal_ints = cl.pack_state(fs, params)
    args = (bg, static, spec, CHUNK, fs.board, *dp_scal_ints)
    outs = cl.run_lowered_chunk_cuda(*args)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    want = cl.lowered_chunk_reference(*args)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    err = compare_lowered(cl, outs, want, f"lowered {which} main-path shape")
    del want
    reps = 3
    ms = event_ms(lambda: cl.run_lowered_chunk_cuda(*args), reps)
    t_a = time.perf_counter()
    tb.apply_flip_log(fs.part_sum, fs.last_flipped, fs.num_flips, outs[5],
                      outs[6], fs.t_yield)
    torch.cuda.synchronize()
    flip_log_ms = 1e3 * (time.perf_counter() - t_a)
    print(f"lowered_chunk {which}: {ms:.3f} ms per {CHUNK}-step chunk (CUDA "
          f"events, mean of {reps}); plain version {plain_ms:.3f} ms; "
          f"apply_flip_log {flip_log_ms:.3f} ms wall")
    print(f"{which} " + flip_log_bound(fs, outs[5], outs[6]))
    # what the patch check and the interface cost: the same chunk with
    # each switched off. Without the interface is the bench's spec, so
    # that chunk is held against the plain version too
    parts = []
    bench_args, bench_outs = args, outs
    for label, kw in (("contiguity none", {"contiguity": "none"}),
                      ("no interface", {"record_interface": False})):
        vspec = dataclasses.replace(spec, **kw)
        if vspec == spec:
            continue
        vargs = (bg, cl.make_static_inputs(bg, vspec, params), vspec,
                 *args[3:])
        before = cl.run_lowered_chunk_cuda.launches
        vouts = cl.run_lowered_chunk_cuda(*vargs)
        torch.cuda.synchronize()
        if cl.run_lowered_chunk_cuda.launches != before + 1:
            fail(f"lowered {which} {label}: the wrapper did not count one "
                 "launch")
        if label == "no interface":
            err = max(err, compare_lowered(
                cl, vouts, cl.lowered_chunk_reference(*vargs),
                f"lowered {which} {label} main-path shape (1 launch)"))
            bench_args, bench_outs = vargs, vouts
        v_ms = event_ms(lambda: cl.run_lowered_chunk_cuda(*vargs), reps)
        parts.append(f"{label} {v_ms:.3f} ms")
    print(f"lowered_chunk {which} at the same state: " + "; ".join(parts))

    bound_ms, bound_by = lowered_bound(tb, cl, bg, spec, static, fs.board,
                                       dp_scal_ints, outs, which)
    wide = doubled_chunk(tb, cl, which, bench_args, bench_outs)
    if baseline is not None:
        baseline_lowered_rounds(cl, baseline, args, which)
    print(f"profile of {2 * CHUNK + 1} lowered {which} steps: " + idle_share(
        lambda: port.run_board(bg, spec, params, fs, n_steps=2 * CHUNK + 1,
                               record_history=False, chunk=CHUNK,
                               device=DEVICE)))
    print(f"SM clock, power draw under lowered_chunk {which}: "
          + clocks_under_load(lambda: cl.run_lowered_chunk_cuda(*args), 100))
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "flips_per_s": fps, "apply_flip_log_ms": flip_log_ms,
            "peak_mib": peak / 2 ** 20, **wide}


def same_outputs(got, want) -> bool:
    """Bit-equal tensors, NaN where NaN."""
    import torch
    if got.dtype.is_floating_point:
        return bool(((got == want) | (torch.isnan(got) & torch.isnan(want)))
                    .all())
    return torch.equal(got, want)


def doubled_chunk(tb, cl, which: str, args, outs) -> dict:
    """One chunk at the bench's default 2 * CHAINS chains (a second wave
    of blocks), the main path's state twice over at the bench's spec:
    each half of every output must equal ``outs``, that state's checked
    outputs at CHAINS, bit for bit; then the kernel's CUDA event time and
    its bound."""
    import torch
    bg, static, spec, t_len, board, *ins = args
    c = board.shape[0]
    board2 = torch.cat([board, board])
    ins2 = tuple(torch.cat([x, x], dim=1).contiguous() for x in ins)
    args2 = (bg, static, spec, t_len, board2, *ins2)
    outs2 = cl.run_lowered_chunk_cuda(*args2)
    torch.cuda.synchronize()
    for name, got, want in zip(cl.OUT_NAMES, outs2, outs):
        dims = [d for d in range(got.dim()) if got.shape[d] != want.shape[d]]
        if len(dims) != 1 or got.shape[dims[0]] != 2 * c:
            fail(f"{which} C={2 * c}: {name} has shape {tuple(got.shape)} "
                 f"against {tuple(want.shape)}")
        if not all(same_outputs(h, want) for h in got.split(c, dim=dims[0])):
            fail(f"{which} C={2 * c}: a half of {name} differs from the "
                 f"C={c} outputs")
    reps = 3
    ms = event_ms(lambda: cl.run_lowered_chunk_cuda(*args2), reps)
    print(f"lowered_chunk {which} at the bench's spec and C={2 * c}: both "
          f"halves equal the C={c} outputs; {ms:.3f} ms per {t_len}-step "
          f"chunk (CUDA events, mean of {reps})")
    bound_ms, bound_by = lowered_bound(tb, cl, bg, spec, static, board2,
                                       ins2, outs2, f"{which} C={2 * c}")
    return {f"ms_c{2 * c}": ms, f"bound_ms_c{2 * c}": bound_ms,
            f"bound_by_c{2 * c}": bound_by}


# ---------------------------------------------------------------------------
# The experiment driver: the paper's configs end to end through the CLI and
# run_config (every chunk in lowered_chunk), resume, the JAX fixtures
# ---------------------------------------------------------------------------

def experiment_config(ex, family: str, tag: str, **kw):
    """The config of ``family``'s sweep whose tag is ``tag``."""
    cfgs = [c for c in ex.SWEEPS[family](**kw) if c.tag == tag]
    if len(cfgs) != 1:
        fail(f"no single {family} config has tag {tag}")
    return cfgs[0]


def expected_chunks(runner, cfg) -> int:
    """The chunks ``run_board_segment`` runs for ``cfg``'s segments at its
    default chunk length."""
    total = cfg.total_steps - 1
    every = cfg.checkpoint_every or total
    chunks, done = 0, 0
    while done < total:
        n = min(every, total - done)
        chunks += -(-n // runner.pick_chunk(n + 1, 512))
        done += n
    return chunks


def experiment_cli(root, out: str) -> None:
    """The CLI as a user calls it, twice: the first call runs one
    Frankengraph config at the paper's shape and leaves its 13 artifacts,
    the second skips it and leaves every file as it was."""
    import os
    cmd = [sys.executable, "-m", "flipcomplexityempirical_tpu_torch."
           "experiments", "--family", "frank", "--only", EXP_CLI_TAG,
           "--out", out]
    walls, runs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        runs.append(subprocess.run(cmd, cwd=root, capture_output=True,
                                   text=True, timeout=900))
        walls.append(time.perf_counter() - t0)
        if runs[-1].returncode != 0:
            fail(f"the experiment CLI exited {runs[-1].returncode}:\n"
                 f"{runs[-1].stdout}{runs[-1].stderr}")
        if len(runs) == 1:
            names = sorted(os.listdir(out))
            mtimes = {n: os.stat(os.path.join(out, n)).st_mtime_ns
                      for n in names}
    first, second = (r.stdout.strip() for r in runs)
    if len(names) != 13 or not first.startswith(f"[done] frank "
                                                f"{EXP_CLI_TAG}"):
        fail(f"the CLI's first call left {len(names)} files: {first}")
    if not second.startswith(f"[skip] frank {EXP_CLI_TAG}"):
        fail(f"the CLI's second call did not skip: {second}")
    if {n: os.stat(os.path.join(out, n)).st_mtime_ns
            for n in sorted(os.listdir(out))} != mtimes:
        fail("the CLI's second call changed the artifacts")
    print(f"experiment CLI --family frank --only {EXP_CLI_TAG} "
          f"({EXP_STEPS} steps, {EXP_CHAINS} chains): {first!r} in "
          f"{walls[0]:.3f} s wall with 13 artifacts; second call "
          f"{second!r} in {walls[1]:.3f} s, every mtime unchanged")


def check_run(ex, drv, tb, cfg, data, out: str) -> None:
    """What a run must hold on every chain: cut_count against a recount
    over the graph's edges, both districts connected, |part_sum| <= T
    after the reference's finalisation, wait.txt from chain 0's waits,
    and the 13 artifacts."""
    import os
    from types import SimpleNamespace

    import numpy as np
    g, _, _ = drv.build_graph_and_plan(cfg)
    bg = tb.make_board_graph(g, device="cpu")
    a = np.asarray(data["assignments"]).astype(np.int64)
    recount = (a[:, g.edges[:, 0]] != a[:, g.edges[:, 1]]).sum(axis=1)
    if not np.array_equal(recount, data["state"]["cut_count"]):
        fail(f"{cfg.tag}: cut_count disagrees with a recount")
    if not all(graph_connected(g, row) for row in a):
        fail(f"{cfg.tag}: a chain has a disconnected district")
    nodes = {k: tb.node_view(bg, data["state"][k])
             for k in ("part_sum", "last_flipped", "num_flips")}
    for c in range(cfg.n_chains):
        ps, _ = drv.finalize_host(
            SimpleNamespace(**{k: v[c] for k, v in nodes.items()}),
            drv._labels_for(cfg), cfg.total_steps, assignment=a[c])
        if np.abs(ps).max() > cfg.total_steps:
            fail(f"{cfg.tag}: chain {c} has |part_sum| > T")
    with open(os.path.join(out, cfg.tag + "wait.txt")) as f:
        wait = f.read()
    if wait != str(int(round(data["waits_all"][0]))):
        fail(f"{cfg.tag}: wait.txt {wait} is not chain 0's wait total")
    if not ex.is_done(cfg, out):
        fail(f"{cfg.tag}: the 13 artifacts are not all there")


def experiment_runs(ex, drv, runner, cl, tb, out: str) -> dict:
    """run_config for the two paper configs at the paper's shape, with
    the kernel's launches counted against the chunks run."""
    import torch
    results = {}
    for family, tag in EXP_RUNS:
        cfg = experiment_config(ex, family, tag, total_steps=EXP_STEPS,
                                n_chains=EXP_CHAINS)
        torch.cuda.synchronize()
        cl.run_lowered_chunk_cuda.launches = 0
        with count_calls((cl,), "run_chunk") as chunk_calls, \
                count_calls((cl, tb), "apply_flip_log") as flip_calls:
            t0 = time.perf_counter()
            data = ex.run_config(cfg, out, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = cl.run_lowered_chunk_cuda.launches
        chunks = len(chunk_calls)
        run_s, render_s = data["seconds"], data["render_seconds"]
        fps = cfg.n_chains * (cfg.total_steps - 1) / run_s
        print(f"experiment {family} {tag} ({cfg.n_chains} chains x "
              f"{cfg.total_steps} steps): {wall:.3f} s in all, run "
              f"{run_s:.3f} s, render {render_s:.3f} s (share "
              f"{render_s / wall:.4f}), set-up and scores "
              f"{wall - run_s - render_s:.3f} s; {fps:.6e} flips/s; "
              f"lowered_chunk launches {launches} for {chunks} chunks; "
              f"apply_flip_log calls {len(flip_calls)} (one a chunk and "
              "one in the final record)")
        if launches != chunks or chunks != expected_chunks(runner, cfg):
            fail(f"{tag}: lowered_chunk launched {launches} times for "
                 f"{chunks} chunks ({expected_chunks(runner, cfg)} "
                 "expected)")
        if len(flip_calls) != chunks + 1:
            fail(f"{tag}: apply_flip_log ran {len(flip_calls)} times for "
                 f"{chunks} chunks and 1 final record")
        check_run(ex, drv, tb, cfg, data, out)
        HISTORY_ARTIFACTS[tag] = artifact_digests(ex, cfg, out)
        print(f"  {tag}: all {cfg.n_chains} chains: cut_count equal to a "
              "recount, both districts connected, |part_sum| <= T; "
              f"wait.txt {int(round(data['waits_all'][0]))}; 13 artifacts")
        results[tag] = dict(cfg=cfg, data=data, launches=launches,
                            chunks=chunks, flip_calls=len(flip_calls),
                            wall_s=wall, run_s=run_s,
                            render_s=render_s, flips_per_s=fps)
    return results


def same_run(a: dict, b: dict, label: str) -> None:
    """Two runs' data equal in every history key and state field."""
    import numpy as np
    for part in ("history", "state"):
        if sorted(a[part]) != sorted(b[part]):
            fail(f"{label}: {part} keys differ")
        for k in a[part]:
            x, y = np.asarray(a[part][k]), np.asarray(b[part][k])
            if x.dtype != y.dtype or not np.array_equal(
                    x, y, equal_nan=x.dtype.kind == "f"):
                fail(f"{label}: {part} {k} differs")
    if not np.array_equal(a["waits_all"], b["waits_all"]):
        fail(f"{label}: the wait totals differ")


def experiment_resume(ex, drv, clean: dict, out: str, ck: str) -> None:
    """The sec11 config in segments of EXP_CKPT_EVERY, stopped after two
    segments and resumed through run_config, against the uninterrupted
    run."""
    import dataclasses
    cfg = dataclasses.replace(clean["cfg"], checkpoint_every=EXP_CKPT_EVERY)
    g, plan, _ = drv.build_graph_and_plan(cfg)
    t0 = time.perf_counter()
    try:
        drv._run_torch(cfg, g, plan, checkpoint_dir=ck,
                       _stop_after_segments=2, device=DEVICE)
        fail("the segmented run did not stop")
    except drv._SegmentStop as stop:
        done = stop.done
    resumed = ex.run_config(cfg, out, checkpoint_dir=ck, device=DEVICE)
    same_run(clean["data"], resumed, "resumed run")
    print(f"experiment resume {cfg.tag}: stopped after 2 segments of "
          f"{EXP_CKPT_EVERY} ({done} steps), resumed through run_config "
          f"in {time.perf_counter() - t0:.3f} s: every history key and "
          "state field equal to the uninterrupted run")


def experiment_exactness(ex, drv, runner, cl, tb, runs=EXP_RUNS) -> dict:
    """The kernel against its plain version at the experiment path's own
    shape: each config's chains (``runs``, EXP_RUNS by default) from
    ``_init_run`` on the card and again after one EXP_CKPT_EVERY-step
    segment, one chunk of ``pick_chunk(EXP_STEPS, 512)`` steps, with the
    launch count read around the kernel's call; then at the later state
    the kernel timed with CUDA events beside the plain version and its
    bound."""
    import torch
    t_len = runner.pick_chunk(EXP_STEPS, 512)
    rows = {}
    for family, tag in runs:
        cfg = experiment_config(ex, family, tag,
                                total_steps=EXP_STEPS, n_chains=EXP_CHAINS)
        g, plan, _ = drv.build_graph_and_plan(cfg)
        spec = drv.spec_for(cfg)
        use_board, (bg, st, params) = drv._init_run(cfg, g, plan, spec,
                                                    DEVICE)
        if not use_board:
            fail(f"{tag}: not on the lowered kernel's path")
        static = cl.make_static_inputs(bg, spec, params)
        mid = drv.run_board_segment(bg, spec, params, st, EXP_CKPT_EVERY,
                                    device=DEVICE).state
        err = 0.0
        for when, state in (("start", st),
                            (f"after {EXP_CKPT_EVERY} steps", mid)):
            ins = cl.pack_state(state, params)
            args = (bg, static, spec, t_len, state.board, *ins)
            torch.cuda.synchronize()
            cl.run_lowered_chunk_cuda.launches = 0
            got = cl.run_lowered_chunk_cuda(*args)
            torch.cuda.synchronize()
            if cl.run_lowered_chunk_cuda.launches != 1:
                fail(f"{tag}: the kernel's wrapper counted "
                     f"{cl.run_lowered_chunk_cuda.launches} launches for "
                     "one call")
            want = cl.lowered_chunk_reference(*args)
            torch.cuda.synchronize()
            err = max(err, compare_lowered(
                cl, got, want, f"lowered experiment {family} {tag} {when} "
                f"C={cfg.n_chains} T={t_len}"))
        reps = 20
        ms = event_ms(lambda: cl.run_lowered_chunk_cuda(*args), reps)
        plain_ms = event_ms(lambda: cl.lowered_chunk_reference(*args), 1)
        print(f"lowered_chunk experiment {family} {tag}: {ms:.4f} ms per "
              f"{t_len}-step chunk at C={cfg.n_chains} (CUDA events, mean "
              f"of {reps}); plain version {plain_ms:.3f} ms")
        bound_ms, bound_by = lowered_bound(
            tb, cl, bg, spec, static, state.board, ins, got,
            f"experiment {tag}")
        rows[tag] = {"chains": cfg.n_chains, "chunk": t_len, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err}
    return rows


def experiment_fixture(ex, root, out: str, ck: str) -> None:
    """The Frankengraph fixture config on the card against the JAX
    package's run_config, then the JAX package's checkpoint after one
    segment resumed on the card to the same end, both under the CPU
    tests' tolerance (``tests/_parity.py``, numpy only)."""
    import os
    import shutil

    import numpy as np
    sys.path.insert(0, os.path.join(root, "tests"))
    from _parity import assert_experiment_matches, experiment_arrays
    want = dict(np.load(os.path.join(root, EXP_FIXTURE)))
    for label, kw, ckpt in (("fixture", {}, None),
                            ("fixture checkpoint resumed",
                             {"checkpoint_every": EXP_FIXTURE_CKPT_EVERY},
                             ck)):
        cfg = ex.ExperimentConfig(**EXP_FIXTURE_CFG, **kw)
        if ckpt is not None:
            shutil.copytree(os.path.join(root, EXP_FIXTURE_CKPT), ckpt)
        sub = os.path.join(out, label.replace(" ", "_"))
        data = ex.run_config(cfg, sub, checkpoint_dir=ckpt, device=DEVICE)
        with open(os.path.join(sub, cfg.tag + "wait.txt")) as f:
            wait_txt = f.read()
        try:
            ties = assert_experiment_matches(
                experiment_arrays(data, wait_txt), want)
        except AssertionError as exc:
            fail(f"{label}: differs from the JAX package's run: {exc!r}")
        print(f"experiment {label} (the JAX package's frank {cfg.tag}, "
              f"{cfg.n_chains} chains x {cfg.total_steps} steps): equal; "
              f"wait rows off by a log tie {ties}")


def experiment_split(drv, cl, tb, cfg) -> dict:
    """Where a config's run time goes: under ``torch.profiler`` the
    device's idle share, then a second run with every lowered_chunk
    launch (``_launch``) and apply_flip_log call synchronised and timed
    on the host's clock (which slows the run a little; the rest of the
    run's wall is the host's per-chunk work)."""
    import torch
    g, plan, _ = drv.build_graph_and_plan(cfg)
    setup = drv._init_run(cfg, g, plan, drv.spec_for(cfg), DEVICE)
    print(f"profile of experiment {cfg.family} {cfg.tag} "
          f"({cfg.n_chains} chains x {cfg.total_steps} steps, set-up "
          "excluded): " + idle_share(
              lambda: drv._run_torch(cfg, g, plan, device=DEVICE,
                                     run=setup)))
    spent = {"kernel": [], "flip": []}

    def timed(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[key].append(time.perf_counter() - t0)
            return out
        return run

    kern, flip_cl, flip_tb = cl._launch, cl.apply_flip_log, tb.apply_flip_log
    cl._launch = timed(kern, "kernel")
    cl.apply_flip_log = timed(flip_cl, "flip")
    tb.apply_flip_log = timed(flip_tb, "flip")
    setup = drv._init_run(cfg, g, plan, drv.spec_for(cfg), DEVICE)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv._run_torch(cfg, g, plan, device=DEVICE, run=setup)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cl._launch = kern
        cl.apply_flip_log = flip_cl
        tb.apply_flip_log = flip_tb
    n = len(spent["kernel"])
    k_ms = 1e3 * sum(spent["kernel"]) / n
    f_ms = 1e3 * sum(spent["flip"]) / n
    rest_ms = 1e3 * wall / n - k_ms - f_ms
    print(f"experiment split {cfg.tag} (synchronised, {n} chunks, "
          f"{1e3 * wall:.3f} ms wall): lowered_chunk {k_ms:.3f} ms a chunk, "
          f"apply_flip_log {f_ms:.3f} ms a chunk ({len(spent['flip'])} "
          f"calls), the rest (host per chunk) {rest_ms:.3f} ms a chunk")
    return {"chunks": n, "kernel_ms": k_ms, "apply_flip_log_ms": f_ms,
            "host_ms": rest_ms}


def experiment_phase(cl, tb, keep: dict) -> dict:
    """Phase 7: the paper's experiment driver on the card; returns its
    numbers for the kernel row, and keeps each config's data in ``keep``
    by tag (phase 14 holds the service's tenants to them)."""
    import dataclasses
    import os
    import pathlib
    import tempfile

    from flipcomplexityempirical_tpu_torch import experiments as ex
    from flipcomplexityempirical_tpu_torch.experiments import driver as drv
    from flipcomplexityempirical_tpu_torch.sampling import runner
    root = pathlib.Path(__file__).resolve().parent
    scratch = root / "build"
    scratch.mkdir(exist_ok=True)
    shape = experiment_exactness(ex, drv, runner, cl, tb)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        experiment_cli(root, os.path.join(tmp, "cli"))
        runs = experiment_runs(ex, drv, runner, cl, tb,
                               os.path.join(tmp, "run"))
        keep.update({tag: r["data"] for tag, r in runs.items()})
        sec11 = runs[EXP_RUNS[0][1]]
        experiment_resume(ex, drv, sec11, os.path.join(tmp, "resume"),
                          os.path.join(tmp, "ck"))
        experiment_fixture(ex, root, os.path.join(tmp, "fixture"),
                           os.path.join(tmp, "fixture_ck"))
        split = experiment_split(drv, cl, tb, dataclasses.replace(
            sec11["cfg"], total_steps=EXP_PROFILE_STEPS))
    return {"launches": sum(r["launches"] for r in runs.values()),
            "chunks": sum(r["chunks"] for r in runs.values()),
            "max_abs_err": max(r["max_abs_err"] for r in shape.values()),
            "configs": {tag: {**{k: r[k] for k in (
                "wall_s", "run_s", "render_s", "flips_per_s", "launches",
                "flip_calls")}, "kernel": shape[tag]}
                for tag, r in runs.items()},
            "split_10001_steps": split}


# ---------------------------------------------------------------------------
# The bench entry point as a user runs it, and the Philox mode against the
# exact stationary distribution
# ---------------------------------------------------------------------------

def last_json(text: str) -> dict:
    """The last line of ``text`` that is a JSON object."""
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    fail(f"no JSON line in: {text[-2000:]}")


def bench_phase(root) -> dict:
    """``python -m flipcomplexityempirical_tpu_torch.bench`` in a
    subprocess, as a user calls it, for each of BENCH_RUNS: exit 0 and a
    headline under bench.py's metric name, tagged with this card, the JAX
    package's body and the port's kernel, with the kernel launched once a
    chunk of the timed runs; then ``--grid 65``, which must exit nonzero
    naming ROADMAP B2. Returns the headlines by label."""
    import torch
    card = torch.cuda.get_device_name(0)
    mod = [sys.executable, "-m", "flipcomplexityempirical_tpu_torch.bench"]
    heads = {}
    for label, extra, metric, kernel_path, kernel in BENCH_RUNS:
        t0 = time.perf_counter()
        out = subprocess.run(mod + extra, cwd=root, capture_output=True,
                             text=True, timeout=600)
        wall = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"bench {label} exited {out.returncode}:\n{out.stderr}")
        lines = out.stdout.strip().splitlines()
        head, meta = json.loads(lines[-1]), last_json(out.stderr)
        want = {"metric": metric, "unit": "flips/s", "device": card,
                "kernel_path": kernel_path, "kernel": kernel,
                "repeat_policy": "best"}
        got = {k: head.get(k) for k in want}
        if len(lines) != 1 or got != want or not head["value"] > 0:
            fail(f"bench {label}: headline {head}, expected {want}")
        chunks = meta["repeats"] * ((STEPS - 1) // CHUNK)
        if meta["launches"] != chunks:
            fail(f"bench {label}: {kernel} launched {meta['launches']} times "
                 f"for {chunks} timed chunks")
        print(f"bench {label} ({wall:.3f} s wall): {lines[-1]}")
        print(f"bench {label} meta: {json.dumps(meta)}")
        heads[label] = {**head, "chains": meta["chains"],
                        "seconds": meta["seconds"],
                        "accept_rate": meta["accept_rate"]}
        if "--ess" in extra:
            heads[label]["ess"] = ess_record(out.stderr, label)
    out = subprocess.run(mod + ["--grid", "65"], cwd=root,
                         capture_output=True, text=True, timeout=600)
    if out.returncode == 0 or "B2" not in out.stderr or out.stdout:
        fail(f"bench --grid 65 exited {out.returncode}: {out.stderr}")
    print(f"bench --grid 65: exit {out.returncode}, "
          f"{out.stderr.strip().splitlines()[-1]}")
    return heads


def stationary_phase(port, cb, cl, runner) -> dict:
    """Both rook routes against the exact stationary distribution of the
    3 x 4 grid (``tests/_torch_enumeration.py``, numpy only): C chains of
    each route run ENUM_BURN steps, then en.SAMPLES one-step calls, each
    on a fresh Philox seed (the board-chunk kernel's stream is keyed by
    seed, chain and chunk, and a call starts at chunk 0) or on the
    threefry keys the lowered kernel carries in the state; the boards
    after every call are pooled, mapped to their states (a board outside
    the set fails) and held to the stationary distribution
    (``stationary_lazy``: at base 1.0 the chain has period 2, and pooling
    successive steps weighs both phases alike): TV < 0.06 and E|cut|
    within 2 % (``test_enumeration.py``'s bar), the pool's TV below
    ``en.TV_POOL_TOL``, and every ``en.group_t`` statistic (E|cut| and
    each node's district-1 share, against their sampling noise across
    groups of chains) below ``en.T_TOL`` in size. First the board-chunk
    kernel against its plain version on this grid, and last the lowered
    kernel."""
    import os

    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import _torch_enumeration as en
    g, nbrmask = en.build_masks()
    states = en.enumerate_states(nbrmask)
    spec = port.Spec(contiguity="patch", geom_waits=False,
                     parity_metrics=False)
    plan = port.graphs.stripes_plan(g, 2)
    err = chunk_cases(cb, port, EXACT_T, en.CHAINS, en.NX, en.NY, en.EPS,
                      False, f"enumeration grid {en.NX}x{en.NY}")
    out = {"philox": {}, "threefry": {}, "board_chunk_err": err,
           "states": len(states)}
    for b, base in enumerate(ENUM_BASES):
        P, cuts = en.build_transition(states, g, base)
        pi = en.stationary_lazy(P)
        for route in ("philox", "threefry"):
            seed = 100 * b + (route == "threefry")
            bg, st, params = port.init_board(
                g, plan, n_chains=en.CHAINS, seed=seed, spec=spec,
                base=base, pop_tol=en.EPS, device=DEVICE)
            t0 = time.perf_counter()
            if route == "philox":
                st = port.run_board_cuda(
                    bg, spec, params, st, n_steps=ENUM_BURN + 1,
                    record_history=False, chunk=CHUNK, seed=seed,
                    device=DEVICE).state

                def step(st, i):
                    return port.run_board_cuda(
                        bg, spec, params, st, n_steps=2,
                        record_history=False, seed=seed + 1 + i,
                        device=DEVICE).state
            else:
                st = port.run_board(bg, spec, params, st,
                                    n_steps=ENUM_BURN + 1,
                                    record_history=False, chunk=CHUNK,
                                    device=DEVICE).state

                def step(st, i):
                    return runner.run_board_segment(
                        bg, spec, params, st, 1, record_history=False,
                        device=DEVICE).state
            boards = []
            for i in range(en.SAMPLES):
                st = step(st, i)
                boards.append(st.board)
            abits = en.board_bits(torch.cat(boards).cpu().numpy())
            chain = np.tile(np.arange(en.CHAINS), len(boards))
            try:
                tv, cut_err = en.occupancy_error(abits, states, pi, cuts)
                t = en.group_t(abits, chain, states, pi, cuts)
            except KeyError as exc:
                fail(f"{route} base {base}: a chain left the valid states "
                     f"({exc})")
            t_max = float(np.abs(t).max())
            print(f"stationary {route} base {base}: TV {tv:.6f}, E|cut| "
                  f"relative error {cut_err:.6f}, t of E|cut| {t[0]:.3f}, "
                  f"max |t| {t_max:.3f} over E|cut| and the {en.N} nodes' "
                  f"shares ({en.GROUPS} groups of chains) ({abits.size} "
                  f"boards of {len(states)} states, {en.CHAINS} chains x "
                  f"{en.SAMPLES} steps after {ENUM_BURN}; "
                  f"{time.perf_counter() - t0:.3f} s)")
            if tv >= en.TV_TOL or cut_err >= en.CUT_TOL:
                fail(f"{route} base {base}: TV {tv:.4f} or E|cut| error "
                     f"{cut_err:.4f} above test_enumeration.py's bar")
            if tv >= en.TV_POOL_TOL or not t_max < en.T_TOL:
                fail(f"{route} base {base}: TV {tv:.4f} (bar "
                     f"{en.TV_POOL_TOL}) or max |t| {t_max:.2f} (bar "
                     f"{en.T_TOL}) above the pooled check's bar")
            out[route][base] = {"tv": tv, "cut_err": cut_err,
                                "t_cut": float(t[0]), "t_max": t_max}
    # the lowered kernel against its plain version on the same grid
    _, bg, st, params, lspec = lowered_workload(
        port, "square", en.CHAINS, 1, pop_tol=en.EPS, h=en.NX, w=en.NY)
    static = cl.make_static_inputs(bg, lspec, params)
    args = (bg, static, lspec, EXACT_T, st.board, *cl.pack_state(st, params))
    got = cl.run_lowered_chunk_cuda(*args)
    want = cl.lowered_chunk_reference(*args)
    out["lowered_chunk_err"] = compare_lowered(
        cl, got, want, f"rook enumeration grid C={en.CHAINS} T={EXACT_T}")
    return out


# ---------------------------------------------------------------------------
# The general path: the hex and tri families through run_chains, the
# general-dense kernel against its plain version and the JAX fixture, the
# bench's hex race, the families at the paper's shape, and the dense chain
# against its exact stationary distribution
# ---------------------------------------------------------------------------

# (label, builder, (m, n), chains, pop_tol, base, chunk length, warm-up
# steps, spec overrides, the seed of a random population plane or None)
# of the kernel's exactness cases (phase 10)
GEN_EXACT_CASES = (
    ("hex 64x64 C=256 after a 501-step warm-up", "hex_lattice", (64, 64),
     256, POP_TOL, BASE, CHUNK, WARMUP, {}, None),
    ("hex 14x28 C=8 at the experiment path's chunk", "hex_lattice",
     (14, 28), 8, 0.1, 1 / 0.3, 2439, 0, {}, None),
    ("tri 14x28 nobacktrack", "triangular_lattice", (14, 28), 32, 0.1,
     1 / 0.3, 200, 0, {"nobacktrack": True}, None),
    ("hex 14x28 lazy_uniform", "hex_lattice", (14, 28), 32, 0.1, 1 / 0.3,
     200, 0, {"lazy_uniform": True}, None),
    ("hex 14x28 contiguity none", "hex_lattice", (14, 28), 32, 0.1,
     1 / 0.3, 200, 0, {"contiguity": "none"}, None),
    ("hex 14x28 no valid move (pop_tol 0)", "hex_lattice", (14, 28), 32,
     0.0, 1 / 0.3, 50, 0, {}, None),
    ("hex 14x28 random population 1..9 (pop_tol 0.02)", "hex_lattice",
     (14, 28), 32, 0.02, 1 / 0.3, 200, 0, {}, 5),
    ("hex 1x2 (the enumeration graph)", "hex_lattice", (1, 2), 4096, 0.5,
     1.4, 64, 0, {}, None))
GEN_FIXTURE = "tests/fixtures/torch/general_dense_hex.npz"
# the legacy body's steps timed from the main path's state (phase 11)
LEGACY_STEPS = 20
# the tri family's main path on lowered_chunk (phase 12): its config at
# the paper's shape, one chunk against the plain version
GEN_TRI_RUNS = (("tri", "tri-0B333P10"),)
ROOT = pathlib.Path(__file__).resolve().parent
# the families (phase 12): the sweeps' tags run at the paper's shape, the
# resume's segment, and the JAX package's 300-step runs and checkpoint
# (tests/test_torch_general_families.py)
GEN_EXP_RUNS = (("tri", "tri-0B333P10"), ("hex", "hex-0B333P10"))
GEN_CKPT_EVERY = 50_000
GEN_FAMILY_FIXTURES = ("tri", "hex", "hex_nobacktrack", "hex_exact")
GEN_FAMILY_SHAPE = dict(alignment=0, base=1 / 0.3, pop_tol=0.1,
                        total_steps=300, n_chains=3, lattice_m=6,
                        lattice_n=10, seed=0)
GEN_FAMILY_KW = {"tri": dict(family="tri"), "hex": dict(family="hex"),
                 "hex_nobacktrack": dict(family="hex",
                                         variant="nobacktrack"),
                 "hex_exact": dict(family="hex", contiguity="exact")}
GEN_CKPT_FIXTURE = "tests/fixtures/torch/experiment_hex_ckpt"
# the stationary check (phase 13): hex_lattice(1, 2), 10 nodes
GEN_ENUM_BASES = (0.7, 1.0, 1.4)
# bench --graph hex's timed steps and repeats here: the legacy body's leg
# of its race takes 31-47 s a 1000 steps on the card's host, so the
# bench's two repeats of 3001 steps are cut to one of 1001 (two chunks) to
# keep the script's total well under its limit
GEN_BENCH_STEPS, GEN_BENCH_REPEATS = 1001, 1
GEN_ENUM_TOL = 0.5
# Operations the general-dense function needs, counted on this run's data
# (a floor):
#   ops = C * T * (K_GSTEP + 4 * K_BLOCK) + K_GMOVE * accepted moves
# K_GSTEP, per chain-step: the selection of the m-th valid node from
# counts kept up to date (the rank and its word, ~30), the dcut of the
# node's D edges and the accept test with its log (~40), the record (~10):
# 80; four threefry blocks a step (the split and the three uniforms).
# No per-word term: a step does not have to visit the ceil(N / 32) words
# of the valid set (PR 10's kernel keeps its counts), and the parity
# record changes only at accepted moves (closed forms a run).
# K_GMOVE, per accepted move: the commit of cut, cut_deg and the boundary
# bits and count over the node's edges (~40), the wait (K_WAIT), the
# parity run and the candidate counts (~20), and the 1 + P patch checks of
# the refresh, each P member tests (3 each) and a growth over at most P
# slots (3 each): 19 * 18 * 6 = 2052 on the hex lattice.
K_GSTEP = 80


def general_inputs(port, sampling, builder, mn, chains, tol, base,
                   seed=4, pop_seed=None, **spec_kw):
    import dataclasses

    import numpy as np
    g = getattr(port.graphs, builder)(*mn)
    if pop_seed is not None:
        # a random population plane: the kernel's per-node gate
        g = dataclasses.replace(g, pop=np.random.default_rng(
            pop_seed).integers(1, 10, g.n_nodes).astype(np.int32))
    spec = port.Spec(**spec_kw)
    dg, st, params = sampling.init_batch(
        g, port.graphs.stripes_plan(g, 2), n_chains=chains, seed=seed,
        spec=spec, base=base, pop_tol=tol, device=DEVICE)
    return g, spec, dg, st, params


def compare_general(cd, got, rows, want, wrows, label: str,
                    name: str = "general_dense_chunk") -> float:
    """The kernel ``name``'s chunk against the plain version's: every
    state field and history row, through the CPU tests' rule (waits equal
    up to counted log ties). Returns the largest |difference|."""
    import numpy as np
    import _parity
    from flipcomplexityempirical_tpu_torch import convert
    g_np, w_np = convert.to_numpy(got), convert.to_numpy(want)
    try:
        ties = _parity.assert_chain_run_matches(
            g_np, {k: v.T.cpu().numpy() for k, v in rows.items()},
            np.zeros(got.n_chains), w_np,
            {k: v.T.cpu().numpy() for k, v in wrows.items()},
            np.zeros(want.n_chains))
    except AssertionError as exc:
        fail(f"{name} {label}: differs from the plain version: {exc}")
    err = max(float(np.abs(g_np[k].astype(np.float64)
                           - w_np[k].astype(np.float64)).max(initial=0))
              for k in w_np)
    err = max([err] + [float((rows[k].double() - wrows[k].double()).abs()
                             .max()) for k in wrows])
    print(f"{name} {label}: "
          + ("bit-equal to the plain version" if not ties else
             f"equal to the plain version; waits off by a log tie {ties}")
          + f" (every state field, conn planes included, and "
          f"{len(rows)} history rows)")
    return err


def general_exactness(port, cd, sampling) -> float:
    """Phase 10: the kernel against its plain version, one launch counted
    a call, and against the JAX package's general_dense run. Returns the
    largest difference and the kernel's timing at the experiment path's
    shape."""
    import numpy as np
    import torch
    import _parity
    from flipcomplexityempirical_tpu_torch import convert
    err = 0.0
    shapes = []
    for (label, builder, mn, chains, tol, base, t_len, warm, kw,
         pop_seed) in GEN_EXACT_CASES:
        g, spec, dg, st, params = general_inputs(
            port, sampling, builder, mn, chains, tol, base,
            pop_seed=pop_seed, **kw)
        if warm:
            st = sampling.run_chains(dg, spec, params, st, n_steps=warm,
                                     chunk=CHUNK, record_history=False).state
        static = cd.make_static_inputs(dg)
        if (pop_seed is not None) != (static.unit_pop == 0):
            fail(f"{label}: the kernel's population gate is not the "
                 "case's (per node on a random plane, uniform otherwise)")
        n0 = cd.run_general_dense_chunk_cuda.launches
        got, rows = cd.run_general_dense_chunk_cuda(dg, static, spec, params,
                                                    st, t_len)
        torch.cuda.synchronize()
        if cd.run_general_dense_chunk_cuda.launches != n0 + 1:
            fail(f"{label}: the wrapper did not count its launch")
        exp_path = "experiment path" in label
        timing_c = {"chains": chains, "chunk": t_len}

        def check(want, secs, got=got, rows=rows, st=st, label=label,
                  chains=chains, t_len=t_len, timing_c=timing_c):
            timing_c["plain_ms"] = 1e3 * secs
            return compare_general(
                cd, got, rows, *want,
                f"{label} C={chains} T={t_len} (exhausted "
                f"{int(got.exhausted_count.sum())}, accepted "
                f"{int(got.accept_count.sum() - st.accept_count.sum())}; "
                f"plain {secs:.3f} s, host clock)")
        # the experiment path's chunk held after phase 24 (plain_jobs)
        err = max(err, hold_plain(
            "general_dense_chunk", cd.general_dense_chunk_reference,
            (dg, spec, params, st, t_len), check, defer=exp_path))
        if "no valid move" in label and not bool(
                (got.exhausted_count == st.exhausted_count + t_len).all()):
            fail(f"{label}: a chain moved")
        run = (lambda dg=dg, static=static, spec=spec, params=params,
               got=got, t_len=t_len: cd.run_general_dense_chunk_cuda(
                   dg, static, spec, params, got, t_len))
        ms = event_ms(run, 3 if exp_path else 1)
        shapes.append((label, dg, chains, ms, t_len, run))
        if exp_path:
            timed, _ = run()
            bound_ms, bound_by, _, _ = general_bound(
                dg, spec, timed, t_len,
                int((timed.accept_count - got.accept_count).sum()))
            timing = timing_c
            timing.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"general_dense_chunk at the experiment path's shape "
                  f"(C={chains}, T={t_len}): {ms:.3f} ms per chunk (CUDA "
                  f"events, mean of 3, conn planes carried); plain version "
                  f"held after phase 24; bound {bound_ms:.4e} ms "
                  f"({bound_by})")
    # the launch shape of each case, cycles a step at the SM clock read
    # under the experiment path's load
    clocks = clocks_under_load(next(r for lb, *_, r in shapes
                                    if "experiment path" in lb), 100)
    mhz = sm_mhz(clocks)
    print(f"SM clock, power draw under the experiment path's load: {clocks}")
    for label, dg, chains, ms, t_len, _ in shapes:
        shape, line = dense_shape(cd, dg, chains, ms, t_len, mhz)
        check_table_path(shape, label)
        print(f"general_dense_chunk {label} C={chains} T={t_len}: {line}")
        if "experiment path" in label:
            timing["shape"] = shape
    fx = dict(np.load(ROOT / GEN_FIXTURE))
    g = port.graphs.hex_lattice(*fx["graph"])
    dg, st, params = _parity.general_fixture_inputs(port, convert, g, fx,
                                                    DEVICE)
    n0 = cd.run_general_dense_chunk_cuda.launches
    res = sampling.run_chains(dg, port.Spec(), params, st,
                              n_steps=int(fx["steps"]),
                              chunk=int(fx["chunk"]),
                              kernel_path="general_dense")
    try:
        ties = _parity.assert_chain_run_matches(
            convert.to_numpy(res.state), res.history, res.waits_total,
            {k[6:]: v for k, v in fx.items() if k.startswith("state_")},
            {k[5:]: v for k, v in fx.items() if k.startswith("hist_")},
            fx["waits_total"])
    except AssertionError as exc:
        fail(f"general_dense_chunk against {GEN_FIXTURE}: {exc}")
    print(f"general_dense_chunk fixture ({GEN_FIXTURE}: the JAX package's "
          f"general_dense run, hex {tuple(fx['graph'])}, "
          f"{fx['init_assignment'].shape[0]} chains, {int(fx['steps'])} "
          f"steps): equal, waits off by a log tie {ties}; launches "
          f"{cd.run_general_dense_chunk_cuda.launches - n0}")
    return err, timing


def zero_launch_counts(cb, cl, cd, probes) -> None:
    cb.run_board_chunk_cuda.launches = 0
    cl.run_lowered_chunk_cuda.launches = 0
    cd.run_general_dense_chunk_cuda.launches = 0
    probes.probe_a.launches = 0
    probes.probe_b.launches = 0


def general_bound(dg, spec, state, t_len: int, accepted: int):
    """(bound ms, by, bytes, ops) of one general-dense chunk: the state
    read and written once, the (T, C) rows written once, the graph tables
    read once; the operations of this run's data (K_G* above)."""
    c, n = state.assignment.shape
    e, d, p = dg.n_edges, dg.max_deg, dg.max_patch
    nw = (n + 31) // 32
    per_chain = (2 * n + e + 4 * nw + 12 * n + 4 * e     # int8 and int32
                 + 4 * (2 + 2 + 6 + 8))                  # scalars
    rows = 4 + int(spec.lazy_uniform)
    nbytes = (2 * c * per_chain - 4 * 4 * c + 4 * rows * t_len * c
              + 4 * (2 * n * d + 2 * n + 2 * n * p + 2 * e))
    k_move = 60 + K_WAIT + (1 + p) * p * 6
    ops = c * t_len * (K_GSTEP + 4 * K_BLOCK) + k_move * accepted
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def sm_mhz(clocks: str):
    """The SM clock in MHz of a ``clocks_under_load`` reading, or None."""
    try:
        return float(clocks.split(",")[0].split()[0])
    except (ValueError, IndexError):
        return None


def dense_shape(cd, dg, chains: int, ms: float, t_len: int, mhz) -> tuple:
    """(the kernel's launch shape at ``chains`` chains of ``dg``, its line:
    the table path, shared memory a block, chains a block, resident blocks
    an SM, and cycles a step = ms x the SM clock / T)."""
    shape = cd.launch_shape(dg, chains)
    cyc = (f"{ms * 1e3 * mhz / t_len:.1f} cycles a step at {mhz:.0f} MHz"
           if mhz else "cycles a step not measured (no SM clock read)")
    path = ("staged in shared memory" if shape["staged"]
            else "read through L1")
    line = (f"tables {path}, {shape['smem_bytes']} B of shared memory "
            f"a block, {shape['chains_per_block']} chain(s) a block"
            f"{' with a draws warp' if shape['producer'] else ''}, "
            f"{shape['blocks_per_sm']} block(s) an SM; {ms:.4f} ms, {cyc}")
    shape["cycles_per_step"] = (ms * 1e3 * mhz / t_len) if mhz else None
    return shape, line


def check_table_path(shape: dict, label: str) -> None:
    """The 64x64 hex lattice reads its tables through L1, the smaller
    lattices stage theirs (both paths are on the main paths)."""
    want = "64x64" not in label
    if shape["staged"] != want:
        fail(f"general_dense_chunk {label}: tables "
             f"{'staged' if shape['staged'] else 'read through L1'}, "
             f"expected {'staged' if want else 'read through L1'}")


def general_bench(root) -> dict:
    """``bench --graph hex --ess`` as a user runs it, cut to
    GEN_BENCH_REPEATS repeat of GEN_BENCH_STEPS timed steps: the dense
    body raced against the legacy
    one at 64 x 64, C=4096; the dense body must win and its kernel launch
    once a timed chunk; its cut_ess_per_sec record computed on the
    card."""
    import torch
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "flipcomplexityempirical_tpu_torch.bench",
                          "--graph", "hex", "--ess", "--steps",
                          str(GEN_BENCH_STEPS), "--repeats",
                          str(GEN_BENCH_REPEATS)], cwd=root,
                         capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"bench --graph hex exited {out.returncode}:\n{out.stderr}")
    lines = out.stdout.strip().splitlines()
    head, meta = json.loads(lines[-1]), last_json(out.stderr)
    want = {"metric": "flips_per_sec_per_chip_hex", "unit": "flips/s",
            "device": card, "kernel_path": "general_dense",
            "kernel": "general_dense_chunk", "repeat_policy": "best"}
    got = {k: head.get(k) for k in want}
    if len(lines) != 1 or got != want or not head["value"] > 0:
        fail(f"bench --graph hex: headline {head}, expected {want}")
    chunks = meta["repeats"] * ((GEN_BENCH_STEPS - 1) // CHUNK)
    if meta["launches"] != chunks or meta["chains"] != CHAINS:
        fail(f"bench --graph hex: {meta['launches']} launches for {chunks} "
             f"timed chunks at {meta['chains']} chains")
    print(f"bench hex ({wall:.3f} s wall; {GEN_BENCH_REPEATS} repeat of "
          f"{GEN_BENCH_STEPS} timed steps, not the bench's 2 of 3001): "
          f"{lines[-1]}")
    print(f"bench hex meta: {json.dumps(meta)}")
    return {**head, "chains": meta["chains"], "seconds": meta["seconds"],
            "seconds_by_body": meta["seconds_by_body"],
            "accept_rate": meta["accept_rate"], "launches": meta["launches"],
            "ess": ess_record(out.stderr, "hex")}


def general_main_path(port, cb, cl, cd, probes, sampling, dense,
                      chain_state) -> dict:
    """Phase 11: run_chains on hex_lattice(64, 64) at C=4096, chunk 500, a
    501-step warm-up and 3001 timed steps, the launch counts zeroed just
    before and read just after; checks, the kernel's time and bound, the
    plain version's time and output (held against the kernel's from the
    same state), the idle share, and the legacy body's ms a step."""
    import torch

    from flipcomplexityempirical_tpu_torch.kernel import step as kstep
    g, spec, dg, st, params = general_inputs(
        port, sampling, "hex_lattice", (GRID, GRID), CHAINS, POP_TOL, BASE,
        seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts(cb, cl, cd, probes)
    warm = sampling.run_chains(dg, spec, params, st, n_steps=WARMUP,
                               chunk=CHUNK)
    state = warm.state.replace(
        accept_count=torch.zeros_like(warm.state.accept_count),
        tries_sum=torch.zeros_like(warm.state.tries_sum),
        exhausted_count=torch.zeros_like(warm.state.exhausted_count))
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    res = sampling.run_chains(dg, spec, params, state, n_steps=STEPS,
                              record_history=False, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = cd.run_general_dense_chunk_cuda.launches
    others = (cb.run_board_chunk_cuda.launches
              + cl.run_lowered_chunk_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-(WARMUP - 1) // CHUNK) + -(-(STEPS - 1) // CHUNK)
    fps = CHAINS * (STEPS - 1) / wall
    print(f"general main path (hex {GRID}x{GRID}, {g.n_nodes} nodes): "
          f"{CHAINS} chains x {STEPS} steps after {WARMUP} in {wall:.3f} s, "
          f"{fps:.6e} flips/s; peak memory {peak / 2 ** 20:.1f} MiB; "
          f"general_dense_chunk launches {launches} for {chunks} chunks "
          f"(other kernels {others})")
    if launches != chunks or others:
        fail(f"general_dense_chunk launched {launches} times for {chunks} "
             f"chunks (other kernels {others})")
    fs = res.state
    cut, cut_deg, dist_pop, cut_count, b_count = chain_state.derive(
        dg, fs.assignment, 2)
    for name, a, b in (("cut", fs.cut, cut), ("cut_deg", fs.cut_deg,
                                              cut_deg),
                       ("dist_pop", fs.dist_pop, dist_pop),
                       ("cut_count", fs.cut_count, cut_count),
                       ("b_count", fs.b_count, b_count)):
        if not torch.equal(a, b.to(a.dtype)):
            fail(f"general main path: {name} disagrees with a recount")
    if not bool((fs.t_yield == WARMUP + STEPS).all()):
        fail(f"general main path: t_yield != {WARMUP + STEPS}")
    nodes = fs.assignment[:16].cpu().numpy()
    if not all(graph_connected(g, row) for row in nodes):
        fail("general main path: a chain has a disconnected district")
    hist_sum = warm.history["wait"].astype("float64").sum(axis=1)
    if not (abs(warm.waits_total - hist_sum)
            <= 1e-4 * abs(hist_sum).clip(min=1.0)).all():
        fail("general main path: waits_total disagrees with the history")
    rate = fs.accept_count.double().mean().item() / (STEPS - 1)
    print(f"general main path: accept rate {rate:.6f}, mean cut "
          f"{fs.cut_count.double().mean().item():.2f}, mean boundary "
          f"{fs.b_count.double().mean().item():.2f}; cut, cut_deg, "
          "dist_pop, cut_count and b_count equal a recount; 16 chains "
          "connected")
    # the kernel at the main path's shape: one chunk with the conn planes
    # carried (the first chunk of a run also fills them)
    static = cd.make_static_inputs(dg)
    st1, _ = cd.run_general_dense_chunk_cuda(dg, static, spec, params, fs,
                                             CHUNK)
    if not torch.equal(st1.conn_bits,
                       dense.init_conn_bits(dg, spec, st1.assignment)):
        fail("general main path: the kernel's conn planes disagree with a "
             "full recompute")
    reps = 3
    ms = event_ms(lambda: cd.run_general_dense_chunk_cuda(
        dg, static, spec, params, st1, CHUNK), reps)
    fill_ms = event_ms(lambda: cd.run_general_dense_chunk_cuda(
        dg, static, spec, params, fs, CHUNK), 1)
    out2, rows2 = cd.run_general_dense_chunk_cuda(dg, static, spec, params,
                                                  st1, CHUNK)
    accepted = int((out2.accept_count - st1.accept_count).sum())
    plain_ms, (want2, wrows2) = event_ms_once(
        lambda: cd.general_dense_chunk_reference(dg, spec, params, st1,
                                                 CHUNK))
    err = compare_general(
        cd, out2, rows2, want2, wrows2,
        f"at the main path's shape C={CHAINS} T={CHUNK}, from the main "
        f"path's final state (accepted {accepted})")
    del want2, wrows2
    bound_ms, bound_by, nbytes, ops = general_bound(dg, spec, st1, CHUNK,
                                                    accepted)
    print(f"general_dense_chunk: {ms:.3f} ms per {CHUNK}-step chunk at "
          f"C={CHAINS} (CUDA events, mean of {reps}, conn planes carried); "
          f"{fill_ms:.3f} ms for a run's first chunk (conn planes filled); "
          f"plain version {plain_ms:.3f} ms")
    print(f"general_dense_chunk bound: {nbytes:.4e} bytes -> "
          f"{1e3 * nbytes / PEAK_BYTES_PER_S:.4f} ms, {ops:.4e} operations "
          f"({accepted} accepted moves) -> {1e3 * ops / PEAK_OPS_PER_S:.4f}"
          f" ms; bound {bound_ms:.4f} ms ({bound_by})")
    print(f"profile of {2 * CHUNK + 1} general main-path steps: "
          + idle_share(lambda: sampling.run_chains(
              dg, spec, params, fs, n_steps=2 * CHUNK + 1,
              record_history=False, chunk=CHUNK)))
    clocks = clocks_under_load(lambda: cd.run_general_dense_chunk_cuda(
        dg, static, spec, params, st1, CHUNK), 20)
    print(f"SM clock, power draw under the kernel's load: {clocks}")
    label = f"at the main path's shape hex {GRID}x{GRID}"
    shape, line = dense_shape(cd, dg, CHAINS, ms, CHUNK, sm_mhz(clocks))
    check_table_path(shape, label)
    print(f"general_dense_chunk {label} C={CHAINS} T={CHUNK}: {line}")
    legacy = legacy_steps(kstep, dg, spec, params, fs)
    # the legacy body moves the dense chunk's state and rows, without the
    # conn planes; it is bound by bytes (its operations are not counted)
    c, n = fs.assignment.shape
    legacy_bytes = (general_bound(dg, spec, fs, CHUNK, 0)[2]
                    - 2 * c * 4 * ((n + 31) // 32))
    legacy["bound_ms_per_chunk"] = 1e3 * legacy_bytes / PEAK_BYTES_PER_S
    print(f"legacy body bound, a {CHUNK}-step chunk at C={c}: "
          f"{legacy['bound_ms_per_chunk']:.4f} ms ({legacy_bytes:.4e} "
          "bytes: the state read and written once, the rows written once, "
          "the tables read once)")
    return {"launches": launches, "max_abs_err": err, "ms": ms,
            "shape": shape,
            "first_chunk_ms": fill_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "flips_per_s": fps,
            "peak_mib": peak / 2 ** 20, "legacy": legacy}


def legacy_steps(kstep, dg, spec, params, state) -> dict:
    """The legacy body (torch ops, the bench race's other body) for
    LEGACY_STEPS steps from the main path's final state: ms a step on the
    host's clock."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kstep.run_steps(kstep.transition, dg, spec, params, state, LEGACY_STEPS)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / LEGACY_STEPS
    print(f"legacy body, hex {GRID}x{GRID} C={CHAINS}, {LEGACY_STEPS} steps "
          f"from the main path's state: {ms:.3f} ms a step (host clock)")
    return {"steps": LEGACY_STEPS, "ms_per_step": ms}


def general_families(port, cb, cl, cd, probes, drv_mod, out: str,
                     keep: dict) -> dict:
    """Phase 12: one tri and one hex config at the paper's shape through
    run_config (counts zeroed just before, read just after; each config's
    data kept in ``keep`` by tag for phase 14), the hex config stopped
    after one segment and resumed, and the JAX package's family runs and
    hex checkpoint held under the CPU tests' rule."""
    import os
    import shutil

    import numpy as np
    import torch
    import _parity
    ex = port.experiments
    results = {}
    for family, tag in GEN_EXP_RUNS:
        cfg = experiment_config(ex, family, tag, total_steps=EXP_STEPS,
                                n_chains=EXP_CHAINS)
        torch.cuda.synchronize()
        zero_launch_counts(cb, cl, cd, probes)
        t0 = time.perf_counter()
        data = ex.run_config(cfg, out, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dense_n = cd.run_general_dense_chunk_cuda.launches
        low_n = cl.run_lowered_chunk_cuda.launches
        run_s, render_s = data["seconds"], data["render_seconds"]
        g, _, _ = drv_mod.build_graph_and_plan(cfg)
        a = np.asarray(data["assignments"]).astype(np.int64)
        recount = (a[:, g.edges[:, 0]] != a[:, g.edges[:, 1]]).sum(axis=1)
        if not np.array_equal(recount, data["state"]["cut_count"]):
            fail(f"{tag}: cut_count disagrees with a recount")
        if not all(graph_connected(g, row) for row in a):
            fail(f"{tag}: a chain has a disconnected district")
        kinds = ex.artifacts.artifact_kinds(family)
        if not ex.is_done(cfg, out) or len(kinds) != 7:
            fail(f"{tag}: the 7 artifacts are not all there")
        with open(os.path.join(out, cfg.tag + "wait.txt")) as f:
            if f.read() != str(int(round(data["waits_all"][0]))):
                fail(f"{tag}: wait.txt is not chain 0's wait total")
        kernel, n = (("general_dense_chunk", dense_n) if family == "hex"
                     else ("lowered_chunk", low_n))
        if n == 0 or (dense_n and low_n):
            fail(f"{tag}: general_dense_chunk {dense_n}, lowered_chunk "
                 f"{low_n} launches")
        fps = cfg.n_chains * (cfg.total_steps - 1) / run_s
        print(f"family {family} {tag} ({cfg.n_chains} chains x "
              f"{cfg.total_steps} steps, {g.n_nodes} nodes): {wall:.3f} s in "
              f"all, run {run_s:.3f} s, render {render_s:.3f} s, set-up and "
              f"scores {wall - run_s - render_s:.3f} s; {fps:.6e} flips/s; "
              f"{kernel} launches {n}; cut_count equal to a recount, both "
              f"districts connected on all chains; the 7 artifacts")
        results[tag] = dict(wall_s=wall, run_s=run_s, render_s=render_s,
                            launches=n, kernel=kernel, flips_per_s=fps)
        keep[tag] = data
        HISTORY_ARTIFACTS[tag] = artifact_digests(ex, cfg, out)
    # the hex config in checkpoint segments, uninterrupted, against the
    # same config stopped after its first segment and resumed (the waits
    # drain once a chunk in f32, so the two runs share their chunking)
    cfg = experiment_config(ex, "hex", GEN_EXP_RUNS[1][1],
                            total_steps=EXP_STEPS, n_chains=EXP_CHAINS,
                            checkpoint_every=GEN_CKPT_EVERY)
    clean = ex.run_config(cfg, os.path.join(out, "clean"),
                          checkpoint_dir=os.path.join(out, "ck_clean"),
                          device=DEVICE)
    ck = os.path.join(out, "ck")
    g, plan, _ = drv_mod.build_graph_and_plan(cfg)
    try:
        drv_mod._run_torch(cfg, g, plan, checkpoint_dir=ck,
                           _stop_after_segments=1, device=DEVICE)
        fail("the segment stop did not stop")
    except drv_mod._SegmentStop:
        pass
    resumed = ex.run_config(cfg, os.path.join(out, "resumed"),
                            checkpoint_dir=ck, device=DEVICE)
    same_run(clean, resumed, "hex resume")
    print(f"family hex resume: stopped after {GEN_CKPT_EVERY} steps, "
          "resumed from its checkpoint: equal to the uninterrupted run in "
          "every history key, state field and wait total")
    # the JAX package's runs and checkpoint (300 steps, 3 chains)
    for name in GEN_FAMILY_FIXTURES:
        cfg = ex.ExperimentConfig(**GEN_FAMILY_KW[name], **GEN_FAMILY_SHAPE)
        want = dict(np.load(
            ROOT / f"tests/fixtures/torch/experiment_{name}.npz"))
        names = sorted(want.pop("artifacts").tolist())
        d = os.path.join(out, f"fx_{name}")
        data = ex.run_config(cfg, d, device=DEVICE)
        got = _parity.experiment_arrays(data, open(os.path.join(
            d, cfg.tag + "wait.txt")).read())
        try:
            ties = _parity.assert_experiment_matches(got, want)
        except AssertionError as exc:
            fail(f"family fixture {name}: {exc}")
        if sorted(os.listdir(d)) != names:
            fail(f"family fixture {name}: artifacts {os.listdir(d)}")
        print(f"family fixture {name} (the JAX package's run_config, "
              f"300 steps, 3 chains): equal, waits off by a log tie {ties};"
              f" artifact names equal")
    ck = os.path.join(out, "fx_ck")
    shutil.copytree(ROOT / GEN_CKPT_FIXTURE, ck)
    cfg = ex.ExperimentConfig(**GEN_FAMILY_KW["hex"], **GEN_FAMILY_SHAPE,
                              checkpoint_every=150)
    d = os.path.join(out, "fx_ck_out")
    data = ex.run_config(cfg, d, checkpoint_dir=ck, device=DEVICE)
    got = _parity.experiment_arrays(data, open(os.path.join(
        d, cfg.tag + "wait.txt")).read())
    want = dict(np.load(ROOT / "tests/fixtures/torch/experiment_hex.npz"))
    want.pop("artifacts")
    try:
        _parity.assert_experiment_matches(got, want)
    except AssertionError as exc:
        fail(f"the JAX hex checkpoint's resume: {exc}")
    print(f"family fixture: the JAX package's hex checkpoint "
          f"({GEN_CKPT_FIXTURE}) resumed here ends equal to its "
          "uninterrupted run")
    return results


def general_stationary(port, sampling) -> dict:
    """Phase 13: the kernel's chains on hex_lattice(1, 2) against the
    dense chain's exact stationary distribution (``tests/_torch_
    enumeration.py``'s ``build_dense_transition``, numpy): CHAINS chains
    run ENUM_BURN steps, then en.SAMPLES one-step calls whose assignments
    are pooled; phase 9's bars (TV and E|cut| error below
    test_enumeration.py's, the pool's TV below en.TV_POOL_TOL, every
    group_t statistic below en.T_TOL)."""
    import os

    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import _torch_enumeration as en
    from flipcomplexityempirical_tpu_torch.sampling.runner import pop_bounds
    g = port.graphs.hex_lattice(1, 2)
    plan = port.graphs.stripes_plan(g, 2)
    lo, hi = pop_bounds(g, 2, GEN_ENUM_TOL)
    spec = port.Spec()
    out = {}
    for b, base in enumerate(GEN_ENUM_BASES):
        states, P, cuts = en.build_dense_transition(g, plan, base, lo, hi)
        pi = en.stationary_lazy(P)
        dg, st, params = sampling.init_batch(
            g, plan, n_chains=en.CHAINS, seed=200 + b, spec=spec, base=base,
            pop_tol=GEN_ENUM_TOL, device=DEVICE)
        t0 = time.perf_counter()
        st = sampling.run_chains(dg, spec, params, st,
                                 n_steps=ENUM_BURN + 1, chunk=CHUNK,
                                 record_history=False).state
        boards = []
        for _ in range(en.SAMPLES):
            st = sampling.run_chains(dg, spec, params, st, n_steps=1,
                                     record_initial=False,
                                     record_history=False).state
            boards.append(st.assignment)
        abits = en.board_bits(torch.cat(boards).cpu().numpy())
        chain = np.tile(np.arange(en.CHAINS), len(boards))
        try:
            tv, cut_err = en.occupancy_error(abits, states, pi, cuts)
            t = en.group_t(abits, chain, states, pi, cuts, n=g.n_nodes)
        except KeyError as exc:
            fail(f"dense base {base}: a chain left the closure ({exc})")
        t_max = float(np.abs(t).max())
        print(f"stationary general_dense hex 1x2 base {base}: TV {tv:.6f}, "
              f"E|cut| relative error {cut_err:.6f}, t of E|cut| "
              f"{t[0]:.3f}, max |t| {t_max:.3f} over E|cut| and the "
              f"{g.n_nodes} nodes' shares ({abits.size} assignments of "
              f"{len(states)} states, {en.CHAINS} chains x {en.SAMPLES} "
              f"steps after {ENUM_BURN}; {time.perf_counter() - t0:.3f} s)")
        if tv >= en.TV_TOL or cut_err >= en.CUT_TOL:
            fail(f"dense base {base}: TV {tv:.4f} or E|cut| error "
                 f"{cut_err:.4f} above test_enumeration.py's bar")
        if tv >= en.TV_POOL_TOL or not t_max < en.T_TOL:
            fail(f"dense base {base}: TV {tv:.4f} (bar {en.TV_POOL_TOL}) "
                 f"or max |t| {t_max:.2f} (bar {en.T_TOL})")
        out[base] = {"tv": tv, "cut_err": cut_err, "t_cut": float(t[0]),
                     "t_max": t_max, "states": len(states)}
    return out


# ---------------------------------------------------------------------------
# The sweep service (phase 14)
# ---------------------------------------------------------------------------

# the paper's four sweeps at the paper's shape (seed 0), each as one batch,
# and the tenant of each that phases 7 and 12 ran solo through run_config
SVC_SWEEPS = (("sec11", "0B263P10"), ("frank", "2B333P90"),
              ("tri", "tri-0B333P10"), ("hex", "hex-0B333P10"))
# the service CLI as a user calls it (its other defaults: seed 3)
SVC_CLI = ["--family", "frank", "--chains", str(EXP_CHAINS), "--steps",
           str(EXP_STEPS)]
# the idle share of each sweep's batch, over a run this long
SVC_PROFILE_STEPS = 10_001
# bench --service at the JAX package's defaults: frank, 4 tenants of 2
# chains, 400 steps
SVC_BENCH = ["--service", "--steps", "400"]


def service_chunks(runner, use_board: bool, steps: int) -> int:
    """The chunks one batch of ``steps`` steps runs: the board path's
    segment of steps - 1 transitions, or the general path's yields after
    the initial record."""
    if use_board:
        return -(-(steps - 1) // runner.pick_chunk(steps, 512))
    return -(-(steps - 1) // runner.pick_chunk(steps, 4096))


def same_result(a: dict, b: dict, label: str) -> None:
    """Two runs' data equal in every history key and state field (the
    dtypes too), the wait totals and every final accumulator."""
    import numpy as np
    same_run(a, b, label)
    for k in ("end_signed", "cut_times", "part_sum", "num_flips", "slopes",
              "angles", "waits_sum", "assignments"):
        if (a[k] is None) != (b[k] is None):
            fail(f"{label}: {k} is None in one run only")
        if a[k] is None:
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype != y.dtype or not np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f"):
            fail(f"{label}: {k} differs")


def service_cli(root, out: str, runner, card: str) -> dict:
    """The service CLI as a user calls it on the Frankengraph sweep: exit
    0, 24 [done] lines, one batch of 192 chains whose lowered_chunk
    launches equal its chunks (the CLI's [batch] line reads the
    wrapper's count in its process)."""
    import re
    cmd = [sys.executable, "-m", "flipcomplexityempirical_tpu_torch.service",
           *SVC_CLI, "--out", out]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=900)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"the service CLI exited {run.returncode}:\n{run.stdout[-3000:]}"
             f"{run.stderr[-3000:]}")
    lines = run.stdout.strip().splitlines()
    done = [x for x in lines if x.startswith("[done]")]
    batch = [x for x in lines if x.startswith("[batch]")]
    want = service_chunks(runner, True, EXP_STEPS)
    m = re.match(r"\[batch\] b0000 24 jobs (\d+) chains \d+ steps "
                 r"lowered_bits: prepare ([\d.]+) s, run ([\d.]+) s, "
                 r"assemble ([\d.]+) s, launches (\d+)$",
                 batch[0] if len(batch) == 1 else "")
    if len(done) != 24 or m is None or int(m[1]) != 24 * EXP_CHAINS:
        fail(f"the service CLI did not run 24 jobs as one batch of "
             f"{24 * EXP_CHAINS} chains:\n{run.stdout[-3000:]}")
    if int(m[5]) != want:
        fail(f"the service CLI's batch launched lowered_chunk {m[5]} times "
             f"for {want} chunks")
    print(f"[{card}] service CLI {' '.join(SVC_CLI)}: exit 0 in {wall:.3f} s "
          f"wall; {len(done)} [done] lines; one batch of {m[1]} chains "
          f"(prepare {m[2]} s, run {m[3]} s, assemble {m[4]} s); "
          f"lowered_chunk launches {m[5]} for {want} chunks")
    return {"wall_s": wall, "chains": int(m[1]), "prepare_s": float(m[2]),
            "run_s": float(m[3]), "assemble_s": float(m[4]),
            "launches": int(m[5]), "chunks": want}


def service_sweeps(ex, runner, cl, cd, solo: dict, out: str,
                   card: str) -> dict:
    """SweepService in-process on the four sweeps at the paper's shape:
    one batch a sweep, the counts zeroed just before and read just after,
    seconds split into prepare, run and slice/assemble, flips/s, peak
    memory, and the named tenant against phase 7's or 12's solo run;
    then the idle share of a SVC_PROFILE_STEPS-step batch of each
    sweep's configs."""
    import os
    import resource

    import torch
    from flipcomplexityempirical_tpu_torch.service import SweepService
    results = {}
    for family, tag in SVC_SWEEPS:
        cfgs = list(ex.SWEEPS[family](total_steps=EXP_STEPS,
                                      n_chains=EXP_CHAINS))
        svc = SweepService(os.path.join(out, family), device=DEVICE)
        jobs = [svc.submit(c) for c in cfgs]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()    # earlier phases' tensors
        cl.run_lowered_chunk_cuda.launches = 0
        cd.run_general_dense_chunk_cuda.launches = 0
        t0 = time.perf_counter()
        svc.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        low = cl.run_lowered_chunk_cuda.launches
        dense = cd.run_general_dense_chunk_cuda.launches
        peak = torch.cuda.max_memory_allocated() - held
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 10
        bad = [(j.tag, j.error) for j in jobs if j.status != "done"]
        if bad or svc.exit_code != 0:
            fail(f"service {family}: jobs failed: {bad[:3]}")
        if len(svc.batch_stats) != 1:
            fail(f"service {family}: {len(svc.batch_stats)} batches, not 1")
        st = svc.batch_stats[0]
        use_board = family != "hex"
        kernel, n, other = (("lowered_chunk", low, dense) if use_board
                            else ("general_dense_chunk", dense, low))
        want = service_chunks(runner, use_board, EXP_STEPS)
        if (st.chains != EXP_CHAINS * len(cfgs) or n != want or other
                or st.launches != n):
            fail(f"service {family}: {st.chains} chains, {kernel} launches "
                 f"{n} for {want} chunks, other kernel {other}")
        job = next(j for j in jobs if j.tag == tag)
        same_result(job.result, solo[tag], f"service {family} tenant {tag}")
        fps = st.chains * (EXP_STEPS - 1) / st.wall_s
        print(f"[{card}] service {family}: {len(cfgs)} configs as one batch "
              f"of {st.chains} chains x {EXP_STEPS} steps "
              f"({st.kernel_path}): {wall:.3f} s in all, prepare "
              f"{st.prepare_s:.3f} s, run {st.wall_s:.3f} s, slice/assemble "
              f"{st.assemble_s:.3f} s; {fps:.6e} flips/s; {kernel} launches "
              f"{n} for {want} chunks; peak device memory "
              f"{peak / 2 ** 20:.1f} MiB above the {held / 2 ** 20:.1f} MiB "
              f"held before the run, host max RSS so far {rss:.1f} MiB; "
              f"tenant {tag} equal to its solo run in every state field, "
              "history key and result")
        results[family] = {
            "configs": len(cfgs), "chains": st.chains, "wall_s": wall,
            "prepare_s": st.prepare_s, "run_s": st.wall_s,
            "assemble_s": st.assemble_s, "flips_per_s": fps,
            "kernel": kernel, "launches": n, "chunks": want,
            "peak_mib": peak / 2 ** 20, "host_max_rss_mib": rss}
        del svc, jobs
    for family, _ in SVC_SWEEPS:
        cfgs = list(ex.SWEEPS[family](total_steps=SVC_PROFILE_STEPS,
                                      n_chains=EXP_CHAINS))
        svc = SweepService(os.path.join(out, f"profile_{family}"),
                           device=DEVICE)
        for c in cfgs:
            svc.submit(c)
        run_batch, line = svc._run_batch, []

        def profiled(*args, run_batch=run_batch, line=line):
            box = []
            line.append(idle_share(lambda: box.append(run_batch(*args))))
            return box[0]
        svc._run_batch = profiled
        svc.run_until_idle()
        if svc.exit_code != 0 or len(line) != 1:
            fail(f"service {family}: the profiled batch did not run")
        print(f"[{card}] profile of the service's {family} batch "
              f"({len(cfgs)} configs, {EXP_CHAINS * len(cfgs)} chains x "
              f"{SVC_PROFILE_STEPS} steps, set-up excluded): {line[0]}")
        results[family]["profile"] = line[0]
    return results


def sweep_batch(ex, family: str) -> tuple:
    """(the tenants, their states, their params) of ``family``'s sweep at
    the paper's shape, prepared by ``SweepService`` and coalesced into one
    batch as the service runs it."""
    from flipcomplexityempirical_tpu_torch.service import (
        SweepService, concat_params, concat_states)
    svc = SweepService(ROOT / "build", device=DEVICE)
    prepared = [svc._prepare(svc.submit(c)) for c in ex.SWEEPS[family](
        total_steps=EXP_STEPS, n_chains=EXP_CHAINS)]
    return (prepared, concat_states([p.states for p in prepared]),
            concat_params([p.params for p in prepared]))


def service_kernels(ex, runner, tb, cl, cd, card: str) -> dict:
    """The two chunk kernels at the batched shapes, each held against its
    plain version with its launch counted and timed with CUDA events
    beside its bound: lowered_chunk at the Frankengraph sweep's batch
    (C=192, the 24 tenants' parameters, its 369-step chunk from the
    batch's start) and general_dense_chunk at the hex sweep's (C=32, its
    2439-step chunk)."""
    import torch
    rows = {}
    for family in ("frank", "hex"):
        prepared, states, params = sweep_batch(ex, family)
        spec, handle = prepared[0].spec, prepared[0].handle
        c = states.key.shape[0]
        n_lo = len(set(params.pop_lo.tolist()))
        n_base = len(set(params.log_base.tolist()))
        if family == "frank":
            t_len = runner.pick_chunk(EXP_STEPS, 512)
            static = cl.make_static_inputs(handle, spec, params)
            ins = cl.pack_state(states, params)
            args = (handle, static, spec, t_len, states.board, *ins)
            torch.cuda.synchronize()
            n0 = cl.run_lowered_chunk_cuda.launches
            got = cl.run_lowered_chunk_cuda(*args)
            torch.cuda.synchronize()
            if cl.run_lowered_chunk_cuda.launches != n0 + 1:
                fail("lowered_chunk at the batched shape: the wrapper did "
                     "not count its launch")
            t0 = time.perf_counter()
            want = cl.lowered_chunk_reference(*args)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            err = compare_lowered(cl, got, want, f"[{card}] lowered_chunk "
                                  f"at the frank sweep's batch C={c} "
                                  f"T={t_len}")
            ms = event_ms(lambda: cl.run_lowered_chunk_cuda(*args), 20)
            bound_ms, bound_by = lowered_bound(
                tb, cl, handle, spec, static, states.board, ins, got,
                "frank sweep batch")
            name = "lowered_chunk"
        else:
            t_len = runner.pick_chunk(EXP_STEPS, 4096)
            static = cd.make_static_inputs(handle)
            torch.cuda.synchronize()
            n0 = cd.run_general_dense_chunk_cuda.launches
            got, grows = cd.run_general_dense_chunk_cuda(
                handle, static, spec, params, states, t_len)
            torch.cuda.synchronize()
            if cd.run_general_dense_chunk_cuda.launches != n0 + 1:
                fail("general_dense_chunk at the batched shape: the wrapper "
                     "did not count its launch")
            row = rows["hex"] = {}

            def check(want, secs, got=got, grows=grows, c=c, t_len=t_len,
                      row=row):
                row["plain_ms"] = 1e3 * secs
                row["max_abs_err"] = compare_general(
                    cd, got, grows, *want,
                    f"[{card}] at the hex sweep's batch C={c} T={t_len} "
                    f"(plain {secs:.3f} s, host clock)")
                return row["max_abs_err"]
            # held after phase 24 (plain_jobs)
            hold_plain("general_dense_chunk", cd.general_dense_chunk_reference,
                       (handle, spec, params, states, t_len), check,
                       defer=True)
            plain_ms, err = None, 0.0
            def run():
                return cd.run_general_dense_chunk_cuda(
                    handle, static, spec, params, got, t_len)
            ms = event_ms(run, 3)
            timed, _ = run()
            bound_ms, bound_by, _, _ = general_bound(
                handle, spec, timed, t_len,
                int((timed.accept_count - got.accept_count).sum()))
            name = "general_dense_chunk"
            clocks = clocks_under_load(run, 100)
            label = "at the hex sweep's batch (hex 14x28)"
            shape, line = dense_shape(cd, handle, c, ms, t_len,
                                      sm_mhz(clocks))
            check_table_path(shape, label)
            print(f"[{card}] SM clock, power draw under the hex batch's "
                  f"load: {clocks}")
            print(f"[{card}] general_dense_chunk {label} C={c} T={t_len}: "
                  f"{line}")
        # the frank sweep's tenants differ in base and pop_tol, the hex
        # sweep's in base (its pop_tol is 0.1 throughout)
        if n_base < 2 or (family == "frank" and n_lo < 2):
            fail(f"{name} at the {family} batch: the tenants' parameters do "
                 f"not differ ({n_lo} pop_lo, {n_base} log_base values)")
        plain = (f"plain version {plain_ms:.3f} ms (host clock)"
                 if plain_ms is not None else "plain version held after "
                 "phase 23")
        print(f"[{card}] {name} at the {family} sweep's batch (C={c}, "
              f"{len(prepared)} tenants: {n_lo} pop_lo and {n_base} "
              f"log_base values, T={t_len}): {ms:.4f} ms per chunk (CUDA "
              f"events); {plain}; bound {bound_ms:.4e} ms ({bound_by})")
        rows.setdefault(family, {}).update(
            {"chains": c, "chunk": t_len, "ms": ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "launches": 1})
        if plain_ms is not None:
            rows[family].update(plain_ms=plain_ms, max_abs_err=err)
        if family == "hex":
            rows[family]["shape"] = shape
    return rows


def service_bench(root, card: str) -> dict:
    """``bench --service`` as a user runs it, in a subprocess: its meta
    line names this card, its record is the tenant-efficiency ratio of
    one coalesced batch on the lowered kernel."""
    cmd = [sys.executable, "-m", "flipcomplexityempirical_tpu_torch.bench",
           *SVC_BENCH]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        fail(f"bench --service exited {run.returncode}: {run.stderr[-3000:]}")
    rec = last_json(run.stdout)
    meta = last_json(run.stderr)
    import torch
    if (rec.get("metric") != "tenant_efficiency" or rec["tenants"] != 4
            or rec["chains_per_tenant"] != 2 or rec["family"] != "frank"
            or rec["kernel_path"] != "lowered_bits" or rec["device"] != "gpu"
            or not rec["value"] > 0 or "cpu_fallback" in rec
            or meta.get("device") != torch.cuda.get_device_name(0)):
        fail(f"bench --service: {rec} / {meta}")
    print(f"[{card}] bench {' '.join(SVC_BENCH)} ({wall:.3f} s wall): "
          f"meta {json.dumps(meta)}; record {json.dumps(rec)}")
    return {"wall_s": wall, **rec}


def service_phase(ex, runner, tb, cl, cd, solo: dict, card: str) -> dict:
    """Phase 14: the sweep service on the card."""
    import os
    import tempfile
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cli = service_cli(str(ROOT), os.path.join(tmp, "cli"), runner, card)
        sweeps = service_sweeps(ex, runner, cl, cd, solo,
                                os.path.join(tmp, "svc"), card)
    kernels = service_kernels(ex, runner, tb, cl, cd, card)
    return {"cli": cli, "sweeps": sweeps, "kernels": kernels,
            "bench": service_bench(str(ROOT), card)}


# ---------------------------------------------------------------------------
# The device analytics: the summary fold against its plain version, and
# the paper's configs in summary mode against their history-mode runs
# ---------------------------------------------------------------------------

# the configs of phases 7 and 12, run again in summary mode (phase 15)
SUMMARY_RUNS = (("sec11", "0B263P10"), ("frank", "2B333P90"),
                ("hex", "hex-0B333P10"))
# sha256 of each history-mode run's artifacts by file name, filled in by
# phases 7 and 12
HISTORY_ARTIFACTS: dict = {}


def artifact_digests(ex, cfg, out: str) -> dict:
    """sha256 of each of ``cfg``'s artifacts in ``out``, by file name."""
    import hashlib
    import os
    return {cfg.tag + k: hashlib.sha256(pathlib.Path(
        os.path.join(out, cfg.tag + k)).read_bytes()).hexdigest()
        for k in ex.artifacts.artifact_kinds(cfg.family)}


def fold_bound(acc, rows: dict) -> tuple:
    """(bound ms, bytes) of one fold of ``rows`` into ``acc``: the rows
    read once (the accepts' last row, the series' chain-0 column), the six
    float fields read and written, accepts and n / kept / stride written,
    the series entries written, and the buffer entries this fold writes
    (its appends and, at a decimation, the chain's whole row), over the
    HBM rate."""
    n, kept, stride = (int(v) for v in (acc.n, acc.kept, acc.stride))
    t_len, c = rows[acc.observable].shape
    cap = acc.buf.shape[1]
    appends = decimations = 0
    for _ in range(t_len):
        if n % stride == 0:
            if kept >= cap:
                kept, stride = cap // 2, stride * 2
                decimations += 1
            kept += 1
            appends += 1
        n += 1
    nbytes = (4 * t_len * c * (1 + ("wait" in rows))
              + 4 * c * ("accepts" in rows)
              + 2 * 4 * t_len * len(acc.series)
              + 2 * 4 * 6 * c + 4 * c + 12
              + 4 * c * (appends + decimations * cap))
    return 1e3 * nbytes / PEAK_BYTES_PER_S, nbytes


def same_fold(got, want, label: str) -> float:
    """Two accumulators bit for bit in every field, the buffer and the
    series (NaN for NaN); returns the largest |difference| (0.0)."""
    import torch
    pairs = [(getattr(got, k), getattr(want, k)) for k in (
        "n", "kept", "stride", "accepts", "mean", "m2", "wsum", "wmean",
        "wm2", "waits", "buf")]
    pairs += [(got.series[k], want.series[k]) for k in want.series]
    for g, w in pairs:
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(
                g.view(torch.int32), w.view(torch.int32)):
            fail(f"{label}: the fold kernel differs from its plain version")
    return max(float((g.double() - w.double()).nan_to_num().abs().max())
               for g, w in pairs)


def same_fused_outputs(got: dict, want: dict, label: str) -> None:
    """Two chunk launches' outputs ({name: tensor}) bit for bit (NaN for
    NaN); ``got`` may leave out what a fused launch without a history does
    not write."""
    import torch
    for k, g in got.items():
        w = want[k]
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if g.dtype != w.dtype or not torch.equal(g, w):
            fail(f"{label}: the fused launch's {k} differs from the "
                 "history-mode launch's")


def lowered_fold_route(cl, bg, spec, params, st, t_len: int):
    """The lowered kernel's two launches at one input state: (history():
    (outputs by name, rows, the next state), fused(acc): (outputs by name,
    acc)), their inputs packed once, outside any timed call."""
    static = cl.make_static_inputs(bg, spec, params)
    ins = (st.board, *cl.pack_state(st, params))

    def history():
        outs = cl.run_lowered_chunk_cuda(bg, static, spec, t_len, *ins)
        return (dict(zip(cl.OUT_NAMES, outs)), cl.chunk_rows(spec, outs),
                cl.unpack_state(st, outs, t_len))

    def fused(acc):
        outs, acc = cl.run_lowered_chunk_cuda(bg, static, spec, t_len, *ins,
                                              acc=acc, keep_rows=False)
        return ({k: v for k, v in zip(cl.OUT_NAMES, outs) if v is not None},
                acc)
    return history, fused


def dense_fold_route(cd, dg, spec, params, st, t_len: int):
    """The dense kernel's two launches at one input state, as
    ``lowered_fold_route``'s (the state's fields are its outputs)."""
    import dataclasses
    static = cd.make_static_inputs(dg)

    def fields(state):
        return {f.name: getattr(state, f.name)
                for f in dataclasses.fields(state)
                if getattr(state, f.name) is not None}

    def history():
        new, rows = cd.run_general_dense_chunk_cuda(dg, static, spec, params,
                                                    st, t_len)
        return ({**fields(new), **{f"row {k}": v for k, v in rows.items()}},
                rows, new)

    def fused(acc):
        new, rows, acc = cd.run_general_dense_chunk_cuda(
            dg, static, spec, params, st, t_len, acc=acc, keep_rows=False)
        if rows:
            fail("a fused dense launch without a history returned rows")
        return fields(new), acc
    return history, fused


def fold_inputs(port, ex, drv, gsampling, cd) -> list:
    """(label, kind, graph, spec, params, state, T) of the chunk shapes the
    summary fold's callers give it: sec11's main path (C=4096, T=500) and
    the experiment path's sec11 0B263P10 (C=8, T=369) on the lowered
    kernel, the hex sweep's batch (C=32, T=2439) and the general main
    path's hex 64x64 (C=4096, T=500, after one chunk, so that the conn
    planes are attached) on the dense kernel."""
    runner = gsampling.runner
    _, bg, st, params, spec = lowered_workload(port, "sec11", CHAINS, 0)
    cfg = experiment_config(ex, "sec11", "0B263P10", total_steps=EXP_STEPS,
                            n_chains=EXP_CHAINS)
    g, plan, _ = drv.build_graph_and_plan(cfg)
    espec = drv.spec_for(cfg)
    _, (ebg, est, epar) = drv._init_run(cfg, g, plan, espec, DEVICE)
    prepared, hst, hpar = sweep_batch(ex, "hex")
    _, gspec, gdg, gst, gpar = general_inputs(
        port, gsampling, "hex_lattice", (GRID, GRID), CHAINS, POP_TOL, BASE,
        seed=0)
    gst, _ = cd.run_general_dense_chunk_cuda(
        gdg, cd.make_static_inputs(gdg), gspec, gpar, gst, CHUNK)
    return [("sec11's main path", "lowered", bg, spec, params, st, CHUNK),
            ("the experiment path", "lowered", ebg, espec, epar, est,
             runner.pick_chunk(EXP_STEPS, 512)),
            ("the hex batch", "dense", prepared[0].handle, prepared[0].spec,
             hpar, hst, runner.pick_chunk(EXP_STEPS, 4096)),
            ("hex 64x64", "dense", gdg, gspec, gpar, gst, CHUNK)]


def fold_route(cl, cd, label, kind, *args):
    """``lowered_fold_route`` or ``dense_fold_route`` of one of
    ``fold_inputs``'s shapes, through the modules ``cl`` and ``cd``."""
    if kind == "lowered":
        return lowered_fold_route(cl, *args)
    return dense_fold_route(cd, *args)


def fold_turns(history, fused, cs, acc0, reps: int = 10,
               rounds: int = 2) -> dict:
    """CUDA-event ms of three routes at one input, timed in turns (H F S,
    then S F H, ...), each call behind a device sleep: the history-mode
    chunk (H), the fused chunk without a history (F), and the history
    chunk followed by the standalone fold of its rows (S). Every fold
    starts from its own copy of ``acc0``, made before the timing."""
    def standalone(acc):
        _, rows, _ = history()
        return cs.summary_fold(acc, rows)
    routes = {"history": lambda acc: history(), "fused": fused,
              "standalone": standalone}
    ms = {k: [] for k in routes}
    order = list(routes)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            accs = [acc0.clone() for _ in range(reps)]
            ms[name].append(device_ms(lambda: routes[name](accs.pop()),
                                      reps))
    return ms


def summary_kernel_cases(port, ex, drv, gsampling, cl, cd, cs, sacc,
                         card: str) -> list:
    """Phase 15 (1): the fold at the shapes its callers give it, two
    chunks in turn (the second from mid-schedule). The standalone kernel
    against its plain version, every field bit-equal and one launch
    counted a call, then its CUDA-event ms (behind a device sleep: at C=8
    the wrapper's host work outlasts the kernel), the plain version's
    host-clock ms and the byte bound. Except for the rows without waits,
    which no chunk kernel makes, the chunk kernel of each case in fused
    summary mode (no history): its state, flip log and outputs bit-equal
    to the history-mode launch's, its accumulator bit-equal to the
    standalone fold of the history rows; then the three routes timed in
    turns (``fold_turns``). The dense kernel runs its wide form (a fold
    warp) at the hex batch's C=32 and its narrow form (the fold on the
    chains' warps) at the general main path's C=4096, its fold launch
    shape printed and checked."""
    import torch
    keys = ("slope", "angle")
    inputs = fold_inputs(port, ex, drv, gsampling, cd)
    main, exp, hexr, narrow = (fold_route(cl, cd, *x) for x in inputs)
    # the dense kernel folds on a fold warp in its wide form, on the
    # chains' warps in its narrow one
    for (label, _, dg, _, _, st, _), wide in zip(inputs[2:], (True, False)):
        c = st.key.shape[0]
        shape = cd.launch_shape(dg, c, fold=True)
        print(f"[{card}] general_dense_chunk fold instantiation at {label}, "
              f"C={c}: {shape}")
        if shape["producer"] != wide:
            fail(f"general_dense_chunk at {label}: not the "
                 f"{'wide' if wide else 'narrow'} form")
    warp, own = "a fold warp", "the chains' warps"
    cases = (("sec11 main-path rows", main, cl, warp, 4096, keys, True),
             ("the experiment path's rows", exp, cl, warp, 4096, keys,
              True),
             ("the hex batch's dense rows", hexr, cd, warp, 4096, (), True),
             ("the general main path's dense rows", narrow, cd, own, 4096,
              (), True),
             ("the experiment path's rows, cap 8", exp, cl, warp, 8, keys,
              True),
             ("the experiment path's rows without waits", exp, cl, None,
              4096, keys, False))
    out = []
    for label, (history, fused), kern, form, cap, series, waits in cases:
        outs, rows, _ = history()
        if not waits:
            rows = {k: v for k, v in rows.items() if k != "wait"}
        t_len, c = rows["cut_count"].shape
        label = f"[{card}] summary_fold, {label} C={c} T={t_len}"
        acc = sacc.init_summary(c, cap=cap, series_keys=series,
                                series_cap=EXP_STEPS, device=DEVICE)
        plain, fused_acc, err = acc.clone(), acc.clone(), 0.0
        for _ in range(2):
            start, fused_start = acc.clone(), fused_acc.clone()
            torch.cuda.synchronize()
            n0 = cs.summary_fold.launches
            acc = cs.summary_fold(acc, rows)
            torch.cuda.synchronize()
            if cs.summary_fold.launches != n0 + 1:
                fail(f"{label}: the wrapper did not count its launch")
            t0 = time.perf_counter()
            plain = sacc.fold_block(plain, rows)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            err = max(err, same_fold(acc, plain, label))
            if not waits:
                continue
            # the chunk kernel folding its own records, from the same
            # accumulator state
            f0 = cs.fused_fold.launches
            got, fused_acc = fused(fused_acc)
            torch.cuda.synchronize()
            if cs.fused_fold.launches != f0 + 1:
                fail(f"{label}: the fused launch was not counted")
            same_fused_outputs(got, outs, label)
            err = max(err, same_fold(fused_acc, acc, label + " (fused)"))
        reps = 10
        clones = [start.clone() for _ in range(reps)]
        ms = device_ms(lambda: cs.summary_fold(clones.pop(), rows), reps)
        bound_ms, nbytes = fold_bound(start, rows)
        print(f"{label}, cap {cap}, series {len(series)}: bit-equal to the "
              f"plain version in every field (two folds, n {int(acc.n)}, "
              f"kept {int(acc.kept)}, stride {int(acc.stride)}); "
              f"{ms:.4f} ms a fold (CUDA events behind a device sleep, "
              f"mean of {reps}), plain "
              f"version {plain_ms:.3f} ms; bound {bound_ms:.6f} ms "
              f"({nbytes:.4e} bytes)")
        case = dict(case=label, chains=c, steps=t_len, cap=cap, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                    max_abs_err=err, kernel=None)
        out.append(case)
        if not waits:
            continue
        turns = fold_turns(history, fused, cs, fused_start)
        span = {k: (min(v), max(v)) for k, v in turns.items()}
        fold_in_chunk = (min(turns["fused"]) - max(turns["history"]),
                         max(turns["fused"]) - min(turns["history"]))
        kname = "lowered_chunk" if kern is cl else "general_dense_chunk"
        print(f"{label}: fused into {kname} (on {form}): state, flip log "
              f"and outputs bit-equal to the history-mode launch, accumulator "
              f"bit-equal to the standalone fold (two chunks); in turns "
              f"(ms a chunk, CUDA events behind a device sleep, "
              f"{len(turns['fused'])} x mean of 10): history "
              f"{span['history'][0]:.4f}-{span['history'][1]:.4f}, fused "
              f"{span['fused'][0]:.4f}-{span['fused'][1]:.4f}, history + "
              f"standalone fold {span['standalone'][0]:.4f}-"
              f"{span['standalone'][1]:.4f}; the fold inside the chunk "
              f"{fold_in_chunk[0]:+.4f} to {fold_in_chunk[1]:+.4f} ms")
        case.update(kernel=kname, form=form, turns=turns,
                    fused_minus_history_ms=fold_in_chunk)
    return out


def summary_runs(ex, drv, cl, cd, cs, sacc, solo: dict, card: str) -> dict:
    """Phase 15 (2): run_config in summary mode for SUMMARY_RUNS at the
    paper's shape, the counts zeroed just before and read just after:
    every artifact byte-equal to the history-mode run's (phases 7 and 12),
    the fold launched once a chunk and once for the run's other record,
    the seconds split, the readback, and ``data["summary"]`` bit-equal to
    the plain fold_block of the history-mode run's history on the card."""
    import os
    import tempfile

    import numpy as np
    import torch

    from flipcomplexityempirical_tpu_torch.kernel import cuda_board as cb
    from flipcomplexityempirical_tpu_torch.kernel import probes
    results = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for family, tag in SUMMARY_RUNS:
            cfg = experiment_config(ex, family, tag, total_steps=EXP_STEPS,
                                    n_chains=EXP_CHAINS, analytics="summary")
            out = os.path.join(tmp, family)
            torch.cuda.synchronize()
            zero_launch_counts(cb, cl, cd, probes)
            cs.summary_fold.launches = 0
            cs.fused_fold.launches = 0
            t0 = time.perf_counter()
            data = ex.run_config(cfg, out, device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            folds = cs.summary_fold.launches
            fused = cs.fused_fold.launches
            chunks = (cl.run_lowered_chunk_cuda.launches
                      + cd.run_general_dense_chunk_cuda.launches)
            kernel = "general_dense_chunk" if family == "hex" else \
                "lowered_chunk"
            # the chunks fold their own records; the run's one-row record
            # (the board path's final yield, the general path's initial
            # one) is the one standalone launch
            if chunks == 0 or fused != chunks or folds != 1:
                fail(f"summary {tag}: {fused} fused launches for {chunks} "
                     f"chunks, summary_fold launched {folds} times")
            got = artifact_digests(ex, cfg, out)
            bad = sorted(k for k in got
                         if got[k] != HISTORY_ARTIFACTS[tag].get(k))
            if bad or len(got) != len(HISTORY_ARTIFACTS[tag]):
                fail(f"summary {tag}: artifacts differ from the history "
                     f"mode's: {bad}")
            hist = solo[tag]["history"]
            for k, v in data["history"].items():
                if not np.array_equal(v[0].view(np.int32),
                                      np.asarray(hist[k][0]).view(np.int32)):
                    fail(f"summary {tag}: series {k} differs")
            rows = {k: torch.as_tensor(hist[k], device=DEVICE).T.contiguous()
                    for k in ("cut_count", "wait", "accepts")}
            result = results[tag] = {}

            def check(want, secs, tag=tag, family=family,
                      summary=data["summary"], result=result):
                ref = sacc.summary_host(want)
                for k in sacc.SUMMARY_FIELDS:
                    a, b = np.asarray(summary[k]), ref[k]
                    if a.dtype != b.dtype or not np.array_equal(
                            a.view(np.int32), b.view(np.int32)):
                        fail(f"summary {tag}: data['summary'][{k!r}] "
                             "differs from the plain fold of the history")
                result["plain_fold_s"] = secs
                print(f"[{card}] summary {family} {tag}: data['summary'] "
                      f"bit-equal to the plain fold of the history-mode "
                      f"run's history ({secs:.3f} s, host clock)")
                return 0.0
            # held after phase 24 (plain_jobs)
            hold_plain("summary_fold", sacc.fold_block,
                       (sacc.init_summary(cfg.n_chains, device=DEVICE),
                        rows), check, defer=True)
            run_s, render_s = data["seconds"], data["render_seconds"]
            fps = cfg.n_chains * (cfg.total_steps - 1) / run_s
            print(f"[{card}] summary {family} {tag} ({cfg.n_chains} chains "
                  f"x {cfg.total_steps} steps): {wall:.3f} s in all, run "
                  f"{run_s:.3f} s (history mode {solo[tag]['seconds']:.3f}), "
                  f"render {render_s:.3f} s, set-up and scores "
                  f"{wall - run_s - render_s:.3f} s; {fps:.6e} flips/s; "
                  f"{kernel} launches {chunks}, each folding its records "
                  f"(on a fold warp), summary_fold launches {folds}; "
                  f"readback "
                  f"{data['readback_bytes']} bytes; "
                  f"{len(got)} artifacts byte-equal to the history mode's; "
                  f"data['summary'] held to the plain fold of the history "
                  f"after phase 24")
            result.update(wall_s=wall, run_s=run_s, render_s=render_s,
                          history_run_s=solo[tag]["seconds"],
                          flips_per_s=fps, chunks=chunks, launches=folds,
                          fused_launches=fused,
                          readback_bytes=data["readback_bytes"])
    return results


def ess_record(stderr: str, label: str) -> dict:
    """The cut_ess_per_sec record of a ``bench --ess`` run's stderr,
    computed on the card and within 1 % of the host's float64 ESS."""
    recs = [json.loads(ln) for ln in stderr.splitlines()
            if ln.startswith("{") and '"cut_ess_per_sec"' in ln]
    if len(recs) != 1:
        fail(f"bench {label}: {len(recs)} cut_ess_per_sec records")
    rec = recs[0]
    if (rec.get("ess_on_device") is not True
            or not rec.get("ess_host_check", 1.0) < 0.01
            or not rec["value"] > 0):
        fail(f"bench {label}: ESS record {rec}")
    print(f"bench {label} ESS: {json.dumps(rec)}")
    return rec


def summary_phase(port, ex, drv, gsampling, cl, cd, solo: dict,
                  card: str) -> dict:
    """Phase 15: the device analytics on the card."""
    from flipcomplexityempirical_tpu_torch.kernel import cuda_summary as cs
    from flipcomplexityempirical_tpu_torch.stats import accumulators as sacc
    cases = summary_kernel_cases(port, ex, drv, gsampling, cl, cd, cs, sacc,
                                 card)
    runs = summary_runs(ex, drv, cl, cd, cs, sacc, solo, card)
    return {"cases": cases, "runs": runs}


# ---------------------------------------------------------------------------
# The general path's new forms (phases 16-19): the dense kernel's interface
# rows, the pair walk's kernel, their exact distributions, and the dual,
# variant and exact-contiguity runs end to end
# ---------------------------------------------------------------------------

# (label, graph, plan, spec keywords, base, pop_tol, chains, chunk) of
# the interface form's exactness and timing cases: sec11 0B263P10 and the
# Frankengraph 0B30P50 with a proposal variant, at the experiment path's
# shape (pick_chunk(100000, 4096) = 2439; their plain versions held after
# phase 23) and at the main path's
IFACE_CASES = (
    ("sec11 nobacktrack, the experiment path's shape", "grid_sec11",
     "sec11_plan", dict(nobacktrack=True), BASE, 0.1, 8, 2439),
    ("frankengraph lazy_uniform, the experiment path's shape",
     "frankengraph", "frank_plan", dict(lazy_uniform=True), 0.3, 0.5, 8,
     2439),
    ("sec11 nobacktrack, the main path's shape", "grid_sec11", "sec11_plan",
     dict(nobacktrack=True), BASE, 0.1, CHAINS, CHUNK),
)
# the pair kernel's cases: the dual sweep's configs at the sweep's shape
# (C=8, T=2439; their plain versions held after phase 24), then the
# full-width 64 x 64 hex lattice at k = 4
PAIR_DUAL = (("dual-K4-0B263P25", 4), ("dual-K8-0B263P25", 8))
PAIR_HEX = dict(m=64, k=4, chains=CHAINS, chunk=CHUNK, tol=0.1, steps=1001)
# exact distributions: (label, graph maker, k, base, pop_tol, weighted)
PAIR_ENUM = (("3x3 grid k=3", "grid", 3, 1.5, 0.5, False),
             ("dual 3x4 k=3 weighted_cut", "dual", 3, 2.0, 0.3, True))
PAIR_ENUM_BURN = 400
# the runs of phase 19 at the paper's shape, and the JAX-made fixtures
# (tests/test_torch_general_experiments.py) the card's short runs equal
GEN_PAPER_RUNS = (("dual", "dual-K4-0B263P25", dict(n_districts=4)),
                  ("dual", "dual-K8-0B263P25", dict(n_districts=8)),
                  ("sec11", "0B263P10-NOBA", dict(variant="nobacktrack")))
GEN_NEW_FIXTURES = {
    "dual": dict(family="dual", alignment=0, base=BASE, pop_tol=0.25,
                 n_districts=4),
    "sec11_nobacktrack": dict(family="sec11", alignment=0, base=BASE,
                              pop_tol=0.1, variant="nobacktrack"),
}
EXACT_LEGACY = dict(chains=8, steps=250, base=BASE, pop_tol=0.1)
# Operations of an accepted pair move beyond general_bound's K_GMOVE: the
# move changes the neighbouring-district sets of v and its D neighbours,
# each rebuilt from its D neighbours (K_PNODE a read), and the distinct-
# pair count by the change of those rows. No per-node term: the population
# gates change only with the two tallies a move touches, and the nodes
# that pass a gate can be counted from an order by population without a
# visit to each node, so a recount of every node's valid pairs after a
# move (the kernel's under a population that varies by node) is a
# design's cost, not the function's.
K_PNODE = 6


def rows_bit_equal(got: dict, want: dict, label: str) -> None:
    """The interface rows equal value for value, NaN exactly where the
    plain version's are (the kernel's NaN bits are its own)."""
    import torch
    for k in ("slope", "angle"):
        if k not in want:
            continue
        g, w = got[k], want[k]
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            fail(f"{label}: {k} NaN where the plain version has none, or "
                 "the other way")
        ok = ~torch.isnan(w)
        if not torch.equal(g[ok], w[ok]):
            fail(f"{label}: {k} differs from the plain version")


def pair_bound(dg, spec, state, t_len: int, accepted: int):
    """(bound ms, by) of one pair chunk: the state read and written once,
    the rows written once, the tables read once; the operations of this
    run's data (general_bound's, and K_PNODE's rows of each accepted
    move)."""
    ms, by, nbytes, ops = general_bound(dg, spec, state, t_len, accepted)
    c = state.assignment.shape[0]
    d = dg.max_deg
    ops += accepted * (1 + d) * d * K_PNODE + 4 * c * spec.n_districts
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def interface_phase(port, cd, sampling) -> dict:
    """Phase 16: general_dense_chunk's interface form (record_interface)
    against its plain version at IFACE_CASES, every state field and row
    bit-equal, NaN for NaN, each launch counted and timed with CUDA
    events beside its bound. (dense_turns.py times the hex history-mode
    instantiations in turns against an older kernel.)"""
    import torch
    out = {"cases": []}
    for (label, gname, planf, kw, base, tol, chains,
         t_len) in IFACE_CASES:
        g = getattr(port.graphs, gname)()
        plan = getattr(port.graphs, planf)(g, 0)
        spec = port.Spec(record_interface=True, **kw)
        dg, st, params = sampling.init_batch(g, plan, n_chains=chains,
                                             seed=16, spec=spec, base=base,
                                             pop_tol=tol, device=DEVICE)
        static = cd.make_static_inputs(dg, spec)
        n0 = cd.run_general_dense_chunk_cuda.launches
        got, rows = cd.run_general_dense_chunk_cuda(dg, static, spec, params,
                                                    st, t_len)
        torch.cuda.synchronize()
        if cd.run_general_dense_chunk_cuda.launches != n0 + 1:
            fail(f"interface {label}: the wrapper did not count its launch")
        case = {"case": label, "chains": chains, "chunk": t_len}

        def check(want, secs, got=got, rows=rows, label=label,
                  chains=chains, t_len=t_len, case=case):
            case["plain_ms"] = 1e3 * secs
            err = compare_general(cd, got, rows, *want,
                                  f"interface form, {label} C={chains} "
                                  f"T={t_len} (plain {secs:.3f} s, host "
                                  f"clock)")
            rows_bit_equal(rows, want[1], f"interface {label}")
            return err
        # the experiment path's chunks held after phase 24 (plain_jobs)
        hold_plain("general_dense_chunk", cd.general_dense_chunk_reference,
                   (dg, spec, params, st, t_len), check,
                   defer=t_len > CHUNK)
        nan = int(torch.isnan(rows["slope"]).sum())
        run = (lambda dg=dg, static=static, spec=spec, params=params,
               got=got, t_len=t_len: cd.run_general_dense_chunk_cuda(
                   dg, static, spec, params, got, t_len))
        ms = event_ms(run, 3)
        timed, _ = run()
        bound_ms, bound_by, _, _ = general_bound(
            dg, spec, timed, t_len,
            int((timed.accept_count - got.accept_count).sum()))
        shape = cd.launch_shape(dg, chains, iface=True)
        print(f"general_dense_chunk interface form, {label} (C={chains}, "
              f"T={t_len}): {nan} NaN slope rows of "
              f"{rows['slope'].numel()}; {ms:.4f} ms per chunk (CUDA "
              f"events, mean of 3); bound {bound_ms:.4e} ms ({bound_by}); "
              f"tables "
              f"{'staged' if shape['staged'] else 'read through L1'}, "
              f"{shape['chains_per_block']} chain(s) a block, "
              f"{shape['blocks_per_sm']} block(s) an SM")
        case.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                    nan_rows=nan)
        out["cases"].append(case)
    return out


def pair_cases(port, drv, ex, sampling) -> list:
    """(label, graph handle, spec, params, state, T) of the pair kernel's
    main-path shapes: the dual sweep's
    K4 and K8 configs (144 nodes, C=8, T=2439) and hex 64 x 64, k = 4,
    C=4096, T=500 after a 501-step warm-up (dense_turns.py times them too)."""
    cases = []
    for tag, k in PAIR_DUAL:
        cfg = next(c for c in ex.SWEEPS["dual"](total_steps=EXP_STEPS,
                                                 n_chains=EXP_CHAINS)
                   if c.tag == tag)
        g, plan, _ = drv.build_graph_and_plan(cfg)
        spec = drv.spec_for(cfg)
        dg, st, params = sampling.init_batch(
            g, plan, n_chains=cfg.n_chains, seed=cfg.seed, spec=spec,
            base=cfg.base, pop_tol=cfg.pop_tol, device=DEVICE)
        t_len = sampling.runner.pick_chunk(EXP_STEPS, 4096)
        cases.append((f"{tag} (the dual sweep's shape)", dg, spec, params,
                      st, t_len))
    m, k = PAIR_HEX["m"], PAIR_HEX["k"]
    g = port.graphs.hex_lattice(m, m)
    spec = port.Spec(n_districts=k, proposal="pair")
    dg, st, params = sampling.init_batch(
        g, port.graphs.stripes_plan(g, k), n_chains=PAIR_HEX["chains"],
        seed=18, spec=spec, base=BASE, pop_tol=PAIR_HEX["tol"],
        device=DEVICE)
    st = sampling.run_chains(dg, spec, params, st, n_steps=CHUNK + 1,
                             chunk=CHUNK, record_history=False).state
    cases.append((f"hex {m}x{m} k={k} (the full-width path)", dg, spec,
                  params, st, PAIR_HEX["chunk"]))
    return cases


def pair_phase(port, cp, drv, ex, sampling, card: str) -> dict:
    """Phase 17: general_pair_chunk against its plain version at the dual
    sweep's shape (k = 4 and 8, C=8, T=2439; their plain versions held
    after phase 24) and at the full-width hex
    64 x 64, k = 4, C=4096, T=500 (timed beside its bound), each launch
    counted; then run_chains at that shape with the count zeroed just
    before: flips/s, launches a chunk, peak memory and idle share."""
    import torch
    err = 0.0
    cases = pair_cases(port, drv, ex, sampling)
    m, k = PAIR_HEX["m"], PAIR_HEX["k"]
    timing = {}
    for label, dg, spec, params, st, t_len in cases:
        static = cp.make_static_inputs(dg)
        n0 = cp.run_general_pair_chunk_cuda.launches
        got, rows = cp.run_general_pair_chunk_cuda(dg, static, spec, params,
                                                   st, t_len)
        torch.cuda.synchronize()
        if cp.run_general_pair_chunk_cuda.launches != n0 + 1:
            fail(f"pair {label}: the wrapper did not count its launch")
        case = timing[label] = {"chains": st.n_chains, "chunk": t_len}

        def check(want, secs, got=got, rows=rows, label=label, c=st.n_chains,
                  t_len=t_len, case=case):
            case["plain_ms"] = 1e3 * secs
            return compare_general(
                cp, got, rows, *want, f"{label} C={c} T={t_len} (plain "
                f"{secs:.3f} s, host clock)", name="general_pair_chunk")
        # the dual sweep's chunks held after phase 24 (plain_jobs)
        err = max(err, hold_plain(
            "general_pair_chunk", cp.general_pair_chunk_reference,
            (dg, spec, params, st, t_len), check, defer=t_len > CHUNK))
        run = (lambda dg=dg, static=static, spec=spec, params=params,
               got=got, t_len=t_len: cp.run_general_pair_chunk_cuda(
                   dg, static, spec, params, got, t_len))
        ms = event_ms(run, 3)
        rc = torch.zeros(st.n_chains, dtype=torch.int32, device=DEVICE)
        timed, _ = cp.run_general_pair_chunk_cuda(dg, static, spec, params,
                                                  got, t_len, recounts=rc)
        accepted = int((timed.accept_count - got.accept_count).sum())
        recounts = int(rc.sum())
        bound_ms, bound_by = pair_bound(dg, spec, timed, t_len, accepted)
        shape = cp.launch_shape(dg, st.n_chains, spec.n_districts)
        resident = shape["chains_per_block"] * shape["blocks_per_sm"]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = sm_mhz(clocks_under_load(run, max(20, int(400 / ms))))
        cyc = ms * 1e3 * mhz / t_len if mhz else None
        print(f"general_pair_chunk {label} (C={st.n_chains}, T={t_len}, "
              f"{dg.n_nodes} nodes, {accepted} accepted moves): {ms:.4f} ms "
              f"per chunk (CUDA events, mean of 3); bound "
              f"{bound_ms:.4e} ms ({bound_by}); tables "
              f"{'staged' if shape['staged'] else 'read through L1'}, "
              f"{shape['chain_bytes']} B a chain, {shape['smem_bytes']} B "
              f"of shared memory a block, {shape['chains_per_block']} "
              f"chain(s) a block"
              f"{' with a draws warp' if shape['producer'] else ''}, "
              f"{shape['blocks_per_sm']} block(s) an SM ({resident} chains "
              f"resident an SM, {-(-st.n_chains // (sms * resident))} "
              f"wave(s) on {sms} SMs); "
              + (f"{cyc:.1f} cycles a step at {mhz:.0f} MHz" if cyc else
                 "cycles a step not measured (no SM clock read)")
              + f"; {recounts} full recounts in the chunk "
              f"({recounts / st.n_chains:.2f} a chain)")
        if label.startswith("hex") and resident <= 8:
            fail(f"general_pair_chunk {label}: {resident} chains resident "
                 "an SM, not more than 8")
        case.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                    shape=shape, cycles_per_step=cyc, sm_mhz=mhz,
                    recounts=recounts, accepted=accepted)
    # the full-width path through run_chains, the count zeroed just before
    steps = PAIR_HEX["steps"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cp.run_general_pair_chunk_cuda.launches = 0
    t0 = time.perf_counter()
    res = sampling.run_chains(dg, spec, params, st, n_steps=steps,
                              chunk=CHUNK, record_history=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cp.run_general_pair_chunk_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-(steps - 1) // CHUNK)
    if launches != chunks:
        fail(f"pair main path: general_pair_chunk launched {launches} times "
             f"for {chunks} chunks")
    fs = res.state
    from flipcomplexityempirical_tpu_torch.state import chain_state
    if not bool((fs.b_count == chain_state.b_nodes_count(
            dg, fs.assignment, fs.cut_deg, k, "pair")).all()):
        fail("pair main path: b_count disagrees with a recount")
    fps = PAIR_HEX["chains"] * (steps - 1) / wall
    prof = idle_share(lambda: sampling.run_chains(
        dg, spec, params, fs, n_steps=steps, chunk=CHUNK,
        record_history=False))
    print(f"[{card}] pair main path: run_chains on hex {m}x{m}, k={k}, "
          f"{PAIR_HEX['chains']} chains x {steps} steps in {wall:.3f} s, "
          f"{fps:.6e} flips/s; general_pair_chunk launches {launches} for "
          f"{chunks} chunks; peak memory {peak / 2 ** 20:.1f} MiB; profile: "
          f"{prof}")
    main = timing[cases[-1][0]]
    return {"launches": launches, "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "cases": timing,
            "main_path": {"flips_per_s": fps, "wall_s": wall,
                          "peak_mib": peak / 2 ** 20, "profile": prof}}


def pair_stationary(port, sampling) -> dict:
    """Phase 18: the pair kernel's chains against the exact stationary law
    of the rejection-free pair chain (``_torch_enumeration.
    build_pair_transition``, its lazy iteration) on the 3 x 3 grid at
    k = 3 (tests/test_enumeration.py:181, :248) and on a 12-node dual map
    with the boundary-length score: en.CHAINS chains, PAIR_ENUM_BURN
    steps, then en.SAMPLES one-step calls pooled; phase 13's bars."""
    import numpy as np
    import torch
    import _torch_enumeration as en
    from flipcomplexityempirical_tpu_torch.sampling.runner import pop_bounds
    out = {}
    for b, (label, kind, k, base, tol, weighted) in enumerate(PAIR_ENUM):
        if kind == "grid":
            g = port.graphs.square_grid(3, 3)
        else:
            g, _ = port.graphs.from_geojson(
                port.graphs.synthetic_precincts(3, 4, seed=0),
                pop_property="POP")
        plan = port.graphs.stripes_plan(g, k)
        lo, hi = pop_bounds(g, k, tol)
        states, P, cuts = en.build_pair_transition(g, plan, k, base, lo, hi,
                                                   weighted=weighted)
        pi = en.stationary_lazy(P)
        spec = port.Spec(n_districts=k, proposal="pair",
                         weighted_cut=weighted)
        dg, st, params = sampling.init_batch(
            g, plan, n_chains=en.CHAINS, seed=300 + b, spec=spec, base=base,
            pop_tol=tol, device=DEVICE)
        t0 = time.perf_counter()
        st = sampling.run_chains(dg, spec, params, st,
                                 n_steps=PAIR_ENUM_BURN + 1,
                                 record_history=False).state
        boards = []
        for _ in range(en.SAMPLES):
            st = sampling.run_chains(dg, spec, params, st, n_steps=1,
                                     record_initial=False,
                                     record_history=False).state
            boards.append(st.assignment)
        rows = torch.cat(boards).cpu().numpy()
        chain = np.tile(np.arange(en.CHAINS), len(boards))
        try:
            tv, cut_err, t = en.pair_pool_check(rows, chain, states, pi,
                                                cuts)
        except KeyError as exc:
            fail(f"pair {label}: a chain left the closure ({exc})")
        t_max = float(np.abs(t).max())
        print(f"stationary general_pair {label} base {base}: TV {tv:.6f}, "
              f"E|cut| relative error {cut_err:.6f}, t of E|cut| "
              f"{t[0]:.3f}, max |t| {t_max:.3f} over E|cut| and the "
              f"{g.n_nodes} nodes' mean districts ({len(rows)} assignments "
              f"of {len(states)} states, {en.CHAINS} chains x {en.SAMPLES} "
              f"steps after {PAIR_ENUM_BURN}; "
              f"{time.perf_counter() - t0:.3f} s)")
        if tv >= en.TV_POOL_TOL or cut_err >= en.CUT_TOL or \
                not t_max < en.T_TOL:
            fail(f"pair {label}: TV {tv:.4f} (bar {en.TV_POOL_TOL}), E|cut| "
                 f"error {cut_err:.4f} (bar {en.CUT_TOL}) or max |t| "
                 f"{t_max:.2f} (bar {en.T_TOL})")
        out[label] = {"tv": tv, "cut_err": cut_err, "t_cut": float(t[0]),
                      "t_max": t_max, "states": len(states)}
    return out


def new_runs_phase(ex, drv, cp, cd, sampling, out_dir: str,
                   card: str) -> dict:
    """Phase 19: run_config at the paper's shape for GEN_PAPER_RUNS (the
    counts zeroed before each, one launch a chunk; seconds split into
    run, render and set-up), the card's short runs held to the JAX-made
    fixtures, the dual sweep through SweepService (one batch a k, each
    named tenant equal to its solo run above), and sec11 with contiguity
    'exact' on the legacy body against its CPU run."""
    import os

    import numpy as np
    import torch
    import _parity
    from flipcomplexityempirical_tpu_torch import convert
    from flipcomplexityempirical_tpu_torch.service import SweepService
    out, solo = {}, {}
    for family, tag, kw in GEN_PAPER_RUNS:
        cfg = next(c for c in ex.SWEEPS[family](
            total_steps=EXP_STEPS, n_chains=EXP_CHAINS, **(
                {"variant": kw["variant"]} if "variant" in kw else {}))
            if c.tag == tag)
        pair = cfg.family == "dual"
        wrapper = (cp.run_general_pair_chunk_cuda if pair
                   else cd.run_general_dense_chunk_cuda)
        wrapper.launches = 0
        t0 = time.perf_counter()
        data = drv.run_config(cfg, os.path.join(out_dir, "runs"),
                              device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        chunks = -(-(EXP_STEPS - 1) // sampling.runner.pick_chunk(
            EXP_STEPS, 4096))
        if wrapper.launches != chunks:
            fail(f"{tag}: {wrapper.launches} launches for {chunks} chunks")
        n_art = sum(os.path.exists(os.path.join(out_dir, "runs", tag + a))
                    for a in drv.artifact_kinds(cfg.family))
        if n_art != len(drv.artifact_kinds(cfg.family)):
            fail(f"{tag}: {n_art} artifacts written")
        setup = wall - data["seconds"] - data["render_seconds"]
        name = "general_pair_chunk" if pair else "general_dense_chunk"
        label = tag
        print(f"[{card}] run_config {cfg.family} {label} ({EXP_STEPS} steps, "
              f"{EXP_CHAINS} chains): {wall:.3f} s wall, run "
              f"{data['seconds']:.3f} s, render {data['render_seconds']:.3f} "
              f"s, set-up {setup:.3f} s; {name} launches {wrapper.launches} "
              f"for {chunks} chunks; {n_art} artifacts")
        out[label] = {"wall_s": wall, "run_s": data["seconds"],
                      "render_s": data["render_seconds"], "setup_s": setup,
                      "launches": wrapper.launches, "chunks": chunks}
        solo[tag] = data
        if not pair:      # the variant in summary mode: the interface
            # series folded inside the dense kernel's launches
            import dataclasses
            from flipcomplexityempirical_tpu_torch.kernel import cuda_summary
            scfg = dataclasses.replace(cfg, analytics="summary")
            cd.run_general_dense_chunk_cuda.launches = 0
            cuda_summary.fused_fold.launches = 0
            cuda_summary.summary_fold.launches = 0
            t0 = time.perf_counter()
            sdata = drv.run_config(scfg, os.path.join(out_dir, "summary"),
                                   device=DEVICE)
            torch.cuda.synchronize()
            swall = time.perf_counter() - t0
            if (artifact_digests(ex, scfg, os.path.join(out_dir, "summary"))
                    != artifact_digests(ex, cfg, os.path.join(out_dir,
                                                              "runs"))):
                fail(f"{tag} in summary mode: an artifact differs from the "
                     "history mode's")
            fused = cuda_summary.fused_fold.launches
            if (fused != chunks or cd.run_general_dense_chunk_cuda.launches
                    != chunks or cuda_summary.summary_fold.launches != 1):
                fail(f"{tag} in summary mode: {fused} fused launches, "
                     f"{cuda_summary.summary_fold.launches} standalone for "
                     f"{chunks} chunks")
            print(f"[{card}] run_config {tag} in summary mode: {swall:.3f} s "
                  f"wall, run {sdata['seconds']:.3f} s; {fused} chunks each "
                  "folding its records and the slope and angle series "
                  "inside general_dense_chunk, summary_fold launches 1; "
                  "every artifact byte-equal to the history mode's")
            out[label]["summary"] = {"wall_s": swall,
                                     "run_s": sdata["seconds"],
                                     "fused_launches": fused}
    for which, kw in GEN_NEW_FIXTURES.items():
        fx = dict(np.load(ROOT / "tests" / "fixtures" / "torch" /
                          f"experiment_{which}.npz"))
        cfg = ex.ExperimentConfig(**kw, total_steps=401, n_chains=2, seed=0)
        fdir = os.path.join(out_dir, f"fixture_{which}")
        data = drv.run_config(cfg, fdir, device=DEVICE)
        got = _parity.experiment_arrays(data, open(os.path.join(
            fdir, cfg.tag + "wait.txt")).read())
        if cfg.family == "dual":
            for kind in ("compactness.json", "partisan.json"):
                got[kind.replace(".", "_")] = np.asarray(open(
                    os.path.join(fdir, cfg.tag + kind)).read())
        try:
            ties = _parity.assert_experiment_matches(
                got, fx, waits="scaled" if cfg.family == "dual" else "unit")
        except AssertionError as exc:
            fail(f"fixture {which}: {exc}")
        print(f"fixture ({which}: the JAX package's run_config, {cfg.tag}, "
              f"401 steps, 2 chains): equal in every array and artifact "
              f"text; waits off by a log tie {ties}")
    # the dual sweep through the service: one batch a k
    svc = SweepService(os.path.join(out_dir, "svc"), device=DEVICE)
    cfgs = list(ex.SWEEPS["dual"](total_steps=EXP_STEPS, n_chains=EXP_CHAINS))
    jobs = [svc.submit(c) for c in cfgs]
    cp.run_general_pair_chunk_cuda.launches = 0
    t0 = time.perf_counter()
    svc.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(j.tag, j.error) for j in jobs if j.status != "done"]
    if bad or svc.exit_code != 0 or len(svc.batch_stats) != 2:
        fail(f"service dual: {len(svc.batch_stats)} batches, failed {bad}")
    for j in jobs:
        if j.tag in solo:
            same_result(j.result, solo[j.tag], f"service dual tenant {j.tag}")
    stats = svc.batch_stats
    print(f"[{card}] service dual: {len(cfgs)} configs as {len(stats)} "
          f"batches of {[s.chains for s in stats]} chains x {EXP_STEPS} steps "
          f"({stats[0].kernel_path}): {wall:.3f} s in all, prepare "
          f"{sum(s.prepare_s for s in stats):.3f} s, run "
          f"{sum(s.wall_s for s in stats):.3f} s, slice/assemble "
          f"{sum(s.assemble_s for s in stats):.3f} s; general_pair_chunk "
          f"launches {cp.run_general_pair_chunk_cuda.launches}; tenants "
          f"{sorted(t for t in solo if t.startswith('dual'))} equal to their "
          "solo runs in every state field, history key and result")
    out["service_dual"] = {"wall_s": wall, "batches": len(stats),
                           "launches": cp.run_general_pair_chunk_cuda.launches,
                           "run_s": sum(s.wall_s for s in stats)}
    # sec11 with contiguity 'exact': the legacy body on the card against
    # the same run on the host
    import flipcomplexityempirical_tpu_torch as port
    g = port.graphs.grid_sec11()
    plan = port.graphs.sec11_plan(g, 0)
    spec = port.Spec(contiguity="exact", record_interface=True)
    runs = {}
    for dev in (DEVICE, "cpu"):
        dg, st, params = sampling.init_batch(
            g, plan, n_chains=EXACT_LEGACY["chains"], seed=19, spec=spec,
            base=EXACT_LEGACY["base"], pop_tol=EXACT_LEGACY["pop_tol"],
            device=dev)
        t0 = time.perf_counter()
        runs[dev] = sampling.run_chains(dg, spec, params, st,
                                        n_steps=EXACT_LEGACY["steps"],
                                        kernel_path="general")
        if dev == DEVICE:
            torch.cuda.synchronize()
        runs[dev + "_s"] = time.perf_counter() - t0
    a, b = runs[DEVICE], runs["cpu"]
    try:
        ties = _parity.assert_chain_run_matches(
            convert.to_numpy(a.state), a.history, a.waits_total,
            convert.to_numpy(b.state), b.history, b.waits_total)
    except AssertionError as exc:
        fail(f"sec11 contiguity exact: the card's run differs from the "
             f"host's: {exc}")
    print(f"[{card}] sec11 contiguity exact (legacy body, "
          f"{EXACT_LEGACY['chains']} chains x {EXACT_LEGACY['steps']} steps, "
          f"record_interface): card {runs[DEVICE + '_s']:.3f} s, host "
          f"{runs['cpu_s']:.3f} s; equal to the host's run, waits off by a "
          f"log tie {ties}")
    out["exact_legacy"] = {"card_s": runs[DEVICE + "_s"],
                           "host_s": runs["cpu_s"], "ties": ties}
    return out


# ---------------------------------------------------------------------------
# Phases 20-23: the rook board's k-district pair walk (its kernel
# board_pair_chunk, its main path, the kpair family) and replica-exchange
# tempering (the temper family on lowered_chunk)
# ---------------------------------------------------------------------------

# board_pair_chunk's exactness cases: (label, h, w, k, chains, pop_tol,
# base, spec overrides, the kernel's warm-up steps before the case), each
# a BPAIR_T-step chunk from the warmed state against the plain version
BPAIR_T = 64
BPAIR_CASES = (
    ("64x64 k=4", 64, 64, 4, 256, 0.5, BASE, {}, 200),
    ("40x65 k=3 (a width that straddles words)", 40, 65, 3, 128, 0.5, 0.8,
     {}, 200),
    ("8x16 k=8 pop_tol 0.1 (gates that bind)", 8, 16, 8, 125, 0.1, 0.8, {},
     200),
    ("64x64 k=4 parity_metrics off", 64, 64, 4, 128, 0.5, BASE,
     {"parity_metrics": False}, 200),
    ("64x64 k=4 contiguity none", 64, 64, 4, 256, 0.5, BASE,
     {"contiguity": "none"}, 200),
    ("64x64 k=4 accept always", 64, 64, 4, 128, 0.5, BASE,
     {"accept": "always"}, 200),
    ("64x64 k=4 pop_tol 0 (an empty valid set)", 64, 64, 4, 64, 0.0, BASE,
     {}, 0),
)
# the kpair main path (bench.py --k 4's shape) and its runs at the paper's
# shape: kpair K4 and K8 at 0B263P50, 100,000 steps, 8 chains
BPAIR_MAIN = dict(grid=GRID, k=4, chains=CHAINS, tol=0.5, steps=1001)
KPAIR_RUNS = ("kpair-K4-0B263P50", "kpair-K8-0B263P50")
KPAIR_FIXTURE = dict(family="kpair", n_districts=4, grid=16, alignment=0,
                     base=BASE, pop_tol=0.5, total_steps=401,
                     checkpoint_every=200, n_chains=2, seed=0)
# the temper family: its config at the paper's shape (8 ladders of the
# 10-rung ladder), the JAX-made fixture's config, and the exact joint law
# of a 2-rung ladder on tests/test_tempered.py:139's setting
TEMPER_RUN = "temper-0B333P10R10S50"
TEMPER_FIXTURE = dict(family="temper", betas=(1.0, 0.9, 0.8), swap_every=10,
                      alignment=0, base=1 / 0.3, pop_tol=0.1,
                      total_steps=201, n_chains=2, seed=0)
TEMPER_ENUM = dict(base=3.0, betas=(1.0, 0.5), ladders=2048, steps=1201,
                   burn=600)
# Operations of the pair chunk, counted on this run's data (a floor):
#   ops = C * T * (6 * K_BLOCK + K_LTAIL) + (K_WAIT + 9 * K_PCELL) * accepted
# six threefry blocks a chain-step (the four-way split and the proposal and
# accept uniforms), the selection, accept test and record (K_LTAIL); per
# accepted move the wait (and its block) and the pair slots of the 3 x 3
# block around the flip, K_PCELL a cell: its 8 neighbours' reads and
# compares (16), the dedup of 4 directions (6), the ring criterion (12)
# and its byte (6): 40. The distinct-pair and valid counts change only
# there, so no per-cell term is in the floor.
K_PCELL = 40


def bpair_inputs(port, sampling, h: int, w: int, k: int, chains: int,
                 tol: float, base: float, spec_kw: dict, warm: int,
                 seed: int):
    """(graph, BoardGraph, spec, params, state) of an h x w k-stripe start
    on the card, advanced ``warm`` steps by the kernel itself."""
    g = port.graphs.square_grid(h, w)
    plan = port.graphs.stripes_plan(g, k)
    spec = port.Spec(n_districts=k, proposal="pair", **spec_kw)
    bg, st, params = sampling.init_board(g, plan, n_chains=chains,
                                         seed=seed, spec=spec, base=base,
                                         pop_tol=tol, device=DEVICE)
    if warm:
        st = sampling.board_runner.run_board_segment(
            bg, spec, params, st, warm, record_history=False,
            device=DEVICE).state
    return g, bg, spec, params, st


def bpair_bound(cbp, bg, spec, state, t_len: int, accepted: int):
    """(bound ms, by) of one board pair chunk: every input read once and
    every output written once (the board in and out, the per-chain fields,
    the four (T, C) rows, the two (C, N) cut planes out and, under
    parity_metrics, part_sum / last_flipped / num_flips in and out), and
    the operations of this run's data (K_PCELL above)."""
    c, n = state.board.shape
    k = spec.n_districts
    nbytes = (2 * c * n + 4 * k
              + 4 * c * (2 * 2 + 2 * k + 6 + 2 + 2 * 8)
              + 4 * 4 * t_len * c + 8 * c * n
              + (2 * 3 * 4 * c * n if spec.parity_metrics else 0))
    ops = (c * t_len * (6 * K_BLOCK + K_LTAIL)
           + (K_WAIT + K_BLOCK + 9 * K_PCELL) * accepted)
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bpair_args(cbp, bg, spec, params, st, t_len):
    static = cbp.make_static_inputs(bg, spec, params)
    key, dp, scal, ints = cbp.pack_state(st, params)
    flips = ((st.part_sum, st.last_flipped, st.num_flips)
             if spec.parity_metrics else None)
    return static, (bg, static, spec, t_len, st.board, key, dp, scal, ints,
                    flips)


def bpair_shape(cbp, n_cells: int, chains: int) -> tuple:
    """(launch shape, its text) of board_pair_chunk at ``n_cells`` and
    ``chains``: bytes a chain, chains resident an SM, the waves on this
    card, registers and spilled bytes a thread."""
    import torch
    shape = cbp.launch_shape(n_cells)
    resident = shape["chains_per_block"] * shape["blocks_per_sm"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shape["waves"] = -(-chains // (sms * resident))
    return shape, (
        f"{shape['chain_bytes']} B of shared memory a chain, "
        f"{shape['chains_per_block']} chain a block, {resident} chains "
        f"resident an SM, {shape['waves']} wave(s) on {sms} SMs, "
        f"{shape['registers']} registers a thread "
        f"({shape['spill_bytes']} B spilled), "
        f"{shape['words_per_lane']} slot words a lane")


def bpair_recounted(cbp, args, label: str) -> float:
    """The kernel once more on ``args`` with its recounts read: each
    chain's full recounts of its valid slots in the chunk, the mean
    returned; fails unless each follows an accepted move."""
    import torch
    c = args[4].shape[0]
    rec = torch.full((c,), -1, dtype=torch.int32, device=args[4].device)
    got = cbp.run_board_pair_chunk_cuda(*args, recounts=rec)
    accepted = got[4][5] - args[8][5]
    if not bool(((rec >= 0) & (rec <= accepted)).all()):
        fail(f"{label}: {rec.tolist()[:8]} recounts for "
             f"{accepted.tolist()[:8]} accepted moves")
    return float(rec.double().mean())


def bpair_tensors(args) -> list:
    """A board pair chunk's tensor inputs in ``bpair_args``'s tuple."""
    return [*args[4:9], *(args[9] or ())]


def board_pair_phase(port, cbp, cl, tb, sampling, root, card: str) -> dict:
    """Phases 20-21: board_pair_chunk against its plain version at
    BPAIR_CASES (one launch counted a call); the kpair main path
    (run_board at 64 x 64, k = 4, C=4096, chunk 500, 1001 steps) with the
    count zeroed just before and read just after, its result checks,
    flips/s, peak memory and idle share; the kernel at that path's shape
    from its final state, held to its plain version (after phase 24, in a
    worker process), timed beside its bound, its launch shape and cycles
    a step; ``bench --k 4`` as a user runs it, one repeat; the 3 x 3 grid
    at k = 3 on the board route against the pair chain's exact law."""
    import numpy as np
    import torch
    err = 0.0
    cases = {}
    for i, (label, h, w, k, c, tol, base, kw, warm) in enumerate(
            BPAIR_CASES):
        g, bg, spec, params, st = bpair_inputs(port, sampling, h, w, k, c,
                                               tol, base, kw, warm, 40 + i)
        _, args = bpair_args(cbp, bg, spec, params, st, BPAIR_T)
        kept = [x.clone() for x in bpair_tensors(args)]
        n0 = cbp.run_board_pair_chunk_cuda.launches
        got = cbp.run_board_pair_chunk_cuda(*args)
        torch.cuda.synchronize()
        if cbp.run_board_pair_chunk_cuda.launches != n0 + 1:
            fail(f"board_pair_chunk {label}: the wrapper did not count its "
                 "launch")
        if not all(torch.equal(x, y)
                   for x, y in zip(bpair_tensors(args), kept)):
            fail(f"board_pair_chunk {label}: the kernel changed an input")
        if len(got) != (13 if spec.parity_metrics else 10):
            fail(f"board_pair_chunk {label}: {len(got)} outputs")
        t0 = time.perf_counter()
        want = cbp.board_pair_chunk_reference(*args)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max(err, compare_lowered(
            cbp, got, want, f"board_pair_chunk {label} C={c} T={BPAIR_T} "
            f"(plain {plain_s:.3f} s)"))
        accepted = int((got[4][5] - args[8][5]).sum())
        if "empty" in label and accepted:
            fail(f"board_pair_chunk {label}: {accepted} moves accepted")
        if "empty" not in label and not accepted:
            fail(f"board_pair_chunk {label}: no move accepted")
        recounts = bpair_recounted(cbp, args, label)
        if "bind" in label and not recounts:
            fail(f"board_pair_chunk {label}: no recount where gates bind")
        shape, text = bpair_shape(cbp, bg.n, c)
        print(f"board_pair_chunk {label} C={c}: {text}; {recounts:.3f} "
              f"full recounts a chain in the {BPAIR_T}-step chunk "
              f"({accepted / c:.3f} accepted moves a chain)")
        cases[label] = {"chains": c, "chunk": BPAIR_T, "accepted": accepted,
                        "plain_s": plain_s, "recounts": recounts,
                        "shape": shape}

    # ---- the kpair main path through run_board -------------------------
    m, k, c = BPAIR_MAIN["grid"], BPAIR_MAIN["k"], BPAIR_MAIN["chains"]
    steps = BPAIR_MAIN["steps"]
    g, bg, spec, params, st = bpair_inputs(port, sampling, m, m, k, c,
                                           BPAIR_MAIN["tol"], BASE, {}, 0, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cbp.run_board_pair_chunk_cuda.launches = 0
    cl.run_lowered_chunk_cuda.launches = 0
    with count_calls((cbp, tb), "apply_flip_log") as flip_calls:
        t0 = time.perf_counter()
        res = sampling.run_board(bg, spec, params, st, n_steps=steps,
                                 chunk=CHUNK, record_history=False,
                                 device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = cbp.run_board_pair_chunk_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    chunks = -(-(steps - 1) // CHUNK)
    if launches != chunks or cl.run_lowered_chunk_cuda.launches:
        fail(f"kpair main path: board_pair_chunk launched {launches} times "
             f"for {chunks} chunks (lowered_chunk "
             f"{cl.run_lowered_chunk_cuda.launches})")
    # the kernel closes the flip log's runs: only the final record's
    # one-yield log is replayed
    if len(flip_calls) != 1:
        fail(f"kpair main path: apply_flip_log ran {len(flip_calls)} times "
             "(the final record's once expected)")
    fs = res.state
    if not torch.equal(fs.cut_count, tb.recount_cuts(bg, fs.board)):
        fail("kpair main path: cut_count disagrees with a recount")
    pops = torch.stack([(fs.board == d).sum(dim=1) for d in range(k)], 1)
    if not torch.equal(pops.to(torch.int32), fs.dist_pop):
        fail("kpair main path: dist_pop disagrees with a recount")
    boards = fs.board[:16].cpu().numpy()
    if not all(graph_connected(g, b, k) for b in boards):
        fail("kpair main path: a sampled chain has a disconnected district")
    fps = c * (steps - 1) / wall
    prof = idle_share(lambda: sampling.run_board(
        bg, spec, params, fs, n_steps=steps, chunk=CHUNK,
        record_history=False, device=DEVICE),
        counted=("board_pair_chunk", cbp.run_board_pair_chunk_cuda))
    rate = fs.accept_count.double().mean().item() / (steps - 1)
    print(f"[{card}] kpair main path: run_board on the {m}x{m} rook grid, "
          f"k={k}, {c} chains x {steps} steps in {wall:.3f} s, {fps:.6e} "
          f"flips/s (accept rate {rate:.4f}); board_pair_chunk launches "
          f"{launches} for {chunks} chunks; apply_flip_log calls "
          f"{len(flip_calls)} (the final record's); peak memory "
          f"{peak / 2 ** 20:.1f} MiB; cut_count and dist_pop equal to "
          f"recounts, {len(boards)} chains' districts connected; profile: "
          f"{prof}")

    # ---- the kernel at the main path's shape ----------------------------
    static, args = bpair_args(cbp, bg, spec, params, fs, CHUNK)
    got = cbp.run_board_pair_chunk_cuda(*args)
    ms = event_ms(lambda: cbp.run_board_pair_chunk_cuda(*args), 3)
    accepted = int((got[4][5] - args[8][5]).sum())
    bound_ms, bound_by = bpair_bound(cbp, bg, spec, fs, CHUNK, accepted)
    recounts = bpair_recounted(cbp, args, "board_pair_chunk main-path shape")
    shape, text = bpair_shape(cbp, bg.n, c)
    mhz = sm_mhz(clocks_under_load(
        lambda: cbp.run_board_pair_chunk_cuda(*args), max(20, int(400 / ms))))
    cyc = ms * 1e3 * mhz / CHUNK if mhz else None
    main = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "accepted": accepted, "shape": shape, "cycles_per_step": cyc,
            "sm_mhz": mhz, "recounts": recounts}
    print(f"board_pair_chunk main-path shape (C={c}, T={CHUNK}, {bg.n} "
          f"cells, k={k}, {accepted} accepted moves, parity_metrics on): "
          f"{ms:.4f} ms per chunk (CUDA events, mean of 3); bound "
          f"{bound_ms:.4e} ms ({bound_by}); {text}; {recounts:.3f} full "
          "recounts a chain in the chunk; "
          + (f"{cyc:.1f} cycles a chain-step at {mhz:.0f} MHz" if cyc else
             "cycles a step not measured (no SM clock read)"))

    def check(want, secs):
        main["plain_ms"] = 1e3 * secs
        return compare_lowered(cbp, got, want, f"board_pair_chunk main-path "
                               f"shape C={c} T={CHUNK} (plain {secs:.3f} s, "
                               "host clock)")
    # held after phase 24 (plain_jobs)
    hold_plain("board_pair_chunk", cbp.board_pair_chunk_reference, args,
               check, defer=True)

    # ---- bench --k 4 as a user runs it, one repeat ----------------------
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m",
                          "flipcomplexityempirical_tpu_torch.bench", "--k",
                          "4", "--repeats", "1"], cwd=root,
                         capture_output=True, text=True, timeout=600)
    bwall = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"bench --k 4 exited {out.returncode}:\n{out.stderr}")
    lines = out.stdout.strip().splitlines()
    head, meta = json.loads(lines[-1]), last_json(out.stderr)
    want_head = {"metric": "flips_per_sec_per_chip_64x64_pair_k4",
                 "unit": "flips/s", "device": torch.cuda.get_device_name(0),
                 "kernel_path": "bitboard", "kernel": "board_pair_chunk",
                 "repeat_policy": "best"}
    if (len(lines) != 1 or {key: head.get(key) for key in want_head}
            != want_head or not head["value"] > 0):
        fail(f"bench --k 4: headline {head}, expected {want_head}")
    if meta["launches"] != (STEPS - 1) // CHUNK or meta["chains"] != CHAINS:
        fail(f"bench --k 4: {meta['launches']} launches at "
             f"{meta['chains']} chains")
    print(f"bench --k 4 ({bwall:.3f} s wall; 1 repeat of {STEPS} timed "
          f"steps): {lines[-1]}")
    print(f"bench --k 4 meta: {json.dumps(meta)}")

    # ---- the 3 x 3 grid at k = 3 on the board route --------------------
    stationary = kpair_stationary(port, sampling)
    return {"launches": launches, "max_abs_err": err, "cases": cases,
            "main_shape": main,
            "main_path": {"flips_per_s": fps, "wall_s": wall,
                          "peak_mib": peak / 2 ** 20, "profile": prof,
                          "accept_rate": rate},
            "bench": {**head, "chains": meta["chains"],
                      "seconds": meta["seconds"],
                      "accept_rate": meta["accept_rate"]},
            "stationary": stationary}


def kpair_stationary(port, sampling) -> dict:
    """The board pair kernel's chains on the 3 x 3 grid at k = 3 against
    the pair chain's exact law (``_torch_enumeration.
    build_pair_transition``, its lazy iteration): en.CHAINS chains,
    PAIR_ENUM_BURN steps, then en.SAMPLES one-step segments pooled; phase
    13's bars, as phase 18 holds the general pair kernel."""
    import numpy as np
    import torch
    import _torch_enumeration as en
    from flipcomplexityempirical_tpu_torch.sampling.runner import pop_bounds
    label, _, k, base, tol, _ = PAIR_ENUM[0]
    g = port.graphs.square_grid(3, 3)
    plan = port.graphs.stripes_plan(g, k)
    lo, hi = pop_bounds(g, k, tol)
    states, P, cuts = en.build_pair_transition(g, plan, k, base, lo, hi)
    pi = en.stationary_lazy(P)
    spec = port.Spec(n_districts=k, proposal="pair")
    bg, st, params = sampling.init_board(g, plan, n_chains=en.CHAINS,
                                         seed=320, spec=spec, base=base,
                                         pop_tol=tol, device=DEVICE)
    seg = sampling.board_runner.run_board_segment
    t0 = time.perf_counter()
    st = seg(bg, spec, params, st, PAIR_ENUM_BURN, record_history=False,
             device=DEVICE).state
    boards = []
    for _ in range(en.SAMPLES):
        st = seg(bg, spec, params, st, 1, record_history=False,
                 device=DEVICE).state
        boards.append(st.board)
    rows = torch.cat(boards).cpu().numpy()
    chain = np.tile(np.arange(en.CHAINS), len(boards))
    try:
        tv, cut_err, t = en.pair_pool_check(rows, chain, states, pi, cuts)
    except KeyError as exc:
        fail(f"board pair {label}: a chain left the closure ({exc})")
    t_max = float(np.abs(t).max())
    print(f"stationary board_pair {label} base {base}: TV {tv:.6f}, E|cut| "
          f"relative error {cut_err:.6f}, t of E|cut| {t[0]:.3f}, max |t| "
          f"{t_max:.3f} over E|cut| and the 9 nodes' mean districts "
          f"({len(rows)} boards of {len(states)} states, {en.CHAINS} chains "
          f"x {en.SAMPLES} steps after {PAIR_ENUM_BURN}; "
          f"{time.perf_counter() - t0:.3f} s)")
    if tv >= en.TV_POOL_TOL or cut_err >= en.CUT_TOL or not t_max < en.T_TOL:
        fail(f"board pair {label}: TV {tv:.4f} (bar {en.TV_POOL_TOL}), "
             f"E|cut| error {cut_err:.4f} (bar {en.CUT_TOL}) or max |t| "
             f"{t_max:.2f} (bar {en.T_TOL})")
    return {"tv": tv, "cut_err": cut_err, "t_cut": float(t[0]),
            "t_max": t_max, "states": len(states)}


def fixture_matches(ex, drv, which: str, kw: dict, out_dir: str,
                    waits: str) -> int:
    """The card's run_config of a JAX-made fixture's config against the
    fixture under ``_parity``'s wait rule ``waits`` (the one the fixture's
    CPU test uses); the waits off by a log tie."""
    import os

    import numpy as np
    import _parity
    fx = dict(np.load(ROOT / "tests" / "fixtures" / "torch" /
                      f"experiment_{which}.npz"))
    cfg = ex.ExperimentConfig(**kw)
    fdir = os.path.join(out_dir, f"fixture_{which}")
    data = drv.run_config(cfg, fdir, device=DEVICE)
    got = _parity.experiment_arrays(data, open(os.path.join(
        fdir, cfg.tag + "wait.txt")).read())
    try:
        ties = _parity.assert_experiment_matches(got, fx, waits=waits)
    except AssertionError as exc:
        fail(f"fixture {which}: {exc}")
    print(f"fixture ({which}: the JAX package's run_config, {cfg.tag}, "
          f"{cfg.total_steps} steps, {cfg.n_chains} chains): equal in every "
          f"array and artifact text; waits off by a log tie {ties}")
    return ties


def config_run(ex, drv, cfg, out_dir: str, wrapper, chunks: int,
               card: str) -> tuple:
    """run_config of ``cfg`` on the card, the kernel's count zeroed just
    before and read just after (it must equal ``chunks``), every artifact
    checked: (data, its record)."""
    import os

    import torch
    wrapper.launches = 0
    t0 = time.perf_counter()
    data = drv.run_config(cfg, out_dir, device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if wrapper.launches != chunks:
        fail(f"{cfg.tag}: {wrapper.launches} launches for {chunks} chunks")
    kinds = drv.artifact_kinds(cfg.family)
    n_art = sum(os.path.exists(os.path.join(out_dir, cfg.tag + a))
                for a in kinds)
    if n_art != len(kinds) or not ex.is_done(cfg, out_dir):
        fail(f"{cfg.tag}: {n_art} of {len(kinds)} artifacts written")
    setup = wall - data["seconds"] - data["render_seconds"]
    print(f"[{card}] run_config {cfg.family} {cfg.tag} ({cfg.total_steps} "
          f"steps, {cfg.n_chains} {'ladders' if cfg.betas else 'chains'}): "
          f"{wall:.3f} s wall, run {data['seconds']:.3f} s, render "
          f"{data['render_seconds']:.3f} s, set-up {setup:.3f} s; "
          f"{wrapper.__name__.replace('run_', '').replace('_cuda', '')} "
          f"launches {wrapper.launches} for {chunks} chunks; {n_art} "
          "artifacts")
    return data, {"wall_s": wall, "run_s": data["seconds"],
                  "render_s": data["render_seconds"], "setup_s": setup,
                  "launches": wrapper.launches, "chunks": chunks}


def kpair_runs(ex, drv, cbp, sampling, out_dir: str, card: str) -> dict:
    """Phase 22: the kernel at the experiment path's shape (kpair K4's
    start, C=8, one pick_chunk(100000, 512) = 369-step chunk), timed, and
    held to its plain version (after phase 24); run_config for KPAIR_RUNS
    at the paper's shape
    (100,000 steps, 8 chains): one launch a chunk, seconds split, every
    artifact, each chain's cut_count against a recount and its districts
    connected; the card's 401-step run equal to experiment_kpair.npz."""
    import os

    import numpy as np
    import torch
    out = {}
    for tag in KPAIR_RUNS:
        cfg = experiment_config(ex, "kpair", tag, total_steps=EXP_STEPS,
                                n_chains=EXP_CHAINS)
        if tag == KPAIR_RUNS[0]:
            g, plan, _ = drv.build_graph_and_plan(cfg)
            spec = drv.spec_for(cfg)
            _, (bg, st, params) = drv._init_run(cfg, g, plan, spec, DEVICE)
            t_len = sampling.runner.pick_chunk(EXP_STEPS, 512)
            _, args = bpair_args(cbp, bg, spec, params, st, t_len)
            n0 = cbp.run_board_pair_chunk_cuda.launches
            got = cbp.run_board_pair_chunk_cuda(*args)
            if cbp.run_board_pair_chunk_cuda.launches != n0 + 1:
                fail("board_pair_chunk experiment shape: the wrapper did not "
                     "count its launch")
            ms = event_ms(lambda: cbp.run_board_pair_chunk_cuda(*args), 3)
            accepted = int((got[4][5] - args[8][5]).sum())
            bound_ms, bound_by = bpair_bound(cbp, bg, spec, st, t_len,
                                             accepted)
            recounts = bpair_recounted(cbp, args, "board_pair_chunk "
                                       "experiment shape")
            _, text = bpair_shape(cbp, bg.n, EXP_CHAINS)
            print(f"board_pair_chunk experiment shape (C={EXP_CHAINS}, "
                  f"T={t_len}, parity_metrics on): {ms:.4f} ms per chunk "
                  f"(CUDA events, mean of 3); bound {bound_ms:.4e} ms "
                  f"({bound_by}); {text}; {recounts:.3f} full recounts a "
                  "chain in the chunk")
            exp = out["experiment_shape"] = {"ms": ms, "bound_ms": bound_ms,
                                             "bound_by": bound_by,
                                             "recounts": recounts}

            def check(want, secs, got=got, exp=exp, label=(
                    f"board_pair_chunk experiment {tag} start C={EXP_CHAINS} "
                    f"T={t_len}")):
                exp["plain_ms"] = 1e3 * secs
                return compare_lowered(cbp, got, want, f"{label} (plain "
                                       f"{secs:.3f} s, host clock)")
            # held after phase 24 (plain_jobs), host-bound at ~20 ms a step
            hold_plain("board_pair_chunk", cbp.board_pair_chunk_reference,
                       args, check, defer=True)
        chunks = expected_chunks(sampling.runner, cfg)
        data, rec = config_run(ex, drv, cfg, os.path.join(out_dir, "runs"),
                               cbp.run_board_pair_chunk_cuda, chunks, card)
        g, _, _ = drv.build_graph_and_plan(cfg)
        a = np.asarray(data["assignments"]).astype(np.int64)
        recount = (a[:, g.edges[:, 0]] != a[:, g.edges[:, 1]]).sum(axis=1)
        if not np.array_equal(recount, data["state"]["cut_count"]):
            fail(f"{tag}: cut_count disagrees with a recount")
        if not all(graph_connected(g, row, cfg.n_districts) for row in a):
            fail(f"{tag}: a chain has a disconnected district")
        out[tag] = rec
    out["fixture_ties"] = fixture_matches(ex, drv, "kpair", KPAIR_FIXTURE,
                                          out_dir, waits="scaled_ulps")
    return out


def temper_phase(ex, drv, cl, sampling, out_dir: str, card: str) -> dict:
    """Phase 23: run_config for TEMPER_RUN at the paper's shape (8 ladders
    x 10 rungs, 100,000 steps, a swap round every 50 transitions), the
    lowered_chunk count zeroed just before and read just after (one
    launch a round): seconds split, the swap rate of each adjacent rung
    pair, rungs.png and every artifact; the swap round's wall ms
    (swap_within_batch and the host's rung bookkeeping) at that batch;
    lowered_chunk at that batch (C=80, one swap_every-step chunk) from the
    state and permuted betas of three swap rounds, timed beside its bound,
    and held to its plain version (after the phase, in plain_jobs); the
    card's 201-step run equal to experiment_temper.npz; each rung's
    cut-count law against the exact joint tempered law on the 3 x 4 grid
    (beta 1.0 / 0.5, base 3, a round after every transition, many
    ladders), phase 13's bars."""
    import os

    import numpy as np
    import torch
    import _torch_enumeration as en
    from flipcomplexityempirical_tpu_torch import rng
    from flipcomplexityempirical_tpu_torch.kernel import board as tb
    from flipcomplexityempirical_tpu_torch.sampling import tempered as ttd
    from flipcomplexityempirical_tpu_torch.sampling import tempering as tt
    cfg = experiment_config(ex, "temper", TEMPER_RUN, total_steps=EXP_STEPS,
                            n_chains=EXP_CHAINS)
    rounds = -(-(EXP_STEPS - 1) // cfg.swap_every)
    data, rec = config_run(ex, drv, cfg, os.path.join(out_dir, "runs"),
                           cl.run_lowered_chunk_cuda, rounds, card)
    rates = data["swapstats"]["rates"]
    print(f"[{card}] temper {TEMPER_RUN}: swap rates of the adjacent rung "
          f"pairs (coldest first) "
          + ", ".join(f"{r:.4f}" for r in rates)
          + f"; cold-rung chain's wait total {data['waits_sum']:.6e}")
    if len(rates) != len(cfg.betas) - 1 or not min(rates) > 0:
        fail(f"temper {TEMPER_RUN}: swap rates {rates}")
    rec["swap_rates"] = rates
    # the swap round at that batch: C = 80 chains
    g, plan, _ = drv.build_graph_and_plan(cfg)
    spec = drv.spec_for(cfg)
    _, (bg, st, params0) = drv._init_run(cfg, g, plan, spec, DEVICE)
    params = params0
    key = rng.prng_key(1, device=DEVICE)
    reps = 200
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        ttd._host_rungs(params.beta.cpu().numpy(), len(cfg.betas))
        params, acc = tt.swap_within_batch(key, st, params, len(cfg.betas),
                                           i % 2, spec=spec)
        acc.cpu()
    swap_ms = 1e3 * (time.perf_counter() - t0) / reps
    print(f"[{card}] swap_within_batch (torch ops) with the host's rung "
          f"bookkeeping, C={st.cut_count.shape[0]}: {swap_ms:.4f} ms wall a "
          f"round (mean of {reps}, host clock)")
    rec["swap_round_ms"] = swap_ms
    # lowered_chunk at the temper path's shape (C = 80, a T = swap_every
    # chunk) with the per-chain betas as a few swap rounds leave them
    mid = ttd.run_tempered(bg, spec, params0, st,
                           n_steps=4 * cfg.swap_every + 1, betas=cfg.betas,
                           n_ladders=EXP_CHAINS, swap_every=cfg.swap_every,
                           swap_seed=cfg.seed, record_history=False)
    if not mid.swap_accepts.sum():
        fail(f"temper {TEMPER_RUN}: no swap accepted in 3 rounds")
    ins = cl.pack_state(mid.state, mid.params)
    args = (bg, cl.make_static_inputs(bg, spec, mid.params), spec,
            cfg.swap_every, mid.state.board, *ins)
    n0 = cl.run_lowered_chunk_cuda.launches
    got = cl.run_lowered_chunk_cuda(*args)
    torch.cuda.synchronize()
    if cl.run_lowered_chunk_cuda.launches != n0 + 1:
        fail("lowered_chunk temper shape: the wrapper did not count its "
             "launch")
    ms = event_ms(lambda: cl.run_lowered_chunk_cuda(*args), 20)
    kern = rec["kernel"] = {"chains": int(st.cut_count.shape[0]),
                            "chunk": cfg.swap_every, "ms": ms,
                            "betas": len(set(
                                mid.params.beta.cpu().tolist()))}
    kern["bound_ms"], kern["bound_by"] = lowered_bound(
        tb, cl, bg, spec, args[1], mid.state.board, ins, got,
        f"temper {TEMPER_RUN}")
    print(f"lowered_chunk temper shape (C={kern['chains']}, "
          f"T={cfg.swap_every}, {kern['betas']} betas permuted by "
          f"{int(mid.swap_accepts.sum())} accepted swaps): {ms:.4f} ms per "
          f"chunk (CUDA events, mean of 20); bound {kern['bound_ms']:.4e} "
          f"ms ({kern['bound_by']})")

    def check(want, secs):
        kern["plain_ms"] = 1e3 * secs
        kern["max_abs_err"] = compare_lowered(
            cl, got, want, f"lowered_chunk temper {TEMPER_RUN} after 3 swap "
            f"rounds C={kern['chains']} T={cfg.swap_every} (plain "
            f"{secs:.3f} s, host clock)")
        return kern["max_abs_err"]
    # held after phase 24 (plain_jobs)
    hold_plain("lowered_chunk", cl.lowered_chunk_reference, args, check,
               defer=True)
    rec["fixture_ties"] = fixture_matches(ex, drv, "temper", TEMPER_FIXTURE,
                                          out_dir, waits="unit")
    # the exact joint law of a 2-rung ladder on the 3 x 4 grid
    e = TEMPER_ENUM
    b1, b2 = e["betas"]
    gg, nbrmask = en.build_masks()
    states = en.enumerate_states(nbrmask)
    P1, cuts = en.build_transition(states, gg, e["base"] ** b1)
    P2, _ = en.build_transition(states, gg, e["base"] ** b2)
    avg = en.joint_tempered_stationary(P1, P2, cuts.astype(np.float64),
                                       np.log(e["base"]), b1, b2)
    import flipcomplexityempirical_tpu_torch as port
    sspec = port.Spec(contiguity="patch", geom_waits=False,
                      parity_metrics=False)
    h, st2, par2 = ttd.init_tempered(
        gg, port.graphs.stripes_plan(gg, 2), betas=[b1, b2],
        n_ladders=e["ladders"], seed=11, spec=sspec, base=e["base"],
        pop_tol=en.EPS, device=DEVICE)
    t0 = time.perf_counter()
    res = ttd.run_tempered(h, sspec, par2, st2, n_steps=e["steps"],
                           betas=[b1, b2], n_ladders=e["ladders"],
                           swap_every=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rung = ttd.per_rung_history(res, "cut_count")
    laws = {}
    for r, pi in ((0, avg.sum(axis=1)), (1, avg.sum(axis=0))):
        try:
            tv, cut_err, t = en.cut_law_check(rung[r][:, e["burn"]:], pi,
                                              cuts)
        except KeyError as exc:
            fail(f"tempered rung {r}: {exc}")
        print(f"stationary tempered rung beta={e['betas'][r]} (3x4 grid, "
              f"base {e['base']}, {e['ladders']} ladders of 2 rungs, a swap "
              f"round after every transition, swap rate "
              f"{res.swap_rates()[0]:.4f}, {e['steps'] - e['burn']} recorded "
              f"steps after {e['burn']}; {secs:.3f} s): cut-count law TV "
              f"{tv:.6f}, E|cut| relative error {cut_err:.6f}, t of E|cut| "
              f"{t:.3f}")
        if tv >= en.TV_POOL_TOL or cut_err >= en.CUT_TOL or \
                not abs(t) < en.T_TOL:
            fail(f"tempered rung {r}: TV {tv:.4f} (bar {en.TV_POOL_TOL}), "
                 f"E|cut| error {cut_err:.4f} (bar {en.CUT_TOL}) or |t| "
                 f"{abs(t):.2f} (bar {en.T_TOL})")
        laws[f"beta={e['betas'][r]}"] = {"tv": tv, "cut_err": cut_err,
                                          "t_cut": t}
    rec["stationary"] = laws
    return rec


# ---------------------------------------------------------------------------
# ReCom (phase 24): the spanning-tree recombination chain on its kernel,
# recom_chunk.cu, through run_recom, the driver and the fixtures
# ---------------------------------------------------------------------------

# the kpair family's grid at the JAX catalog's recom-grid overrides
# (workloads/catalog.py:76-86): k = 4, base 1.0, pop_tol 0.25 (= epsilon)
RECOM_GRID, RECOM_K, RECOM_TOL = 64, 4, 0.25
RECOM_C, RECOM_T, RECOM_STEPS = 1024, 32, 65
RECOM_PLAIN_T = 2
RECOM_RUN = dict(family="kpair", chain="recom", n_districts=4, grid=64,
                 alignment=0, base=1.0, pop_tol=0.25, total_steps=1000,
                 n_chains=8, seed=0)
# the kernel against its plain version: (label, graph, k, pop_tol, chains,
# T, tree_retries, epsilon)
RECOM_CASES = (("64x64 k=4", "grid64", 4, 0.25, 64, 16, 4, None),
               ("32x32 k=4", "grid32", 4, 0.25, 16, 16, 4, None),
               ("8x8 k=2", "grid8", 2, 0.25, 32, 32, 4, None),
               ("dual fixture k=4", "dual", 4, 0.4, 16, 16, 4, None),
               ("6x6 k=2 eps 0.06, one attempt", "grid6", 2, 0.06, 64, 16,
                1, 0.06))
RECOM_FIXTURES = {
    "recom": dict(family="kpair", chain="recom", n_districts=4, grid=32,
                  alignment=0, base=1.0, pop_tol=0.25, total_steps=41,
                  checkpoint_every=20, n_chains=2, seed=0),
    "recom_dual": dict(family="dual", chain="recom", n_districts=4,
                       dual_source="fixture", alignment=0, base=1.0,
                       pop_tol=0.4, total_steps=31, n_chains=2, seed=0)}
# Operations a ReCom chunk needs, counted on this run's data (a floor):
# each tree attempt draws the ranks (rounds * E threefry blocks, K_BLOCK
# each, and 8 radix passes of K_RADIX a key a round), one Boruvka round at
# least (two passes over the edges, K_REDGE an edge) and a BFS over the
# nodes' slots (K_RSLOT a slot); each committed move recounts the cut over
# the edges (K_REDGE) and the pairs over the slots (K_RSLOT) and draws its
# wait (K_WAIT). Attempts: one a committed move, tree_retries an exhausted
# one. K_RADIX: the digit (2), its count (2), the scan's share (2), the
# scatter's offset and two stores (4): 10. K_REDGE: two endpoint loads,
# the member test and the component compare (5). K_RSLOT: the mask, the
# tree bit and the depth test (4).
K_RADIX, K_REDGE, K_RSLOT = 10, 5, 4


def recom_graph(port, which: str):
    """The graph of a phase-24 case: the dual fixture map or an n x n
    rook grid ('gridN')."""
    if which == "dual":
        from flipcomplexityempirical_tpu_torch.workloads.data import (
            load_fixture)
        g, _ = port.graphs.from_geojson(load_fixture(), pop_property="POP")
        return g
    return port.graphs.square_grid(int(which[4:]))


def recom_inputs(port, cr, sampling, g, k: int, tol: float, chains: int,
                 seed: int, warm: int = 0, eps=None, retries: int = 4):
    """A ReCom batch on the card, advanced by ``warm`` kernel moves:
    (dg, spec, params, state, kw)."""
    spec = port.Spec(n_districts=k, proposal="pair" if k > 2 else "bi")
    dg, st, params = sampling.init_batch(
        g, port.graphs.stripes_plan(g, k), n_chains=chains, seed=seed,
        spec=spec, base=1.0, pop_tol=tol, device=DEVICE)
    kw = dict(epsilon=tol if eps is None else eps,
              pop_target=float(g.pop.sum()) / k, tree_retries=retries)
    if warm:
        st, _ = cr.run_recom_chunk_cuda(dg, None, spec, params, st, warm,
                                        **kw)
    return dg, spec, params, st, kw


def recom_equal(got, rows, want, wrows, label: str) -> float:
    """Every state field and row of a kernel launch bit-equal to its plain
    version's, the waits and the float fields included: both run on the
    card and take CUDA's logf, so no log tie is expected and any
    difference fails. Returns the largest |difference| over them all."""
    import dataclasses

    import torch
    if sorted(rows) != sorted(wrows):
        fail(f"recom_chunk {label}: rows {sorted(rows)} vs {sorted(wrows)}")
    pairs = [(f"row {name}", rows[name], wrows[name]) for name in rows]
    pairs += [(f, getattr(got, f).to(v.dtype), v)
              for f, v in dataclasses.asdict(want).items()
              if isinstance(v, torch.Tensor)]
    err = 0.0
    for name, g, w in pairs:
        if g.shape != w.shape:
            fail(f"recom_chunk {label}: {name} shape {tuple(g.shape)} vs "
                 f"{tuple(w.shape)}")
        d = (g.double() - w.double()).abs()
        big = float(d.max()) if d.numel() else 0.0
        err = max(err, big)
        if not torch.equal(g, w):
            fail(f"recom_chunk {label}: {name} differs from the plain "
                 f"version in {int((g != w).sum())} places (largest "
                 f"|difference| {big})")
    return err


def recom_bound(dg, chains: int, t_len: int, accepted: int,
                exhausted: int, retries: int, k: int) -> tuple:
    """(bound ms, 'bytes' or 'operations', bytes, operations) of one
    chunk: each input read once, each output written once, and the
    operations above for this run's attempts."""
    from flipcomplexityempirical_tpu_torch import rng
    n, e, d = dg.n_nodes, dg.n_edges, dg.max_deg
    per_chain = (2 * n                        # assignment in, out
                 + 2 * 3 * 4 * n              # part_sum, last_flipped,
                 + 2 * 4 * e                  # num_flips, cut_times in, out
                 + e + n + 4 * k              # cut, cut_deg, dist_pop out
                 + 2 * (8 + 8 + 32)           # key, scal, ints in, out
                 + 4 * 4 * t_len)             # four (T, C) rows
    nbytes = chains * per_chain + 8 * e + 4 * n + 9 * n * d
    attempts = accepted + retries * exhausted
    per_attempt = (rng.permutation_rounds(e) * e * (K_BLOCK + 8 * K_RADIX)
                   + 2 * K_REDGE * e + K_RSLOT * n * d)
    per_commit = K_REDGE * e + K_RSLOT * n * d + K_WAIT
    ops = attempts * per_attempt + accepted * per_commit
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes
            else "bytes", nbytes, ops)


def recom_tree_levels(dg, st, n_chains: int) -> list:
    """The BFS levels of the spanning tree that each of the first
    ``n_chains`` chains draws in its next move's first attempt: that
    move's cut edge, merged pair and tree keys, through the plain bodies
    (``sampling/recom.py``), which draw the kernel's trees."""
    import torch
    from flipcomplexityempirical_tpu_torch import rng
    from flipcomplexityempirical_tpu_torch.sampling import recom
    st = st.replace(**{f: getattr(st, f)[:n_chains] for f in (
        "key", "assignment", "cut")})
    ks = rng.split(st.key, 4)
    u = rng.uniform_n(ks[:, 1], dg.n_edges)
    e_star = torch.argmax(torch.where(st.cut > 0, u, -1.0), dim=1)
    a = st.assignment.long()
    cr_ = torch.arange(n_chains, device=a.device)
    root = dg.edges[e_star, 0]
    d1, d2 = a[cr_, root], a[cr_, dg.edges[e_star, 1]]
    member = (a == d1[:, None]) | (a == d2[:, None])
    k_tree = rng.split(rng.split(ks[:, 2], 2)[:, 1], 2)[:, 0]
    in_tree = recom.spanning_forest(dg, member, k_tree)
    _, depth = recom.tree_structure(dg, in_tree, member, root)
    return (depth.max(dim=1).values + 1).tolist()


def recom_phase(port, ex, drv, sampling, out_dir: str, card: str) -> dict:
    """Phase 24: (a) recom_chunk against its plain version at
    RECOM_CASES, from states the kernel advanced first, one launch counted
    a call; (b) the kernel at C=1024, T=32 on 64x64 timed beside its bound,
    its launch shape, and the plain version at C=1024, T=2; (c) run_recom
    at that shape, 65 steps, the count zeroed just before and read just
    after: moves/s, peak memory, the idle share, the invariants; (d)
    run_config of RECOM_RUN: one launch a chunk, seconds split, every
    artifact; (e) the card's runs of the JAX-made fixtures."""
    import os

    import numpy as np
    import torch
    from flipcomplexityempirical_tpu_torch.kernel import cuda_recom as cr
    from flipcomplexityempirical_tpu_torch.sampling import recom
    from flipcomplexityempirical_tpu_torch.state.chain_state import derive
    t_phase = time.perf_counter()
    out = {"cases": []}
    err = 0.0
    # (a) the kernel against its plain version
    for label, which, k, tol, chains, t_len, retries, eps in RECOM_CASES:
        g = recom_graph(port, which)
        dg, spec, params, st, kw = recom_inputs(
            port, cr, sampling, g, k, tol, chains, 3, t_len, eps, retries)
        smem = cr.launch_shape(dg, chains)["smem_bytes"]
        if cr.smem_bytes(dg.n_nodes, dg.n_edges) != smem:
            fail(f"recom_chunk {label}: the wrapper's smem_bytes "
                 f"{cr.smem_bytes(dg.n_nodes, dg.n_edges)} vs the kernel's "
                 f"layout {smem}")
        n0 = cr.run_recom_chunk_cuda.launches
        got, rows = cr.run_recom_chunk_cuda(dg, None, spec, params, st,
                                            t_len, **kw)
        torch.cuda.synchronize()
        if cr.run_recom_chunk_cuda.launches != n0 + 1:
            fail(f"recom_chunk {label}: the wrapper did not count its launch")
        t0 = time.perf_counter()
        want, wrows = recom.recom_chunk_reference(dg, spec, params, st,
                                                  t_len, **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        case_err = recom_equal(got, rows, want, wrows, label)
        err = max(err, case_err)
        acc = int((got.accept_count - st.accept_count).sum())
        exh = int((got.exhausted_count - st.exhausted_count).sum())
        if acc == 0:
            fail(f"recom_chunk {label}: no move committed")
        if retries == 1 and exh == 0:
            fail(f"recom_chunk {label}: no move exhausted its one attempt")
        print(f"[{card}] recom_chunk {label} (C={chains}, T={t_len}, "
              f"tree_retries {retries}, from a state the kernel advanced "
              f"{t_len} moves): bit-equal to the plain version, every state "
              f"field and row, waits included (largest |difference| "
              f"{case_err}); {smem} B shared memory a block, equal to "
              f"smem_bytes; {acc} moves "
              f"committed, {exh} exhausted; plain {plain_s:.3f} s (host "
              "clock)")
        out["cases"].append({"case": label, "chains": chains, "t": t_len,
                             "committed": acc, "exhausted": exh,
                             "max_abs_err": case_err,
                             "smem_bytes": smem})
    # (b) the kernel timed at the throughput shape
    g = port.graphs.square_grid(RECOM_GRID)
    dg, spec, params, st, kw = recom_inputs(port, cr, sampling, g, RECOM_K,
                                            RECOM_TOL, RECOM_C, 0,
                                            RECOM_PLAIN_T)
    shape = cr.launch_shape(dg, RECOM_C)
    got, _ = cr.run_recom_chunk_cuda(dg, None, spec, params, st, RECOM_T,
                                     **kw)
    ms = event_ms(lambda: cr.run_recom_chunk_cuda(dg, None, spec, params,
                                                  st, RECOM_T, **kw), 3)
    accepted = int((got.accept_count - st.accept_count).sum())
    exhausted = int((got.exhausted_count - st.exhausted_count).sum())
    bound_ms, bound_by, nbytes, ops = recom_bound(
        dg, RECOM_C, RECOM_T, accepted, exhausted, kw["tree_retries"],
        RECOM_K)
    ms_short = event_ms(lambda: cr.run_recom_chunk_cuda(
        dg, None, spec, params, st, RECOM_PLAIN_T, **kw), 3)
    short, srows = cr.run_recom_chunk_cuda(dg, None, spec, params, st,
                                           RECOM_PLAIN_T, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, wrows = recom.recom_chunk_reference(dg, spec, params, st,
                                              RECOM_PLAIN_T, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = max(err, recom_equal(short, srows, want, wrows,
                               f"C={RECOM_C} T={RECOM_PLAIN_T}"))
    per_move_us = 1e3 * ms / (RECOM_T * shape["waves"])
    levels = recom_tree_levels(dg, st, 16)
    print(f"[{card}] recom_chunk 64x64 k=4 C={RECOM_C} T={RECOM_T}: "
          f"{ms:.4f} ms a chunk (CUDA events, mean of 3), {per_move_us:.2f} "
          f"us a move a wave; {accepted} moves committed, {exhausted} "
          f"exhausted; bound {bound_ms:.4e} ms ({bound_by}: {nbytes:.4e} "
          f"bytes, {ops:.4e} operations); launch shape: "
          f"{shape['smem_bytes']} B shared memory a block, "
          f"{shape['threads']} threads, {shape['registers']} registers, "
          f"{shape['blocks_per_sm']} block(s) an SM, {shape['waves']} "
          f"waves on {shape['sms']} SMs; at T={RECOM_PLAIN_T} the kernel "
          f"{ms_short:.4f} ms, the plain version {plain_ms:.3f} ms (host "
          "clock), bit-equal; the BFS levels of 16 chains' next trees "
          f"{min(levels)}-{max(levels)} (mean "
          f"{sum(levels) / len(levels):.1f})")
    out.update(ms=ms, bound_ms=bound_ms, bound_by=bound_by,
               plain_ms=plain_ms, plain_shape=f"C={RECOM_C}, "
               f"T={RECOM_PLAIN_T}", ms_at_plain_shape=ms_short,
               launch_shape=shape, tree_levels=levels)
    # (c) the main path: run_recom
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cr.run_recom_chunk_cuda.launches = 0
    t0 = time.perf_counter()
    res = recom.run_recom(dg, spec, params, st, n_steps=RECOM_STEPS,
                          chunk=RECOM_T, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cr.run_recom_chunk_cuda.launches
    chunks = -(-(RECOM_STEPS - 1) // RECOM_T)
    peak = torch.cuda.max_memory_allocated()
    moves_s = RECOM_C * (RECOM_STEPS - 1) / wall
    if launches != chunks:
        fail(f"run_recom: recom_chunk launched {launches} times for "
             f"{chunks} chunks")
    fs = res.state
    cut, cut_deg, dist_pop, cut_count, b_count = derive(
        dg, fs.assignment, RECOM_K, "pair")
    for name, want_ in (("cut", cut), ("cut_deg", cut_deg),
                        ("dist_pop", dist_pop), ("cut_count", cut_count),
                        ("b_count", b_count)):
        if not torch.equal(getattr(fs, name).to(want_.dtype), want_):
            fail(f"run_recom: {name} disagrees with a recount")
    target = kw["pop_target"]
    lo, hi = target * (1 - RECOM_TOL), target * (1 + RECOM_TOL)
    dp16 = fs.dist_pop[:16].double()
    if not bool(((dp16 >= lo) & (dp16 <= hi)).all()):
        fail("run_recom: a district's population is outside epsilon")
    rows16 = fs.assignment[:16].cpu().numpy()
    if not all(graph_connected(g, r, RECOM_K) for r in rows16):
        fail("run_recom: a sampled chain has a disconnected district")
    rate = float((fs.accept_count - st.accept_count).double().mean()) / (
        RECOM_STEPS - 1)
    print(f"[{card}] ReCom main path: run_recom 64x64 k=4, {RECOM_C} "
          f"chains x {RECOM_STEPS} steps in {wall:.3f} s, {moves_s:.6e} "
          f"moves/s; peak memory {peak / 2 ** 20:.1f} MiB; recom_chunk "
          f"launches {launches} for {chunks} chunks; committed share "
          f"{rate:.4f}; cut, cut_deg, dist_pop, cut_count and b_count equal "
          "a recount on every chain; 16 chains' districts connected and "
          f"within epsilon of {target:.0f}")
    idle = idle_share(lambda: recom.run_recom(
        dg, spec, params, st, n_steps=RECOM_STEPS, chunk=RECOM_T,
        record_history=False, **kw), ("recom_chunk", cr.run_recom_chunk_cuda))
    print(f"[{card}] profile of the ReCom main path ({RECOM_STEPS} steps): "
          + idle)
    out["main_path"] = {"wall_s": wall, "moves_per_s": moves_s,
                        "peak_mib": peak / 2 ** 20, "launches": launches,
                        "chunks": chunks, "committed_share": rate,
                        "profile": idle}
    out["launches"] = launches
    # (d) the main config through the driver
    cfg = ex.ExperimentConfig(**RECOM_RUN)
    n_chunks = -(-(cfg.total_steps - 1)
                 // sampling.runner.pick_chunk(cfg.total_steps, 256))
    data, rec = config_run(ex, drv, cfg, os.path.join(out_dir, "recom"),
                           cr.run_recom_chunk_cuda, n_chunks, card)
    a = np.asarray(data["assignments"]).astype(np.int64)
    if not all(graph_connected(g, r, cfg.n_districts) for r in a):
        fail(f"{cfg.tag}: a chain has a disconnected district")
    out["run_config"] = rec
    # (e) the JAX-made fixtures
    out["fixture_ties"] = {
        which: fixture_matches(ex, drv, which, kw_, out_dir,
                               waits="relative")
        for which, kw_ in RECOM_FIXTURES.items()}
    out["max_abs_err"] = err
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] ReCom phase: {out['seconds']:.1f} s")
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", metavar="BOARD_CHUNK_CU",
                    help="an earlier csrc/board_chunk.cu (the first "
                    "version's interface) to time beside the current one")
    ap.add_argument("--baseline-lowered", metavar="LOWERED_CHUNK_CU",
                    help="an earlier csrc/lowered_chunk.cu (the same C "
                    "interface) to check and time beside the current one")
    ap.add_argument("--plain-job", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)     # a plain_jobs worker
    opts = ap.parse_args()
    if opts.plain_job:
        plain_job(*opts.plain_job)
        return
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    try:
        import flipcomplexityempirical_tpu_torch as port
        from flipcomplexityempirical_tpu_torch.kernel import _build
        from flipcomplexityempirical_tpu_torch.kernel import board as tb
        from flipcomplexityempirical_tpu_torch.kernel import cuda_board as cb
        from flipcomplexityempirical_tpu_torch.kernel import cuda_lowered as cl
        from flipcomplexityempirical_tpu_torch.kernel import probes
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
            if "Compiling entry function" in line:
                print(f"  {name}: {line.split()[-3]}")
            elif "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 2: the probe path ---------------------------------------------
    kernels = probe_phase(probes)

    # ---- 3: board-chunk exactness against the plain version -----------
    err = chunk_cases(cb, port, EXACT_T, EXACT_CHAINS, GRID, GRID, POP_TOL,
                      False, f"{GRID}x{GRID} C={EXACT_CHAINS} T={EXACT_T}")
    for label, h, w, chains, tol, random_pop in EXTRA_CASES:
        err = max(err, chunk_cases(cb, port, EXACT_T, chains, h, w, tol,
                                   random_pop, f"{label} {h}x{w}"))

    # ---- 4: the main path ---------------------------------------------
    dev = DEVICE
    g = port.graphs.square_grid(GRID)
    plan = port.graphs.stripes_plan(g, 2)
    spec = port.Spec(contiguity="patch")
    bg, st, params = port.init_board(g, plan, n_chains=CHAINS, seed=0,
                                     spec=spec, base=BASE, pop_tol=POP_TOL,
                                     device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cb.run_board_chunk_cuda.launches = 0
    with count_calls((tb,), "apply_flip_log") as flip_calls:
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
          f"board_chunk launches {launches} for {chunks} chunks; "
          f"apply_flip_log calls {len(flip_calls)} (one a chunk and one in "
          f"each run's final record)")
    if launches != chunks:
        fail(f"board_chunk launched {launches} times for {chunks} chunks")
    if len(flip_calls) != chunks + 2:    # and each run's final record
        fail(f"apply_flip_log ran {len(flip_calls)} times for {chunks} "
             "chunks and 2 final records")

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

    # ---- exactness and timings at the main path's shape ----------------
    dp, scal, ints = cb.pack_state(fs, params)
    pop, deg = cb.make_static_inputs(bg)
    args = (spec, bg.h, bg.w, CHUNK, 7, 0, fs.board, pop, deg, dp, scal, ints)
    bits = host_bits(cb, CHUNK, CHAINS, bg.n, 4321)
    err = max(err, compare_chunk(cb, (*args, *bits),
                                 "main-path shape host bits"))
    del bits
    err = max(err, compare_chunk(cb, (*args, None, None),
                                 "main-path shape device rng"))
    reps = 3
    outs = cb.run_board_chunk_cuda(*args)      # warm
    ms = event_ms(lambda: cb.run_board_chunk_cuda(*args), reps)
    plain_ms = event_ms(lambda: cb.board_chunk_reference(*args), 1)
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
    print("rook " + flip_log_bound(fs, outs[4], outs[5]))

    n_cells = bg.n
    sum_hb = int(outs[7].long().sum())
    b_words = int(((outs[7].long() + 31) // 32).sum())
    n_valid = valid_cells(tb, bg, spec, fs.board, pop, dp, scal, outs)
    k_cell = K_CELL + (0 if bool((pop == pop[0]).all()) else K_GATE)
    ops = (CHAINS * CHUNK * (K_WORD * -(-n_cells // 32) + K_TAIL)
           + K_BWORD * b_words + k_cell * n_valid)
    nbytes = (2 * CHAINS * n_cells            # board in, out (int8)
              + 4 * n_cells                   # pop (deg is derived)
              + 4 * CHAINS * (2 + 5 + 7 + 2 + 2 + 7)  # per-chain in, out
              + 4 * 6 * CHUNK * CHAINS        # six (T, C) rows
              + 8 * CHAINS * n_cells)         # cut_e, cut_s out
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S
    per_cell_ms = 1e3 * (PER_CELL_OPS * n_cells
                         * CHAINS * CHUNK) / PEAK_OPS_PER_S
    print(f"board_chunk bound: {ops:.4e} operations (sum h_b {sum_hb}, "
          f"boundary words >= {b_words}, valid cells {n_valid}) "
          f"-> {t_ops:.4f} ms, {nbytes:.4e} bytes -> {t_bytes:.4f} ms; "
          f"the per-cell design's figure {per_cell_ms:.3f} ms")
    print(f"profile of {2 * CHUNK + 1} main-path steps: " + idle_share(
        lambda: port.run_board_cuda(bg, spec, params, fs,
                                    n_steps=2 * CHUNK + 1,
                                    record_history=False, chunk=CHUNK,
                                    seed=5, device=DEVICE)))
    print("SM clock, power draw under the kernel's load: "
          + clocks_under_load(lambda: cb.run_board_chunk_cuda(*args), 200))
    if opts.baseline:
        baseline_rounds(cb, args, opts.baseline)
    # ---- 5, 6: the lowered path -----------------------------------------
    lowered_err = lowered_exactness(port, cl)
    lowered_err = max(lowered_err, rook_exactness(port, cl))
    lowered_fixture(port, cl, tb)
    old_lowered = (build_baseline(opts.baseline_lowered,
                                  "baseline_lowered_chunk")
                   if opts.baseline_lowered else None)
    per_graph = {which: lowered_main_path(port, cl, tb, which, old_lowered)
                 for which in [x[0] for x in LOWERED] + ["square"]}
    main_row = per_graph["sec11"]
    # ---- 7: the experiment driver ---------------------------------------
    solo = {}
    per_graph["experiment"] = experiment_phase(cl, tb, solo)
    # ---- 8: the bench entry point; 9: the stationary distribution -------
    import pathlib

    from flipcomplexityempirical_tpu_torch.sampling import board_runner
    heads = bench_phase(str(pathlib.Path(__file__).resolve().parent))
    stationary = stationary_phase(port, cb, cl, board_runner)
    err = max(err, stationary["board_chunk_err"])
    lowered_err = max(lowered_err, stationary["lowered_chunk_err"])
    # ---- 10-13: the general path ----------------------------------------
    import tempfile

    from flipcomplexityempirical_tpu_torch import sampling as gsampling
    from flipcomplexityempirical_tpu_torch.experiments import driver as drv
    from flipcomplexityempirical_tpu_torch.kernel import cuda_dense as cd
    from flipcomplexityempirical_tpu_torch.kernel import dense
    from flipcomplexityempirical_tpu_torch.state import chain_state
    sys.path.insert(0, str(ROOT / "tests"))
    general_err, general_c8 = general_exactness(port, cd, gsampling)
    general = general_main_path(port, cb, cl, cd, probes, gsampling, dense,
                                chain_state)
    general["bench"] = general_bench(str(ROOT))
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        general["families"] = general_families(port, cb, cl, cd, probes,
                                               drv, tmp, solo)
    tri = experiment_exactness(port.experiments, drv, gsampling.runner, cl,
                               tb, GEN_TRI_RUNS)[GEN_TRI_RUNS[0][1]]
    per_graph["tri"] = {
        "launches": general["families"][GEN_TRI_RUNS[0][1]]["launches"],
        "max_abs_err": tri["max_abs_err"], "kernel": tri}
    general["stationary"] = general_stationary(port, gsampling)
    general["experiment_shape"] = general_c8
    # ---- 14: the sweep service ------------------------------------------
    service = service_phase(port.experiments, gsampling.runner, tb, cl, cd,
                            solo, card)
    # ---- 15: the device analytics -----------------------------------------
    analytics = summary_phase(port, port.experiments, drv, gsampling,
                              cl, cd, solo, card)
    del solo
    # ---- 16-19: the interface form, the pair walk's kernel, its exact
    # distributions, the new families and variants end to end ------------
    from flipcomplexityempirical_tpu_torch.kernel import cuda_pair as cp
    general["interface"] = interface_phase(port, cd, gsampling)
    pair = pair_phase(port, cp, drv, port.experiments, gsampling, card)
    pair["stationary"] = pair_stationary(port, gsampling)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        pair["runs"] = new_runs_phase(port.experiments, drv, cp, cd,
                                      gsampling, tmp, card)
    # ---- 20-23: the rook board's pair walk (its kernel, its main path,
    # the kpair family) and tempering (the temper family) -----------------
    from flipcomplexityempirical_tpu_torch.kernel import cuda_board_pair as cbp
    bpair = board_pair_phase(port, cbp, cl, tb, gsampling, str(ROOT), card)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        bpair["runs"] = kpair_runs(port.experiments, drv, cbp, gsampling,
                                   tmp, card)
        temper = temper_phase(port.experiments, drv, cl, gsampling, tmp,
                              card)
        # ---- 24: ReCom --------------------------------------------------
        recom_out = recom_phase(port, port.experiments, drv, gsampling, tmp,
                                card)
    # the plain versions held in phases 10, 14, 15, 16, 17, 21, 22 and 23
    held = plain_jobs(card)
    bpair["max_abs_err"] = max(bpair["max_abs_err"],
                               held.get("board_pair_chunk", 0.0))
    per_graph["temper"] = {"launches": temper["launches"],
                           "max_abs_err": held["lowered_chunk"],
                           "run": temper}
    general["max_abs_err"] = max(general["max_abs_err"],
                                 held.get("general_dense_chunk", 0.0))
    pair["max_abs_err"] = max(pair["max_abs_err"],
                              held.get("general_pair_chunk", 0.0))
    sweeps = service["sweeps"]
    per_graph["service"] = {
        "launches": sum(sweeps[f]["launches"] for f in ("sec11", "frank",
                                                        "tri")),
        "max_abs_err": service["kernels"]["frank"]["max_abs_err"],
        "kernel": service["kernels"]["frank"],
        "sweeps": {f: sweeps[f] for f in ("sec11", "frank", "tri")},
        "cli": service["cli"], "bench": service["bench"]}
    general["launches"] += sweeps["hex"]["launches"]
    general["max_abs_err"] = max(general["max_abs_err"],
                                 service["kernels"]["hex"]["max_abs_err"])
    general["service"] = {"kernel": service["kernels"]["hex"],
                          "sweep": sweeps["hex"]}
    exp_case = analytics["cases"][1]      # the experiment path's rows
    runs = analytics["runs"]

    def fused_route(kname: str, families) -> dict:
        return {
            "name": f"summary fold inside {kname}", "route": "cuda",
            "source": f"flipcomplexityempirical_tpu_torch/csrc/{kname}.cu",
            "header": "flipcomplexityempirical_tpu_torch/csrc/"
                      "summary_fold.cuh",
            "launches": sum(runs[t]["fused_launches"] for f, t in
                            SUMMARY_RUNS if f in families),
            "cases": [c["case"] for c in analytics["cases"]
                      if c["kernel"] == kname]}
    bmain = bpair.pop("main_shape")
    kernels.insert(0, {
        "name": "board_pair_chunk", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/"
                  "board_pair_chunk.cu",
        "replaces": "flipcomplexityempirical_tpu/kernel/board.py:1406",
        "launches": bpair.pop("launches"),
        "max_abs_err": bpair.pop("max_abs_err"), "ms": bmain["ms"],
        "plain_ms": bmain["plain_ms"], "bound_ms": bmain["bound_ms"],
        "bound_by": bmain["bound_by"], "library_ms": None,
        "main_shape": bmain, **bpair,
    })
    kernels.insert(0, {
        "name": "recom_chunk", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/recom_chunk.cu",
        "replaces": "flipcomplexityempirical_tpu/sampling/recom.py:317",
        "launches": recom_out.pop("launches"),
        "max_abs_err": recom_out.pop("max_abs_err"),
        "ms": recom_out.pop("ms"), "plain_ms": recom_out.pop("plain_ms"),
        "bound_ms": recom_out.pop("bound_ms"),
        "bound_by": recom_out.pop("bound_by"), "library_ms": None,
        **recom_out,
    })
    kernels.insert(0, {
        "name": "summary_fold", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/summary_fold.cu",
        "replaces": "flipcomplexityempirical_tpu/stats/accumulators.py:116",
        "launches": sum(r["launches"] for r in runs.values()),
        "max_abs_err": max(c["max_abs_err"] for c in analytics["cases"]),
        "ms": exp_case["ms"], "plain_ms": exp_case["plain_ms"],
        "bound_ms": exp_case["bound_ms"], "bound_by": exp_case["bound_by"],
        "library_ms": None, "cases": analytics["cases"],
        "runs": runs,
        "fused_routes": [fused_route("lowered_chunk", ("sec11", "frank")),
                         fused_route("general_dense_chunk", ("hex",))],
        "bench_ess": {"sec11": heads["sec11"]["ess"],
                      "hex": general["bench"]["ess"]},
    })
    kernels.insert(0, {
        "name": "general_pair_chunk", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/"
                  "general_pair_chunk.cu",
        "replaces": "flipcomplexityempirical_tpu/kernel/dense.py:257",
        "launches": pair.pop("launches"),
        "max_abs_err": pair.pop("max_abs_err"), "ms": pair.pop("ms"),
        "plain_ms": pair.pop("plain_ms"), "bound_ms": pair.pop("bound_ms"),
        "bound_by": pair.pop("bound_by"), "library_ms": None, **pair,
    })
    kernels.insert(0, {
        "name": "general_dense_chunk", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/"
                  "general_dense_chunk.cu",
        "replaces": "flipcomplexityempirical_tpu/kernel/dense.py:303",
        "launches": general.pop("launches"),
        "max_abs_err": max(general_err, general.pop("max_abs_err")),
        "ms": general.pop("ms"), "plain_ms": general.pop("plain_ms"),
        "bound_ms": general.pop("bound_ms"),
        "bound_by": general.pop("bound_by"), "library_ms": None,
        **general,
    })
    kernels.insert(0, {
        "name": "lowered_chunk", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/lowered_chunk.cu",
        "replaces": "flipcomplexityempirical_tpu/kernel/board.py:1267",
        "launches": sum(r["launches"] for r in per_graph.values()),
        "max_abs_err": max([lowered_err] + [r["max_abs_err"]
                                            for r in per_graph.values()]),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "graphs": per_graph, "bench": heads,
        "rook_route_replaces": "flipcomplexityempirical_tpu/kernel/"
                               "board.py:1338",
    })
    kernels.insert(0, {
        "name": "board_chunk", "route": "cuda",
        "source": "flipcomplexityempirical_tpu_torch/csrc/board_chunk.cu",
        "replaces": "flipcomplexityempirical_tpu/kernel/pallas_board.py:105",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "stationary": stationary,
    })
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
