// Board pair-chunk kernel: t_inner steps of the k-district pair walk on a
// plain rook grid (slow_reversible_propose semantics,
// grid_chain_sec11.py:117-130), one warp per chain and two chains a block,
// the board a byte a cell in shared memory.
//
// Replaces the JAX package's packed pair scan,
// flipcomplexityempirical_tpu/kernel/board.py::_scan_bits_pair (:1406), and
// its bit-identical int8 form (_planes_pair :949, _transition_pair :1017),
// which the JAX package runs at any width (its packed form wants
// w % 32 == 0), with the flip log's replay into part_sum / last_flipped /
// num_flips (board.py::apply_flip_log :1072) under parity_metrics. On the
// TPU these bodies are XLA code fused per scan step, not Pallas kernels;
// replayed as torch ops (the plain version) a step is dozens of small
// launches. Here one launch runs the whole chunk. It is bit-equal to its
// plain version (kernel/cuda_board_pair.py::board_pair_chunk_reference) on
// every output, and draws the JAX package's own threefry2x32 stream:
// split(key, 4) per step, uniform() of each subkey, exactly as rng.py and
// jax.random do.
//
// The walk. A step is uniform over the DISTINCT (boundary node, adjacent
// district) pairs: slot (v, j) for the rook directions j = E, S, W, N
// (offsets +1, +w, -1, -w) carries a pair iff v's neighbour in direction j
// exists, holds another district than v, and no earlier direction's
// neighbour holds the same district (the reference's pair set). The
// distinct-pair count b (the wait's |b_nodes|) counts these slots before
// the gates; a slot is valid if, besides, v passes the ring contiguity of
// its own district (its same-district rook neighbours form one block of
// the cyclic 8-neighbourhood) and the population gates (v's district may
// lose a unit, the neighbour's may gain one: per-chain district bitmasks
// fm and tm, a uniform population).
//
// What bounds it on an H100: not bytes (the board, the rows and the planes
// cross device memory once) and not operations, but the serial path of a
// chain's step and, at C=4096, the instructions the SM's resident chains
// issue. So a step makes no pass over the board, and a chain holds little:
//   - per chain in shared memory the board (N bytes), the valid slots of
//     each slot word (a 32-bit mask a word of 8 cells; slot (v, j) is bit
//     4 (v mod 8) + j of word v / 8, so the bit order is the slot order
//     flat4 = 4 v + j) and the count of valid slots of each lane's run of
//     words (lane l owns words l * wpl .. l * wpl + wpl - 1, wpl the
//     power of two at or above ceil(words / 32), 16 at 64 x 64; an int a
//     lane); in registers the distinct-pair count b, the total, the warp
//     prefix of the lane counts and the masks (fm, tm) the valid slots
//     were made under. 6272 B a chain at 64 x 64. A cell's pair slots are
//     not kept: they depend only on its 3 x 3 block, and are recomputed
//     from the board where a move needs them (cell_bits);
//   - the valid slots change only at an accepted move, and then only
//     inside the flipped cell's 3 x 3 block (the gated bits of a cell read
//     its own district and its rook neighbours'): lanes 0..8 take a cell
//     of the block each, its bits before and after the flip under (fm,
//     tm), and apply the change to its word's mask, its lane's count
//     (shared atomics) and b. When the move's populations change the
//     masks, every cell is recounted instead (the only pass over the
//     board; `recounts` counts them a chain). A rejected step, or an empty
//     valid set, touches nothing;
//   - two chains a block, launch bounds of 16 blocks an SM, so at most 64
//     registers a thread: 32 chains resident on each of the 132 SMs,
//     C=4096 in one wave (the kernel's first design, which kept a slot
//     byte a cell and rescanned every slot word a step: 8848 B and 105
//     registers a chain, 16 chains an SM, two waves). The register file
//     sets the 32; shared memory (a block's 12544 B and the 1 KB the card
//     keeps a block) would allow 34. A block of one chain would fit
//     exactly 32 in shared memory, with nothing to spare. The first form
//     of this design kept a byte count a word and evaluated the selected
//     word's 8 cells each step (4736 B a chain): clock64 marks put that
//     evaluation among the largest phases of a step, so the word masks
//     are kept instead (step_split.py splits this kernel's step).
// Per step and chain (the order of the JAX scan body):
//   1. the step's draws: every 32 steps one batch runs the key chain
//      (split counter 0 of each step's key) serially and then, lane i for
//      the batch's step i, the subkeys (split counters 1, 2, 3), their
//      uniforms and the logs that the accept test and the wait take; a
//      step reads its lane's values by shuffles;
//   2. complete the pending wait from b (denominator n**k - 1 in f32),
//      record the row (lane r < 4 writes row r): cut, b, wait, accepts;
//   3. select the m-th valid slot, m = min(int(u * total), total - 1) in
//      f32 (the JAX package's _pick_row), in three warp rounds: the owner
//      lane from the prefix of the lane counts (one ballot), the word from
//      the prefix of the popcounts of the owner's word masks (lane i reads
//      word i; one ballot a bit of the counts), then nth_bit in that
//      word's mask, shuffled from its lane;
//   4. dcut from v's rook neighbourhood; accept by the literal
//      base**(-dcut) bound with the chain's beta (or always); commit: the
//      board, the counts of the 3 x 3 block, the tallies and, where they
//      change the masks, the recount; then the lane prefix anew. An empty
//      valid set commits nothing.
// cut_times: the planes start at cut * T from the chunk's first board, and
// an accepted move at step t adds (cut_new - cut_old) * (T - 1 - t) to
// each of its edges (the change is seen by yields t + 1 .. T - 1),
// fire-and-forget; nothing is read back.
// The flip log's replay (parity_metrics): part_sum, last_flipped and
// num_flips start as copies of their inputs. Between two accepted moves
// cur_flip is one cell x with one sign s (the label of x's district after
// its flip, cur_sign), so the log's yields e0 .. e of that run add
// -s * (e - lf) to part_sum[x], with lf x's last_flipped before the run,
// set last_flipped[x] = e and add e - e0 + 1 to num_flips[x]. Lane 0
// closes a run at the next accepted move (or the chunk's end) with
// fire-and-forget reductions and a store; lf is loaded when the run opens
// and first used when it closes, a step or more later, so no step waits on
// device memory. (general_dense_chunk.cu's runs know the next run's sign
// at a close, label[1 - b] of two districts; with k districts it is
// known only at the next flip of x, hence the load.)
//
// Traps the code keeps:
//   - the slot order is flat4 = v * 4 + j with j = E, S, W, N, and a
//     direction is dropped when an earlier existing neighbour holds the
//     same district;
//   - b counts the deduplicated slots before the contiguity and
//     population gates;
//   - cur_sign is the label of d_to among k labels;
//   - with an empty valid set nothing is committed (the JAX body selects
//     slot 0 and rejects);
//   - float steps in the JAX order, built with -fmad=false (no
//     contraction): logf, log1pf and IEEE division, the device functions
//     torch's CUDA ops call, so the plain version on the card agrees bit
//     for bit;
//   - part_sum's arithmetic wraps mod 2**32 as the replay's int64 sums
//     cast to int32 do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace {

using namespace fce;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxCells = 4096;
constexpr int kChainsPerBlock = 2;
constexpr int kThreads = 32 * kChainsPerBlock;
constexpr int kBlocksPerSm = 16;  // the launch bound: 64 registers a thread

struct Args {
  const int8_t* board_in;         // (C, N) districts 0..k-1
  const int32_t* key_in;          // (2, C) uint32 key words
  const int32_t* dist_pop_in;     // (k, C)
  const float* scal_in;           // (6, C): log_base, beta, pop_lo, pop_hi,
                                  //         cur_wait, waits_sum
  const int32_t* ints_in;         // (8, C): pending, flip, sign, t_yield,
                                  //   move_clock, accepts, exhausted,
                                  //   cut_count
  const int32_t* labels;          // (k,) district labels
  const int32_t* part_sum_in;     // (C, N) each, under parity
  const int32_t* last_flipped_in;
  const int32_t* num_flips_in;
  int8_t* board_out;
  int32_t* key_out;
  int32_t* dist_pop_out;
  float* scal_out;                // (2, C): cur_wait, waits_sum
  int32_t* ints_out;              // (8, C)
  int32_t* h_cut;                 // (T, C) rows
  int32_t* h_b;
  float* h_wait;
  int32_t* h_acc;
  int32_t* cut_planes;            // (2, C, N): E, S chunk counts
  int32_t* part_sum_out;          // (C, N) each, under parity
  int32_t* last_flipped_out;
  int32_t* num_flips_out;
  int32_t* recounts;              // (C,) full recounts, or null
  int n_chains, h, w, k, t_inner;
  int patch, geom_waits, accept_always, unit_pop, parity;
  uint32_t w_magic;               // ceil(2**32 / w): row of v = umulhi(v, .)
  float denom;                    // n**k - 1 in f32
};

// Shared memory of a chain, in bytes (multiples of 16): the board (N
// bytes), the word masks (32 * wpl words, those past the board's zero)
// and the lane counts (32 ints).
struct Layout {
  int wshift, wpl, board_bytes, bytes;
  __host__ __device__ explicit Layout(int n) {
    const int per = (((n + 7) >> 3) + 31) >> 5;
    for (wshift = 0; (1 << wshift) < per; ++wshift) {
    }
    wpl = 1 << wshift;
    board_bytes = (n + 15) & ~15;
    bytes = board_bytes + 4 * 32 * wpl + 4 * 32;
  }
};

__device__ __forceinline__ int dir_off(int j, int w) {
  return j == 0 ? 1 : j == 1 ? w : j == 2 ? -1 : -w;
}

// The slot bits of cell v = r * w + c (header): bits 0..3 its deduplicated
// pair slots E, S, W, N; bits 4..7 those of them that are valid, under the
// ring contiguity of v's district and the population masks fm (v's
// district may lose a unit) and tm (the neighbour's may gain one).
__device__ __forceinline__ uint32_t cell_bits(const uint8_t* B, int v, int r,
                                              int c, int h, int w,
                                              bool patch, uint32_t fm,
                                              uint32_t tm) {
  const bool hE = c < w - 1, hW = c > 0, hS = r < h - 1, hN = r > 0;
  const int a = B[v];
  const int nE = hE ? B[v + 1] : -1, nS = hS ? B[v + w] : -1;
  const int nW = hW ? B[v - 1] : -1, nN = hN ? B[v - w] : -1;
  const bool pE = nE >= 0 && nE != a;
  const bool pS = nS >= 0 && nS != a && nS != nE;
  const bool pW = nW >= 0 && nW != a && nW != nE && nW != nS;
  const bool pN = nN >= 0 && nN != a && nN != nE && nN != nS && nN != nW;
  bool contig = true;
  if (patch) {
    const bool sE = nE == a, sS = nS == a, sW = nW == a, sN = nN == a;
    const bool sSE = hS && hE && B[v + w + 1] == a;
    const bool sSW = hS && hW && B[v + w - 1] == a;
    const bool sNW = hN && hW && B[v - w - 1] == a;
    const bool sNE = hN && hE && B[v - w + 1] == a;
    const int seeds = int(sE) + int(sS) + int(sW) + int(sN);
    const int runs = int(sE && !(sNE && sN)) + int(sS && !(sSE && sE)) +
                     int(sW && !(sSW && sS)) + int(sN && !(sNW && sW));
    contig = seeds <= 1 || runs <= 1;
  }
  const uint32_t pairs = uint32_t(pE) | uint32_t(pS) << 1 |
                         uint32_t(pW) << 2 | uint32_t(pN) << 3;
  // a missing neighbour (-1) has no pair bit; its shift is masked
  const uint32_t to = (tm >> (nE & 31) & 1u) | (tm >> (nS & 31) & 1u) << 1 |
                      (tm >> (nW & 31) & 1u) << 2 |
                      (tm >> (nN & 31) & 1u) << 3;
  const uint32_t ok = (contig && ((fm >> a) & 1u)) ? to : 0u;
  return pairs | (pairs & ok) << 4;
}

__device__ __forceinline__ int row_of(int v, uint32_t w_magic) {
  return static_cast<int>(__umulhi(static_cast<uint32_t>(v), w_magic));
}

// Copy a chain's row of n int32 from each of three planes, 4 fields a
// plane and lane in flight (chain_common.cuh's copy_rows wants the planes
// 16-byte aligned; a state's planes sliced by chains need not be).
__device__ __forceinline__ void copy_rows3(const int32_t* in0,
                                           const int32_t* in1,
                                           const int32_t* in2, int32_t* out0,
                                           int32_t* out1, int32_t* out2,
                                           size_t base, int n, int lane) {
  for (int i0 = 0; i0 < n; i0 += 128) {
    int32_t v[3][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      const bool ok = i < n;
      v[0][u] = ok ? __ldg(in0 + base + i) : 0;
      v[1][u] = ok ? __ldg(in1 + base + i) : 0;
      v[2][u] = ok ? __ldg(in2 + base + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i < n) {
        out0[base + i] = v[0][u];
        out1[base + i] = v[1][u];
        out2[base + i] = v[2][u];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    board_pair_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = a.h, w = a.w, n = h * w, C = a.n_chains, T = a.t_inner;
  const int K = a.k;
  const Layout L(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kChainsPerBlock + warp;
  if (c >= C) return;
  uint8_t* B = smem + (size_t)warp * L.bytes;
  uint32_t* VM = reinterpret_cast<uint32_t*>(B + L.board_bytes);
  int* LC = reinterpret_cast<int*>(VM + 32 * L.wpl);
  const size_t base = (size_t)c * n;
  const size_t plane = (size_t)C * n;
  const bool patch = a.patch != 0;

  // ---- the chunk's first board; the cut planes at cut * T; the parity
  // planes copied ---------------------------------------------------------
  for (int i0 = 0; i0 < n; i0 += 256) {
    uint8_t v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 32 * u + lane;
      v[u] = i < n ? static_cast<uint8_t>(__ldg(a.board_in + base + i)) : 0u;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (i0 + 32 * u + lane < n) B[i0 + 32 * u + lane] = v[u];
  }
  for (int i = lane; i < 32 * L.wpl; i += 32) VM[i] = 0u;
  if (a.parity)
    copy_rows3(a.part_sum_in, a.last_flipped_in, a.num_flips_in,
               a.part_sum_out, a.last_flipped_out, a.num_flips_out, base, n,
               lane);
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    const int r = row_of(i, a.w_magic), cc = i - r * w;
    const int v = B[i];
    a.cut_planes[base + i] = cc < w - 1 ? int(v != B[i + 1]) * T : 0;
    a.cut_planes[plane + base + i] = r < h - 1 ? int(v != B[i + w]) * T : 0;
  }

  // per-chain state, warp-uniform; lane d < k holds district d's population
  uint32_t key0 = static_cast<uint32_t>(a.key_in[c]);
  uint32_t key1 = static_cast<uint32_t>(a.key_in[C + c]);
  const float log_base = a.scal_in[c], beta = a.scal_in[C + c];
  const float pop_lo = a.scal_in[2 * C + c], pop_hi = a.scal_in[3 * C + c];
  float cur_wait = a.scal_in[4 * C + c], waits_sum = a.scal_in[5 * C + c];
  int dp = lane < K ? a.dist_pop_in[lane * C + c] : 0;
  int pending = a.ints_in[c], cur_flip = a.ints_in[C + c],
      cur_sign = a.ints_in[2 * C + c], move_clock = a.ints_in[4 * C + c],
      acc_cnt = a.ints_in[5 * C + c], exh_cnt = a.ints_in[6 * C + c],
      cut_count = a.ints_in[7 * C + c];
  const int t_yield = a.ints_in[3 * C + c];
  const float unitf = static_cast<float>(a.unit_pop);

  // the population masks of the current tallies
  auto masks = [&](uint32_t& fm, uint32_t& tm) {
    const float dpf = static_cast<float>(dp);
    fm = __ballot_sync(kFull, lane < K && dpf - unitf >= pop_lo);
    tm = __ballot_sync(kFull, lane < K && dpf + unitf <= pop_hi);
  };
  uint32_t fm, tm;
  masks(fm, tm);

  // every cell's bits under (fm, tm): the word masks and the lane
  // counts; returns b
  auto recount = [&]() {
    int pairs = 0;
    for (int v0 = 0; v0 < n; v0 += 32) {
      const int v = v0 + lane;
      uint32_t bits = 0u;
      if (v < n) {
        const int r = row_of(v, a.w_magic);
        bits = cell_bits(B, v, r, v - r * w, h, w, patch, fm, tm);
      }
      pairs += __popc(bits & 0xFu);
      uint32_t word = (bits >> 4) << (4 * (lane & 7));
      word |= __shfl_xor_sync(kFull, word, 1);
      word |= __shfl_xor_sync(kFull, word, 2);
      word |= __shfl_xor_sync(kFull, word, 4);
      if ((lane & 7) == 0 && v < n) VM[v >> 3] = word;
    }
    __syncwarp();
    int mine = 0;
    for (int i = 0; i < L.wpl; ++i)  // rotated: lane runs fall in 2 banks
      mine += __popc(VM[(lane << L.wshift) + ((i + lane) & (L.wpl - 1))]);
    LC[lane] = mine;
    return __reduce_add_sync(kFull, pairs);
  };
  int b_count = recount();
  int n_recounts = 0;
  // the round-1 prefix: this lane's count, its inclusive prefix, the total
  int my_cnt = LC[lane];
  int incl = incl_scan(my_cnt, lane);
  int total = __shfl_sync(kFull, incl, 31);

  // the parity run at cur_flip: its first step in the chunk and x's
  // last_flipped before it (lane 0)
  int run_t0 = 0, run_lf = 0;
  if (a.parity && lane == 0 && cur_flip >= 0)
    run_lf = a.last_flipped_in[base + cur_flip];
  // close the run at cur_flip over steps run_t0 .. t_end - 1 (lane 0)
  auto close_run = [&](int t_end) {
    const int e = t_yield + t_end - 1;
    const size_t at = base + cur_flip;
    atomicAdd(a.part_sum_out + at,
              static_cast<int>(static_cast<uint32_t>(-cur_sign) *
                               static_cast<uint32_t>(e - run_lf)));
    atomicAdd(a.num_flips_out + at, t_end - run_t0);
    a.last_flipped_out[at] = e;
  };

  // lane r < 4 writes row r: cut, b, wait, accepts
  int32_t* const my_row = lane == 0   ? a.h_cut
                          : lane == 1 ? a.h_b
                          : lane == 2 ? reinterpret_cast<int32_t*>(a.h_wait)
                                      : a.h_acc;
  const uint32_t below_me = (1u << lane) - 1u;
  Draws draws{0u, 0u, 0u, 0.f, 0.f};  // lane i: step 32 * q + i's draws

  for (int t = 0; t < T; ++t) {
    // ---- 1. the step's uniforms, drawn 32 steps at a time -------------
    const int slot = t & 31;
    if (slot == 0) {
      draws = draw_batch(key0, key1, min(32, T - t));
      key0 = draws.key0;
      key1 = draws.key1;
    }
    const float u_prop = uniform_of(__shfl_sync(kFull, draws.prop, slot));
    const float log_acc = __shfl_sync(kFull, draws.log_acc, slot);
    const float log_wait = __shfl_sync(kFull, draws.log_wait, slot);

    // ---- 2. wait, record ------------------------------------------------
    if (a.geom_waits && pending) {
      const float p = static_cast<float>(b_count) / a.denom;
      cur_wait = fmaxf(floorf(log_wait / log1pf(-p)), 0.f);
    }
    if (lane < 4) {
      const int v = lane == 0   ? cut_count
                    : lane == 1 ? b_count
                    : lane == 2 ? __float_as_int(cur_wait)
                                : acc_cnt;
      my_row[(size_t)t * C + c] = v;
    }
    waits_sum += cur_wait;

    // ---- 3. select the m-th valid slot in three rounds ------------------
    exh_cnt += total == 0;
    bool accept = false;
    if (total > 0) {
      int m = static_cast<int>(u_prop * static_cast<float>(total));
      m = min(m, total - 1);
      // round 1: the owner lane
      const int owner = __ffs(__ballot_sync(kFull, incl > m)) - 1;
      int r = m - __shfl_sync(kFull, incl - my_cnt, owner);
      // round 2: the owner's word, lane i holding word i of its run
      const int q0 = owner << L.wshift;
      const uint32_t vm = lane < L.wpl ? VM[q0 + lane] : 0u;
      const int wc = __popc(vm);
      int below = 0;
#pragma unroll
      for (int bit = 0; bit < 6; ++bit)
        below += __popc(__ballot_sync(kFull, (wc >> bit) & 1) & below_me)
                 << bit;
      const int ws = __ffs(__ballot_sync(kFull, below + wc > r)) - 1;
      r -= __shfl_sync(kFull, below, ws);
      // round 3: the slot in that word's mask
      const int pos = nth_bit(__shfl_sync(kFull, vm, ws), r);
      const int flat = 8 * (q0 + ws) + (pos >> 2), j = pos & 3;
      const int fr = row_of(flat, a.w_magic), fc = flat - fr * w;
      const int d_from = B[flat];
      const int d_to = B[flat + dir_off(j, w)];
      // dcut over flat's rook neighbours (every lane, warp-uniform)
      int dcut = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool ex = jj == 0 ? fc < w - 1 : jj == 1 ? fr < h - 1
                        : jj == 2 ? fc > 0 : fr > 0;
        if (ex) {
          const int au = B[flat + dir_off(jj, w)];
          dcut += int(au != d_to) - int(au != d_from);
        }
      }
      accept = a.accept_always ||
               log_acc < -beta * static_cast<float>(dcut) * log_base;

      // ---- 4. commit ----------------------------------------------------
      if (accept) {
        // lane i < 9: cell i of flat's 3 x 3 block, its bits before
        const int rr = fr + lane / 3 - 1, cc = fc + lane % 3 - 1;
        const bool in = lane < 9 && rr >= 0 && rr < h && cc >= 0 && cc < w;
        const int u = rr * w + cc;
        const uint32_t old_bits =
            in ? cell_bits(B, u, rr, cc, h, w, patch, fm, tm) : 0u;
        // lane jj < 4: flat's edge in direction jj changes its cut state
        // for the yields t + 1 .. T - 1
        if (lane < 4) {
          const bool ex = lane == 0 ? fc < w - 1 : lane == 1 ? fr < h - 1
                          : lane == 2 ? fc > 0 : fr > 0;
          if (ex) {
            const int nb = flat + dir_off(lane, w);
            const int au = B[nb];
            const int d = int(au != d_to) - int(au != d_from);
            // E and S edges live at flat, W and N at the neighbour
            if (d)
              atomicAdd(a.cut_planes + (lane & 1) * plane + base +
                            (lane < 2 ? flat : nb),
                        d * (T - 1 - t));
          }
        }
        // the parity run at the last flip closes, flat's opens
        if (a.parity && lane == 0) {
          if (cur_flip >= 0) close_run(t + 1);
          run_lf = a.last_flipped_out[base + flat];
          run_t0 = t + 1;
        }
        __syncwarp();
        if (lane == 0) B[flat] = static_cast<uint8_t>(d_to);
        __syncwarp();
        const uint32_t new_bits =
            in ? cell_bits(B, u, rr, cc, h, w, patch, fm, tm) : 0u;
        b_count += __reduce_add_sync(
            kFull, __popc(new_bits & 0xFu) - __popc(old_bits & 0xFu));
        const int unit = a.unit_pop;
        if (lane == d_to) dp += unit;
        if (lane == d_from) dp -= unit;
        uint32_t fm2, tm2;
        masks(fm2, tm2);
        if (fm2 == fm && tm2 == tm) {
          // lanes may share a word and a lane count
          const uint32_t vdiff = (old_bits ^ new_bits) >> 4;
          if (vdiff) {
            atomicXor(VM + (u >> 3), vdiff << (4 * (u & 7)));
            const int dv = __popc(new_bits >> 4) - __popc(old_bits >> 4);
            if (dv) atomicAdd(LC + ((u >> 3) >> L.wshift), dv);
          }
        } else {
          fm = fm2;
          tm = tm2;
          recount();
          ++n_recounts;
        }
        __syncwarp();
        my_cnt = LC[lane];
        incl = incl_scan(my_cnt, lane);
        total = __shfl_sync(kFull, incl, 31);
        cut_count += dcut;
        cur_flip = flat;
        cur_sign = __ldg(a.labels + d_to);
      }
    }
    pending = accept;
    move_clock += accept;
    acc_cnt += accept;
  }

  // ---- chunk end: the last parity run, the board and the chain's fields -
  if (a.parity && lane == 0 && cur_flip >= 0 && run_t0 < T) close_run(T);
  for (int i = lane; i < n; i += 32)
    a.board_out[base + i] = static_cast<int8_t>(B[i]);
  if (lane < K) a.dist_pop_out[lane * C + c] = dp;
  if (lane == 0) {
    a.key_out[c] = static_cast<int32_t>(key0);
    a.key_out[C + c] = static_cast<int32_t>(key1);
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[8] = {pending,    cur_flip, cur_sign, t_yield + T,
                         move_clock, acc_cnt,  exh_cnt,  cut_count};
#pragma unroll
    for (int q = 0; q < 8; ++q) a.ints_out[q * C + c] = ints[q];
    if (a.recounts) a.recounts[c] = n_recounts;
  }
}

// the most shared memory an SM can give, for 16 blocks' chains (a block
// needs under 48 KB, so no opt-in)
cudaError_t configure() {
  return cudaFuncSetAttribute(
      board_pair_chunk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared));
}

}  // namespace

extern "C" {

// One chunk for every chain; returns a cudaError_t. The parity planes
// (in and out) are read and written only when `parity` is set, `recounts`
// only when not null.
int fce_board_pair_chunk(
    const int8_t* board_in, const int32_t* key_in, const int32_t* dist_pop_in,
    const float* scal_in, const int32_t* ints_in, const int32_t* labels,
    const int32_t* part_sum_in, const int32_t* last_flipped_in,
    const int32_t* num_flips_in, int8_t* board_out, int32_t* key_out,
    int32_t* dist_pop_out, float* scal_out, int32_t* ints_out, int32_t* h_cut,
    int32_t* h_b, float* h_wait, int32_t* h_acc, int32_t* cut_planes,
    int32_t* part_sum_out, int32_t* last_flipped_out, int32_t* num_flips_out,
    int32_t* recounts, int n_chains, int h, int w, int k, int t_inner,
    int patch, int geom_waits, int accept_always, int unit_pop, int parity,
    float denom, void* stream) {
  Args a;
  a.board_in = board_in; a.key_in = key_in; a.dist_pop_in = dist_pop_in;
  a.scal_in = scal_in; a.ints_in = ints_in; a.labels = labels;
  a.part_sum_in = part_sum_in; a.last_flipped_in = last_flipped_in;
  a.num_flips_in = num_flips_in;
  a.board_out = board_out; a.key_out = key_out;
  a.dist_pop_out = dist_pop_out; a.scal_out = scal_out;
  a.ints_out = ints_out; a.h_cut = h_cut; a.h_b = h_b; a.h_wait = h_wait;
  a.h_acc = h_acc; a.cut_planes = cut_planes;
  a.part_sum_out = part_sum_out; a.last_flipped_out = last_flipped_out;
  a.num_flips_out = num_flips_out; a.recounts = recounts;
  a.n_chains = n_chains; a.h = h; a.w = w; a.k = k; a.t_inner = t_inner;
  a.patch = patch; a.geom_waits = geom_waits;
  a.accept_always = accept_always; a.unit_pop = unit_pop;
  a.parity = parity; a.denom = denom;
  if (n_chains < 1 || h < 3 || w < 3 || h * w > kMaxCells || k < 2 ||
      k > 31 || t_inner < 1 ||
      (parity && !(part_sum_in && last_flipped_in && num_flips_in &&
                   part_sum_out && last_flipped_out && num_flips_out)))
    return int(cudaErrorInvalidValue);
  a.w_magic = static_cast<uint32_t>(((uint64_t(1) << 32) + w - 1) / w);
  const size_t smem = size_t(kChainsPerBlock) * Layout(h * w).bytes;
  cudaError_t err = configure();
  if (err != cudaSuccess) return int(err);
  const int blocks = (n_chains + kChainsPerBlock - 1) / kChainsPerBlock;
  board_pair_chunk_kernel<<<blocks, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

// The launch shape at n cells: out[0] a chain's shared memory (bytes),
// out[1] chains a block, out[2] blocks resident an SM, out[3] threads a
// block, out[4] slot words a lane, out[5] registers a thread, out[6] local
// (spilled) bytes a thread.
int fce_board_pair_shape(int n, int* out) {
  if (n < 9 || n > kMaxCells) return int(cudaErrorInvalidValue);
  const size_t smem = size_t(kChainsPerBlock) * Layout(n).bytes;
  cudaError_t err = configure();
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, board_pair_chunk_kernel, kThreads, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr,
                                                      board_pair_chunk_kernel);
  if (err != cudaSuccess) return int(err);
  out[0] = Layout(n).bytes;
  out[1] = kChainsPerBlock;
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = Layout(n).wpl;
  out[5] = attr.numRegs;
  out[6] = int(attr.localSizeBytes);
  return 0;
}

}  // extern "C"
