// Board-chunk kernel: t_inner steps of the 2-district flip chain on a
// plain H x W rook grid, one warp per chain, the board bit-packed in shared
// memory.
//
// Replaces the TPU kernel flipcomplexityempirical_tpu/kernel/pallas_board.py
// ::_kernel (launched by run_pallas_chunk). It computes what that kernel
// computes, step by step and bit for bit given the same random bits, and
// is bit-equal to its plain version (kernel/cuda_board.py::
// board_chunk_reference) on every output.
//
// Design. The TPU kernel evaluates dense per-cell planes; a per-cell CUDA
// port of it spends ~86 integer operations a cell and step, most of them
// on cells that cannot move. Here:
//   - one warp runs one chain (kChainsPerBlock chains a block) and the
//     step loop has no block barrier: warp shuffles, warp reductions and
//     __syncwarp only. The per-step tail (wait, record, accept, commit)
//     runs warp-uniformly, and the block's other warps hide its latency;
//   - the board is held as bits, 32 cells a word (cell = 32 * word + bit),
//     with zero guard words so that every neighbour word read stays in
//     bounds. Per word: the 8 "same district" planes from funnel shifts by
//     1, w - 1, w and w + 1 (XNOR, masked by existence masks built once a
//     block from (h, w)), the boundary, cut_e / cut_s and the ring
//     contiguity criterion in its packed form, with __popc counts;
//   - random words are drawn only for valid cells. With a uniform
//     population plane (the block checks) the f32 population gate is one
//     test per district and step, folded into the candidate words
//     (boundary & contiguity & gate); otherwise it runs per candidate cell
//     among the draws. The nonzero candidate words are compacted across
//     the warp by ballots, then unpacked 4 words a pass, one lane per
//     group of 4 cells, into a per-warp list of groups; lane l takes
//     entries l, l + 32, ..., draws one Philox4x32-10 block per group at
//     counter (cell / 4, step, chunk, 0), which is the same stream the
//     per-cell design drew for every cell, and keeps the best key
//     score << 32 | ~cell. Warp max / min reductions pick the first-index
//     argmax; an empty valid set resolves to cell 0, as the plain
//     version's argmax of an all-zero row does;
//   - cut_times by events: a rook edge's cut state changes only when one
//     of its ends flips, so an accepted flip at step t updates at most 4
//     edges, acc += cut_old * (t + 1 - last), and the chunk's end adds
//     cut_now * (T - last) for every edge, with last the later of the two
//     ends' last flip steps. Counts live in the cut_e / cut_s outputs and
//     the last flip steps in a (C, N) int32 scratch plane; a per-chain
//     bit plane in shared memory marks the cells flipped in this chunk,
//     so neither plane is initialised and only flipped cells are read.
//     This was taken over the bit-sliced ripple-carry counters of the JAX
//     bit body (bitboard.py), which add into every edge every step: ~0.5
//     flips a step touch 4 edges, against 2N counter updates.
//   - the two per-step scalar words (wait, accept) are drawn 32 steps at
//     a time, one step a lane, with their logs, and read by a shuffle.
//
// What bounds it on an H100: integer issue, not memory. A chain-step is
// ~1,000 warp instructions, nearly all on the 16-lane int32 pipes: at
// 64 x 64 the word pass (4 words a lane, the ring criterion only where a
// word holds a boundary cell), the compaction and ~3 rounds of Philox
// draws for ~80 candidate groups, then a warp-uniform tail. Device memory
// carries the board in and out, the cut_e / cut_s planes out and the
// (T, C) rows, ~0.07 ms at 3.35 TB/s against a few ms of issue. The kernel
// keeps at most 64 registers a thread at up to 4096 cells, so that 32
// chains share an SM and C = 4096 chains run in one wave on 132 SMs. The
// floor chip_smoke.py reports is the packed-form operation count of what
// the run's data needs (every word's rook planes, the ring criterion on
// words holding a boundary cell, a Philox word per valid cell) over the
// 67 TFLOP/s non-tensor peak: ~0.25 ms a 500-step chunk at C = 4096 and
// 64 x 64, where the kernel takes ~3.7 ms.

// Random bits: either read from (T, C, N) and (T, 2, C) uint32 planes
// (host-bits mode: only the valid cells' words are read) or drawn here by
// Philox4x32-10 with key (seed, chain) and counter (cell / 4, step, chunk,
// stream) -- rng.py holds its torch twin.
//
// Contract beyond the plain version's: the board holds 0 / 1, and deg is
// the grid's rook degree (make_static_inputs checks it once a run), so that
// the boundary test deg - same_deg > 0 is the OR of the four rook "differ"
// planes and the accept's degree is the count of a cell's rook neighbours.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py). No fast math: the
// float steps must round as the plain version's do.

#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

using fce::kStreamPlane;
using fce::kStreamScalars;
using fce::Philox4;
using fce::philox4x32_10;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChainsPerBlock = 8;
constexpr int kThreads = 32 * kChainsPerBlock;

// uint32 -> f32 uniform in (0, 1): the top 24 bits, (x + 1) / 16777218
__device__ __forceinline__ float u01(uint32_t bits) {
  return (static_cast<float>(static_cast<int>(bits >> 8)) + 1.0f) *
         static_cast<float>(1.0 / 16777218.0);
}

// log(max(u, 1e-12)) of a uniform word, as the plain version computes it
__device__ __forceinline__ float log_u01(uint32_t bits) {
  return logf(fmaxf(u01(bits), 1e-12f));
}

// at most one of the four bit planes set, per bit
__device__ __forceinline__ uint32_t at_most_one(uint32_t a, uint32_t b,
                                                uint32_t c, uint32_t d) {
  return ~((a & b) | (c & d) | ((a | b) & (c | d)));
}

__device__ __forceinline__ uint32_t bit_at(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

struct Args {
  const int8_t* board_in;      // (C, N)
  const int32_t* pop;          // (N,)
  const int32_t* dist_pop_in;  // (2, C)
  const float* scal_in;        // (5, C): log_base, beta, pop_lo, pop_hi, cur_wait
  const int32_t* ints_in;      // (7, C): pending, flip, sign, t_yield,
                               //         move_clock, accepts, exhausted
  const uint32_t* bits_plane;  // (T, C, N) or null (device RNG)
  const uint32_t* bits_scal;   // (T, 2, C) or null
  int8_t* board_out;           // (C, N)
  int32_t* dist_pop_out;       // (2, C)
  float* scal_out;             // (2, C): cur_wait, waits_sum
  int32_t* ints_out;           // (7, C)
  int32_t* log_f;              // (T, C)
  int32_t* log_s;
  int32_t* h_cut;
  int32_t* h_b;
  float* h_wait;
  int32_t* h_acc;
  int32_t* cut_e;              // (C, N)
  int32_t* cut_s;
  int32_t* last_flip;          // (C, N) scratch, read only where flipped
  int n_chains, h, w, t_inner, patch, geom_waits;
  uint32_t chunk_idx;
  fce::PhiloxKey0 key0;        // seed + r * W0, the first key word's rounds
};

// Shared memory layout, in 32-bit words unless stated, with strides fixed
// by WPL (kWords = 32 * WPL >= the board's words) so that every address is
// a register plus a constant:
//   masks   4 * kWords   per word, existence of the E, W, S, N neighbour
//   per chain (kChain):
//     board  guard + kWords + guard   the chain's board bits, guards zero
//     flip   kWords                   cells flipped in this chunk
//     wcand  kWords                   the step's nonzero candidate words
//   per chain, uint16 (kHalves):
//     list   8 * kWords               candidate groups (group << 4 | cells)
//     wk     kWords                   the word index of each wcand entry
// A neighbour word is at most (w + 1) / 32 + 1 <= kWords + 1 words away.
template <int WPL>
struct Layout {
  static constexpr int kWords = 32 * WPL;
  static constexpr int kGuard = kWords + 2;
  static constexpr int kBoard = kWords + 2 * kGuard;
  static constexpr int kChain = kBoard + 2 * kWords;
  static constexpr int kHalves = 9 * kWords;
  static constexpr size_t kBytes = 16 * size_t(kWords) +
                                   4 * size_t(kChainsPerBlock) * kChain +
                                   2 * size_t(kChainsPerBlock) * kHalves;
};

// WPL: board words a lane owns (words lane, lane + 32, ...), a power of 2
// with 32 * WPL >= nw. WMOD: where the cells w - 1, w and w + 1 away fall
// in words, by w % 32: 0 for 1..30 (all three shifts read the same two
// words), 1 for 0 (the cell w away is word-aligned), 2 for 31 (the cell
// w + 1 away is). Up to 4096 cells (WPL <= 4) four blocks share an SM, so a
// thread gets at most 64 registers; larger boards fit fewer blocks in
// shared memory and give the registers to the thread instead.
template <int WPL, int WMOD>
__global__ void __launch_bounds__(kThreads, WPL <= 4 ? 4 : WPL == 8 ? 2 : 1)
    board_chunk_kernel(const Args a) {
  using L = Layout<WPL>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int w = a.w, n = a.h * a.w, C = a.n_chains, T = a.t_inner;
  const int nw = (n + 31) >> 5;
  uint4* masks = reinterpret_cast<uint4*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // a uniform population plane turns the population gate into one test
  // per district and step
  const int pop0 = a.pop[0];
  int same_pop = 1;
  for (int i = threadIdx.x; i < n; i += kThreads)
    same_pop &= __ldg(a.pop + i) == pop0;

  // existence masks, shared by the block's chains
  for (int k = threadIdx.x; k < nw; k += kThreads) {
    uint4 m = make_uint4(0u, 0u, 0u, 0u);
    for (int b = 0; b < 32; ++b) {
      const int i = 32 * k + b;
      if (i >= n) break;
      const int x = i / w, y = i - (i / w) * w;
      m.x |= uint32_t(y < w - 1) << b;
      m.y |= uint32_t(y > 0) << b;
      m.z |= uint32_t(x < a.h - 1) << b;
      m.w |= uint32_t(x > 0) << b;
    }
    masks[k] = m;
  }
  // the only block barrier: before the step loop
  const bool uniform_pop = __syncthreads_and(same_pop);

  const int c = blockIdx.x * kChainsPerBlock + warp;
  if (c >= C) return;
  uint32_t* board_all = smem + 4 * L::kWords + warp * L::kChain;
  uint32_t* B = board_all + L::kGuard;  // B[-guard .. nw + guard) readable
  uint32_t* flipped = board_all + L::kBoard;
  uint32_t* wcand = flipped + L::kWords;
  uint16_t* list = reinterpret_cast<uint16_t*>(
                       smem + 4 * L::kWords + kChainsPerBlock * L::kChain) +
                   warp * L::kHalves;
  uint16_t* wk = list + 8 * L::kWords;
  const uint32_t lanes_below = (1u << lane) - 1u;
  const size_t base = (size_t)c * n;
  const bool host_bits = a.bits_plane != nullptr;

  for (int k = lane; k < L::kBoard; k += 32) board_all[k] = 0u;
  for (int k = lane; k < nw; k += 32) flipped[k] = 0u;
  __syncwarp();
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    const uint32_t word =
        __ballot_sync(kFull, i < n && a.board_in[base + i] != 0);
    if (lane == (k & 31)) B[k] = word;
  }
  __syncwarp();

  // neighbour words: a funnel shift right by s & 31 of words k + (s >> 5)
  // and k + (s >> 5) + 1 gives "cell i + s" for every bit of word k; a
  // shift left of words k - (s >> 5) - 1 and k - (s >> 5) gives "cell
  // i - s". The lane's own words and the rows below and above are read
  // from three pointers at constant offsets 32 * j.
  const uint32_t* b_l = B + lane;
  const uint32_t* b_s = b_l + (w >> 5);
  const uint32_t* b_n = b_l - (w >> 5);
  const uint32_t bo = w & 31;

  // per-chain state, warp-uniform
  const float log_base = a.scal_in[c], beta = a.scal_in[C + c];
  const float pop_lo = a.scal_in[2 * C + c], pop_hi = a.scal_in[3 * C + c];
  float cur_wait = a.scal_in[4 * C + c], waits_sum = 0.f;
  int dp0 = a.dist_pop_in[c], dp1 = a.dist_pop_in[C + c];
  int pending = a.ints_in[c], cur_flip = a.ints_in[C + c],
      cur_sign = a.ints_in[2 * C + c], acc_cnt = a.ints_in[5 * C + c],
      exh_cnt = a.ints_in[6 * C + c];
  const float denom = static_cast<float>(static_cast<double>(n) * n - 1.0);
  float log_w = 0.f, log_a = 0.f;  // this lane's step of the 32-step batch

  for (int t = 0; t < T; ++t) {
    if ((t & 31) == 0) {
      const int ts = t + lane;
      uint32_t wbits = 0u, abits = 0u;
      if (ts < T) {
        if (host_bits) {
          wbits = a.bits_scal[((size_t)ts * 2) * C + c];
          abits = a.bits_scal[((size_t)ts * 2 + 1) * C + c];
        } else {
          const Philox4 r = philox4x32_10(0u, ts, a.chunk_idx,
                                          kStreamScalars, a.key0.r, c);
          wbits = r.v[0];
          abits = r.v[1];
        }
      }
      log_w = log_u01(wbits);
      log_a = log_u01(abits);
    }

    // ---- planes: counts and candidate words ---------------------------
    // with a uniform population the gate is one test per district, folded
    // into the candidate words; otherwise it runs per cell among the draws
    const float p0f = static_cast<float>(dp0), p1f = static_cast<float>(dp1);
    uint32_t gate0 = kFull, gate1 = kFull;
    if (uniform_pop) {
      const float popn = static_cast<float>(pop0);
      gate0 = (p0f - popn >= pop_lo) && (p1f + popn <= pop_hi) ? kFull : 0u;
      gate1 = (p1f - popn >= pop_lo) && (p0f + popn <= pop_hi) ? kFull : 0u;
    }
    uint32_t cnt = 0;  // b_count | cut_count << 16
    uint32_t cand[WPL];
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      cand[j] = 0u;
      if (lane + 32 * j >= nw) continue;
      const int o = 32 * j;
      const uint32_t b = b_l[o];
      const uint32_t x_e = b ^ __funnelshift_r(b, b_l[o + 1], 1);
      const uint32_t x_w = b ^ __funnelshift_l(b_l[o - 1], b, 1);
      // rows below (s0, s1) and above (n0, n1), each two words
      const uint32_t s0 = b_s[WMOD == 1 ? o - 1 : o];
      const uint32_t s1 = b_s[WMOD == 1 ? o : o + 1];
      const uint32_t n0 = b_n[WMOD == 1 ? o : o - 1];
      const uint32_t n1 = b_n[WMOD == 1 ? o + 1 : o];
      uint32_t nb_s, nb_n;  // the cells w below and w above
      if (WMOD == 1) {
        nb_s = s1;
        nb_n = n0;
      } else {
        nb_s = __funnelshift_r(s0, s1, bo);
        nb_n = __funnelshift_l(n0, n1, bo);
      }
      const uint4 m = masks[lane + o];
      const uint32_t x_s = b ^ nb_s, x_n = b ^ nb_n;
      const uint32_t d_e = x_e & m.x, d_w = x_w & m.y;
      const uint32_t d_s = x_s & m.z, d_n = x_n & m.w;
      const uint32_t b_mask = d_e | d_w | d_s | d_n;
      cnt += __popc(b_mask) + ((__popc(d_e) + __popc(d_s)) << 16);
      if (!b_mask) continue;  // no boundary cell in the word: no candidate
      uint32_t cj = b_mask & ((b & gate1) | (~b & gate0));
      if (a.patch) {
        // the diagonal cells w - 1 and w + 1 below, w - 1 and w + 1 above
        uint32_t nb_sw, nb_se, nb_ne, nb_nw;
        if (WMOD == 1) {
          nb_sw = __funnelshift_r(s0, s1, 31);
          nb_se = __funnelshift_r(s1, b_s[o + 1], 1);
          nb_nw = __funnelshift_l(b_n[o - 1], n0, 1);
          nb_ne = __funnelshift_l(n0, n1, 31);
        } else if (WMOD == 2) {
          nb_sw = __funnelshift_r(s0, s1, 30);
          nb_se = s1;
          nb_nw = n0;
          nb_ne = __funnelshift_l(n0, n1, 30);
        } else {
          nb_sw = __funnelshift_r(s0, s1, bo - 1);
          nb_se = __funnelshift_r(s0, s1, bo + 1);
          nb_nw = __funnelshift_l(n0, n1, bo + 1);
          nb_ne = __funnelshift_l(n0, n1, bo - 1);
        }
        const uint32_t s_e = ~x_e & m.x, s_w = ~x_w & m.y;
        const uint32_t s_s = ~x_s & m.z, s_n = ~x_n & m.w;
        const uint32_t s_se = ~(b ^ nb_se) & m.z & m.x;
        const uint32_t s_sw = ~(b ^ nb_sw) & m.z & m.y;
        const uint32_t s_ne = ~(b ^ nb_ne) & m.w & m.x;
        const uint32_t s_nw = ~(b ^ nb_nw) & m.w & m.y;
        const uint32_t r_e = s_e & ~(s_ne & s_n), r_s = s_s & ~(s_se & s_e);
        const uint32_t r_w = s_w & ~(s_sw & s_s), r_n = s_n & ~(s_nw & s_w);
        cj &= at_most_one(s_e, s_s, s_w, s_n) |
              at_most_one(r_e, r_s, r_w, r_n);
      }
      cand[j] = cj;
    }

    // ---- compaction: candidate groups of 4 into the warp's list --------
    // first the nonzero candidate words (a ballot per word slot), then 4
    // words a pass, one lane per group of 4 cells, a ballot for the slots
    int n_words = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      const unsigned nz = __ballot_sync(kFull, cand[j] != 0u);
      if (cand[j]) {
        const int at = n_words + __popc(nz & lanes_below);
        wcand[at] = cand[j];
        wk[at] = static_cast<uint16_t>(lane + 32 * j);
      }
      n_words += __popc(nz);
    }
    __syncwarp();
    int total = 0;
    for (int p = 0; p < n_words; p += 4) {
      const int e = p + (lane >> 3), g = lane & 7;
      const uint32_t cells = e < n_words ? (wcand[e] >> (4 * g)) & 0xFu : 0u;
      const unsigned has = __ballot_sync(kFull, cells != 0u);
      if (cells)
        list[total + __popc(has & lanes_below)] =
            static_cast<uint16_t>(((8 * wk[e] + g) << 4) | cells);
      total += __popc(has);
    }
    __syncwarp();

    // ---- draws for valid cells only, and the lane's best key ----------
    uint32_t best_score = 0u, best_cell = kFull;
    for (int e = lane; e < total; e += 32) {
      const uint32_t ent = list[e];
      const int q = int(ent >> 4);
      uint32_t valid = ent & 0xFu;
      if (!uniform_pop) {
        const uint32_t dist4 = (B[q >> 3] >> ((q & 7) * 4)) & 0xFu;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!((valid >> i) & 1u)) continue;
          const float popn = static_cast<float>(__ldg(a.pop + 4 * q + i));
          const bool one = (dist4 >> i) & 1u;
          const float pop_of = one ? p1f : p0f, pop_to = one ? p0f : p1f;
          const bool ok =
              (pop_of - popn >= pop_lo) && (pop_to + popn <= pop_hi);
          valid &= ~(uint32_t(!ok) << i);
        }
      }
      if (!valid) continue;
      uint32_t words[4];
      if (host_bits) {
        const uint32_t* row = a.bits_plane + ((size_t)t * C + c) * n + 4 * q;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          words[i] = ((valid >> i) & 1u) ? row[i] : 0u;
      } else {
        const Philox4 r =
            philox4x32_10(q, t, a.chunk_idx, kStreamPlane, a.key0.r, c);
#pragma unroll
        for (int i = 0; i < 4; ++i) words[i] = r.v[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!((valid >> i) & 1u)) continue;
        const uint32_t score = words[i] | 1u;
        const uint32_t cell = 4 * q + i;
        if (score > best_score || (score == best_score && cell < best_cell)) {
          best_score = score;
          best_cell = cell;
        }
      }
    }
    const uint32_t top = __reduce_max_sync(kFull, best_score);
    const uint32_t first =
        __reduce_min_sync(kFull, best_score == top ? best_cell : kFull);
    cnt = __reduce_add_sync(kFull, cnt);

    // ---- tail: wait, record, accept, commit (warp-uniform) ------------
    const int b_count = int(cnt & 0xFFFFu), cut_count = int(cnt >> 16);
    const float lw = __shfl_sync(kFull, log_w, t & 31);
    const float la = __shfl_sync(kFull, log_a, t & 31);
    if (a.geom_waits && pending) {
      const float p = static_cast<float>(b_count) / denom;
      const float wn = floorf(lw / log1pf(-p));
      cur_wait = wn > 0.f ? wn : 0.f;
    }
    if (lane == 0) {
      const size_t row = (size_t)t * C + c;
      a.h_cut[row] = cut_count;
      a.h_b[row] = b_count;
      a.h_wait[row] = cur_wait;
      a.h_acc[row] = acc_cnt;
      a.log_f[row] = cur_flip;
      a.log_s[row] = cur_sign;
    }
    waits_sum += cur_wait;

    const bool any_valid = top != 0u;
    const int idx = any_valid ? int(first) : 0;
    const uint32_t d_from = bit_at(B, idx);
    const int xi = idx / w, yi = idx - xi * w;
    const bool has[4] = {yi < w - 1, yi > 0, xi < a.h - 1, xi > 0};
    const int nbr[4] = {idx + 1, idx - 1, idx + w, idx - w};
    int same_rook = 0;
#pragma unroll
    for (int d = 0; d < 4; ++d)
      same_rook += has[d] && bit_at(B, nbr[d]) == d_from;
    const int deg_at = has[0] + has[1] + has[2] + has[3];  // rook degree
    const int dcut = deg_at - 2 * (deg_at - same_rook);
    const float log_bound = -beta * static_cast<float>(dcut) * log_base;
    const bool accept = any_valid && (la < log_bound);
    if (accept) {
      // cut_times events for the edges E, W, S, N of idx, lane d for edge d
      const bool was_flipped = bit_at(flipped, idx);
      int32_t* slot_ptr = nullptr;
      int32_t val = 0;
      const int nb = lane == 0 ? nbr[0] : lane == 1 ? nbr[1]
                   : lane == 2 ? nbr[2] : nbr[3];
      const bool edge = lane == 0 ? has[0] : lane == 1 ? has[1]
                      : lane == 2 ? has[2] : lane == 3 && has[3];
      if (edge) {
        const bool nb_flipped = bit_at(flipped, nb);
        const int last_i = was_flipped ? a.last_flip[base + idx] : 0;
        const int last_n = nb_flipped ? a.last_flip[base + nb] : 0;
        const int last = last_i > last_n ? last_i : last_n;
        slot_ptr = (lane & 2 ? a.cut_s : a.cut_e) + base +
                   (lane & 1 ? nb : idx);
        const int acc_old = (was_flipped || nb_flipped) ? *slot_ptr : 0;
        val = acc_old + int(d_from != bit_at(B, nb)) * (t + 1 - last);
      }
      __syncwarp();
      if (slot_ptr) *slot_ptr = val;
      if (lane == 0) {
        a.last_flip[base + idx] = t + 1;
        flipped[idx >> 5] |= 1u << (idx & 31);
        B[idx >> 5] ^= 1u << (idx & 31);
      }
      const int popv = __ldg(a.pop + idx);
      dp0 += d_from == 0 ? -popv : popv;
      dp1 += d_from == 0 ? popv : -popv;
      cur_flip = idx;
      cur_sign = 1 - 2 * int(1u - d_from);
    }
    pending = accept;
    acc_cnt += accept;
    exh_cnt += !any_valid;
    __syncwarp();
  }

  // ---- chunk end: board out, cut_times closed at T ----------------------
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    if (i >= n) break;
    const uint32_t v = bit_at(B, i);
    a.board_out[base + i] = static_cast<int8_t>(v);
    const bool fi = bit_at(flipped, i);
    const int last_i = fi ? a.last_flip[base + i] : 0;
#pragma unroll
    for (int d = 0; d < 2; ++d) {  // E, S
      const bool exists = ((d ? masks[k].z : masks[k].x) >> lane) & 1u;
      int32_t* out = (d ? a.cut_s : a.cut_e) + base + i;
      int32_t total = 0;
      if (exists) {
        const int nb = i + (d ? w : 1);
        const bool fn = bit_at(flipped, nb);
        const int last_n = fn ? a.last_flip[base + nb] : 0;
        const int last = last_i > last_n ? last_i : last_n;
        total = ((fi || fn) ? *out : 0) +
                int(v != bit_at(B, nb)) * (T - last);
      }
      *out = total;
    }
  }
  if (lane == 0) {
    const int accepted = acc_cnt - a.ints_in[5 * C + c];
    a.dist_pop_out[c] = dp0;
    a.dist_pop_out[C + c] = dp1;
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[7] = {pending, cur_flip, cur_sign,
                         a.ints_in[3 * C + c] + T,
                         a.ints_in[4 * C + c] + accepted, acc_cnt, exh_cnt};
#pragma unroll
    for (int j = 0; j < 7; ++j) a.ints_out[j * C + c] = ints[j];
  }
}

template <int WPL, int WMOD>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Layout<WPL>::kBytes;
  // the largest shared-memory carveout: at 64 x 64 four blocks need ~165
  // KB of an SM's shared memory, one KB past the carveout CUDA would
  // otherwise pick, and a fourth block is what fits 4096 chains in a wave
  cudaError_t err = cudaFuncSetAttribute(
      board_chunk_kernel<WPL, WMOD>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(board_chunk_kernel<WPL, WMOD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (a.n_chains + kChainsPerBlock - 1) / kChainsPerBlock;
  board_chunk_kernel<WPL, WMOD><<<blocks, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int WPL>
int launch_w(const Args& a, cudaStream_t stream) {
  switch (a.w & 31) {
    case 0: return launch<WPL, 1>(a, stream);
    case 31: return launch<WPL, 2>(a, stream);
    default: return launch<WPL, 0>(a, stream);
  }
}

}  // namespace

extern "C" {

// The first version's interface plus last_flip, a (C, N) int32 scratch
// plane that the kernel reads only where it wrote it in the same launch.
// deg must be the grid's rook degree (cuda_board.make_static_inputs
// checks it); the kernel derives it from (h, w) and does not read it.
int fce_board_chunk(const int8_t* board_in, const int32_t* pop,
                    const int32_t* /*deg*/, const int32_t* dist_pop_in,
                    const float* scal_in, const int32_t* ints_in,
                    const uint32_t* bits_plane, const uint32_t* bits_scal,
                    int8_t* board_out, int32_t* dist_pop_out, float* scal_out,
                    int32_t* ints_out, int32_t* log_f, int32_t* log_s,
                    int32_t* h_cut, int32_t* h_b, float* h_wait,
                    int32_t* h_acc, int32_t* cut_e, int32_t* cut_s,
                    int32_t* last_flip, int n_chains, int h, int w,
                    int t_inner, int patch, int geom_waits,
                    unsigned int seed, unsigned int chunk_idx, void* stream) {
  const Args a{board_in,   pop,       dist_pop_in, scal_in,
               ints_in,    bits_plane, bits_scal,  board_out,
               dist_pop_out, scal_out, ints_out,   log_f,
               log_s,      h_cut,     h_b,         h_wait,
               h_acc,      cut_e,     cut_s,       last_flip,
               n_chains,   h,         w,           t_inner,
               patch,      geom_waits, chunk_idx,  fce::philox_key0(seed)};
  const int nw = (h * w + 31) >> 5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chains < 1 || h < 1 || w < 1 || t_inner < 1 || nw > 512)
    return int(cudaErrorInvalidValue);
  if (nw <= 32) return launch_w<1>(a, s);
  if (nw <= 64) return launch_w<2>(a, s);
  if (nw <= 128) return launch_w<4>(a, s);
  if (nw <= 256) return launch_w<8>(a, s);
  return launch_w<16>(a, s);
}

}  // extern "C"
