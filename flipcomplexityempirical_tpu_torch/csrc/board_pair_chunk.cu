// Board pair-chunk kernel: t_inner steps of the k-district pair walk on a
// plain rook grid (slow_reversible_propose semantics,
// grid_chain_sec11.py:117-130), one warp per chain, the board a byte a
// cell in shared memory.
//
// Replaces the JAX package's packed pair scan,
// flipcomplexityempirical_tpu/kernel/board.py::_scan_bits_pair (:1406), and
// its bit-identical int8 form (_planes_pair :949, _transition_pair :1017),
// which the JAX package runs at any width (its packed form wants
// w % 32 == 0). On the TPU these bodies are XLA code fused per scan step,
// not Pallas kernels; replayed as torch ops (the plain version) a step is
// dozens of small launches. Here one launch runs the whole chunk. It is
// bit-equal to its plain version
// (kernel/cuda_board_pair.py::board_pair_chunk_reference) on every output,
// and draws the JAX package's own threefry2x32 stream: split(key, 4) per
// step, uniform() of each subkey, exactly as rng.py and jax.random do.
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
// lose a unit, the neighbour's may gain one: per-chain district bitmasks,
// a uniform population).
//
// Resident slots. A slot byte a cell, in shared memory beside the board:
// bits 0..3 the pair slots E, S, W, N, bit 4 the contiguity verdict (all
// ones under contiguity 'none'). Both depend only on the cell's 3 x 3
// block, so after a committed flip at f lanes 0..8 recompute the bytes of
// f's 3 x 3 block; the chunk's start fills every cell's.
//
// Per step and chain (the order of the JAX scan body):
//   1. the step's draws: every 32 steps one batch runs the key chain
//      (split counter 0 of each step's key) serially and then, lane i for
//      the batch's step i, the subkeys (split counters 1, 2, 3), their
//      uniforms and the logs that the accept test and the wait take; a
//      step reads its lane's values by shuffles;
//   2. the gates: lane d < k holds district d's population, two ballots
//      make the from / to bitmasks (f32 compares, as the JAX body);
//   3. the word pass: each lane owns a contiguous run of slot words (4
//      cells a word, the valid nibbles masked by the contiguity bit; where
//      a gate fails for some district, each boundary cell's district and
//      its slots' neighbours are looked up), the distinct-pair count a
//      popcount, one warp scan of the valid counts;
//   4. complete the pending wait from the pair count (denominator
//      n**k - 1 in f32), record the row (lane r < 6 writes row r): cut, b,
//      wait, accepts, the flip-log pair;
//   5. select the m-th valid slot in the row-major (node, direction) order
//      flat4 = v * 4 + j, m = min(int(u * total), total - 1) in f32 (the
//      JAX package's _pick_row), from the scan; dcut from v's rook
//      neighbourhood; accept by the literal base**(-dcut) bound with the
//      chain's beta (or always); commit, and bring the 3 x 3 block's slot
//      bytes up to date. An empty valid set commits nothing.
// cut_times by events, as lowered_chunk.cu does: an edge's cut state can
// change only when one of its ends flips, so an accepted flip at step t
// closes its (up to 4) edges' runs, acc += cut_old * (t + 1 - last), and
// the chunk's end adds cut_now * (T - last) to every edge of the E and S
// planes, "last" the later of the two ends' last flip steps. A (C, N)
// int32 scratch plane holds the last flip steps and a per-chain bit plane
// in shared memory marks the cells flipped in the chunk, so neither is
// initialised and only flipped cells are read.
//
// Traps the code keeps:
//   - the slot order is flat4 = v * 4 + j with j = E, S, W, N, and a
//     direction is dropped when an earlier existing neighbour holds the
//     same district (within a word of four cells, bit 8 * b + j: the bit
//     order is the slot order);
//   - b counts the deduplicated slots before the contiguity and
//     population gates;
//   - cur_sign is the label of d_to among k labels;
//   - with an empty valid set nothing is committed (the JAX body selects
//     slot 0 and rejects);
//   - float steps in the JAX order, built with -fmad=false (no
//     contraction): logf, log1pf and IEEE division, the device functions
//     torch's CUDA ops call, so the plain version on the card agrees bit
//     for bit.
//
// What bounds it on an H100: instruction issue and a step's latency, not
// memory. Device memory carries the board in and out, the two cut planes
// out and the (T, C) rows; a chain-step reads ceil(N / 4) slot words from
// shared memory (32 a lane at 64 x 64). A simple first design: the
// selection rescans every slot word each step. chip_smoke.py reports the
// byte bound beside the measured time.
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
constexpr int kChainsPerBlock = 8;
constexpr int kThreads = 32 * kChainsPerBlock;
constexpr int kMaxCells = 4096;
constexpr uint32_t kSlotMask = 0x0F0F0F0Fu;

struct Args {
  const int8_t* board_in;      // (C, N) districts 0..k-1
  const int32_t* key_in;       // (2, C) uint32 key words
  const int32_t* dist_pop_in;  // (k, C)
  const float* scal_in;        // (6, C): log_base, beta, pop_lo, pop_hi,
                               //         cur_wait, waits_sum
  const int32_t* ints_in;      // (8, C): pending, flip, sign, t_yield,
                               //   move_clock, accepts, exhausted, cut_count
  const int32_t* labels;       // (k,) district labels
  int8_t* board_out;
  int32_t* key_out;
  int32_t* dist_pop_out;
  float* scal_out;             // (2, C): cur_wait, waits_sum
  int32_t* ints_out;           // (8, C)
  int32_t* log_f;              // (T, C) rows
  int32_t* log_s;
  int32_t* h_cut;
  int32_t* h_b;
  float* h_wait;
  int32_t* h_acc;
  int32_t* cut_planes;         // (2, C, N): E, S chunk counts
  int32_t* last_flip;          // (C, N) scratch, read only where flipped
  int n_chains, h, w, k, t_inner;
  int patch, geom_waits, accept_always, unit_pop;
  float denom;                 // n**k - 1 in f32
};

// Shared memory of a chain, in bytes (a multiple of 16): the board (N
// bytes), the slot words (ceil(N / 4) of them, one pad word after every 32
// so that the lanes' contiguous runs fall in different banks) and the
// flipped plane (ceil(N / 32) words).
struct Layout {
  int n, slot_words, board_bytes, slot_bytes, flip_bytes, chain;
  __host__ __device__ explicit Layout(int n_) : n(n_) {
    slot_words = (n + 3) >> 2;
    board_bytes = (n + 15) & ~15;
    slot_bytes = ((4 * (slot_words + slot_words / 32 + 1)) + 15) & ~15;
    flip_bytes = ((4 * ((n + 31) >> 5)) + 15) & ~15;
    chain = board_bytes + slot_bytes + flip_bytes;
  }
};

// the slot word q at its padded place
__device__ __forceinline__ int slot_at(int q) { return q + (q >> 5); }

__device__ __forceinline__ int dir_off(int j, int w) {
  return j == 0 ? 1 : j == 1 ? w : j == 2 ? -1 : -w;
}

// The slot byte of cell v = r * w + c (header): the deduplicated pair
// slots E, S, W, N in bits 0..3, the ring contiguity verdict in bit 4.
__device__ __forceinline__ uint32_t cell_slots(const uint8_t* B, int v, int r,
                                               int c, int h, int w,
                                               bool patch) {
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
  return uint32_t(pE) | uint32_t(pS) << 1 | uint32_t(pW) << 2 |
         uint32_t(pN) << 3 | uint32_t(contig) << 4;
}

// the slots of word q (cells 4q .. 4q + 3, nibble b at bits 8b..8b+3)
// that pass the population gates, where some gate fails
__device__ __forceinline__ uint32_t gate_word(uint32_t v, const uint8_t* B,
                                              int q, int w,
                                              uint32_t from_bits,
                                              uint32_t to_bits) {
  uint32_t out = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t nib = (v >> (8 * b)) & 0xFu;
    if (!nib) continue;
    const int cell = 4 * q + b;
    if (!((from_bits >> B[cell]) & 1u)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (((nib >> j) & 1u) && ((to_bits >> B[cell + dir_off(j, w)]) & 1u))
        out |= 1u << (8 * b + j);
  }
  return out;
}

// WPL: slot words a lane (a power of two, >= ceil(ceil(N / 4) / 32))
template <int WPL>
__global__ void __launch_bounds__(kThreads, 2)
    board_pair_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int h = a.h, w = a.w, n = h * w, C = a.n_chains, T = a.t_inner;
  const int K = a.k;
  const Layout L(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kChainsPerBlock + warp;
  if (c >= C) return;
  uint8_t* B = smem + (size_t)warp * L.chain;
  uint32_t* S = reinterpret_cast<uint32_t*>(B + L.board_bytes);
  uint8_t* Sb = reinterpret_cast<uint8_t*>(S);
  uint32_t* flipped = reinterpret_cast<uint32_t*>(B + L.board_bytes +
                                                  L.slot_bytes);
  const size_t base = (size_t)c * n;
  const bool patch = a.patch != 0;

  // ---- the chunk's first board and its slot bytes ----------------------
  for (int i = lane; i < L.board_bytes; i += 32)
    B[i] = i < n ? static_cast<uint8_t>(a.board_in[base + i]) : 0u;
  for (int i = lane; i < L.slot_bytes / 4; i += 32) S[i] = 0u;
  for (int i = lane; i < L.flip_bytes / 4; i += 32) flipped[i] = 0u;
  __syncwarp();
  for (int v = lane; v < n; v += 32) {
    const int r = v / w, cc = v - r * w;
    Sb[4 * slot_at(v >> 2) + (v & 3)] =
        static_cast<uint8_t>(cell_slots(B, v, r, cc, h, w, patch));
  }
  __syncwarp();

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
  const float unitf = static_cast<float>(a.unit_pop);
  const uint32_t all_d = K >= 32 ? kFull : (1u << K) - 1u;
  const int q0 = lane * WPL;  // this lane's first slot word
  // lane r < 6 writes row r: cut, b, wait, accepts, the flip-log pair
  int32_t* const my_row = lane == 0   ? a.h_cut
                          : lane == 1 ? a.h_b
                          : lane == 2 ? reinterpret_cast<int32_t*>(a.h_wait)
                          : lane == 3 ? a.h_acc
                          : lane == 4 ? a.log_f
                                      : a.log_s;
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

    // ---- 2. the population gates as district bitmasks -----------------
    const float dpf = static_cast<float>(dp);
    const uint32_t from_bits =
        __ballot_sync(kFull, lane < K && dpf - unitf >= pop_lo);
    const uint32_t to_bits =
        __ballot_sync(kFull, lane < K && dpf + unitf <= pop_hi);
    const bool all_pass = from_bits == all_d && to_bits == all_d;

    // ---- 3. the word pass ---------------------------------------------
    uint32_t val[WPL];
    int bcnt = 0, my_cnt = 0;
#pragma unroll
    for (int i = 0; i < WPL; ++i) {
      const int q = q0 + i;
      val[i] = 0u;
      if (q < L.slot_words) {
        const uint32_t sw = S[slot_at(q)];
        const uint32_t slots = sw & kSlotMask;
        bcnt += __popc(slots);
        uint32_t v = slots & (((sw >> 4) & 0x01010101u) * 0xFu);
        if (!all_pass && v) v = gate_word(v, B, q, w, from_bits, to_bits);
        val[i] = v;
        my_cnt += __popc(v);
      }
    }
    const int b_count = __reduce_add_sync(kFull, bcnt);
    const int incl = incl_scan(my_cnt, lane);
    const int total = __shfl_sync(kFull, incl, 31);

    // ---- 4. wait, record (lane r < 6 writes row r) ----------------------
    if (a.geom_waits && pending) {
      const float p = static_cast<float>(b_count) / a.denom;
      cur_wait = fmaxf(floorf(log_wait / log1pf(-p)), 0.f);
    }
    if (lane < 6) {
      const int v = lane == 0   ? cut_count
                    : lane == 1 ? b_count
                    : lane == 2 ? __float_as_int(cur_wait)
                    : lane == 3 ? acc_cnt
                    : lane == 4 ? cur_flip
                                : cur_sign;
      my_row[(size_t)t * C + c] = v;
    }
    waits_sum += cur_wait;

    // ---- 5. select the m-th valid slot, accept, commit --------------------
    const bool any_valid = total > 0;
    exh_cnt += !any_valid;
    bool accept = false;
    if (any_valid) {
      int m = static_cast<int>(u_prop * static_cast<float>(total));
      m = min(m, total - 1);
      int found = -1;
      int r = m - (incl - my_cnt);
      if (r >= 0 && r < my_cnt) {
#pragma unroll
        for (int i = 0; i < WPL; ++i) {
          const int ci = __popc(val[i]);
          if (found < 0) {
            if (r < ci)
              found = 32 * (q0 + i) + nth_bit(val[i], r);
            else
              r -= ci;
          }
        }
      }
      const unsigned here = __ballot_sync(kFull, found >= 0);
      const int id = __shfl_sync(kFull, found, __ffs(here) - 1);
      const int flat = id >> 3, j = id & 7;
      const int fr = flat / w, fc = flat - fr * w;
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
      if (accept) {
        // cut_times events for flat's edges (lane jj < 4: direction jj):
        // the loads now, the stores after the board's update
        bool edge = false, old_cut = false;
        int last = 0, acc_old = 0;
        int32_t* slot_ptr = nullptr;
        if (lane < 4) {
          edge = lane == 0 ? fc < w - 1 : lane == 1 ? fr < h - 1
                 : lane == 2 ? fc > 0 : fr > 0;
          if (edge) {
            const int nb = flat + dir_off(lane, w);
            old_cut = B[nb] != d_from;
            const bool fi = bit_at(flipped, flat), fn = bit_at(flipped, nb);
            const int li = fi ? a.last_flip[base + flat] : 0;
            const int ln = fn ? a.last_flip[base + nb] : 0;
            last = li > ln ? li : ln;
            // E and S edges live at flat, W and N at the neighbour
            const int at = lane < 2 ? flat : nb;
            slot_ptr = a.cut_planes + ((size_t)(lane & 1) * C) * n + base + at;
            if (fi || fn) acc_old = *slot_ptr;
          }
        }
        __syncwarp();
        if (lane == 0) {
          B[flat] = static_cast<uint8_t>(d_to);
          flipped[flat >> 5] |= 1u << (flat & 31);
        }
        __syncwarp();
        // the slot bytes of flat's 3 x 3 block
        if (lane < 9) {
          const int rr = fr + lane / 3 - 1, cc = fc + lane % 3 - 1;
          if (rr >= 0 && rr < h && cc >= 0 && cc < w) {
            const int v = rr * w + cc;
            Sb[4 * slot_at(v >> 2) + (v & 3)] =
                static_cast<uint8_t>(cell_slots(B, v, rr, cc, h, w, patch));
          }
        }
        if (edge) *slot_ptr = acc_old + int(old_cut) * (t + 1 - last);
        __syncwarp();
        // after every lane's loads of it have returned (the stores above)
        if (lane == 0) a.last_flip[base + flat] = t + 1;
        const int unit = a.unit_pop;
        if (lane == d_to) dp += unit;
        if (lane == d_from) dp -= unit;
        cut_count += dcut;
        cur_flip = flat;
        cur_sign = __ldg(a.labels + d_to);
      }
    }
    pending = accept;
    move_clock += accept;
    acc_cnt += accept;
    __syncwarp();
  }

  // ---- chunk end: board out, cut planes closed at T ---------------------
  for (int i = lane; i < n; i += 32) {
    const int v = B[i];
    a.board_out[base + i] = static_cast<int8_t>(v);
    const int r = i / w, cc = i - r * w;
    const bool fi = bit_at(flipped, i);
    const int last_i = fi ? a.last_flip[base + i] : 0;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      int32_t* out = a.cut_planes + ((size_t)d * C) * n + base + i;
      int32_t tot = 0;
      if (d == 0 ? cc < w - 1 : r < h - 1) {
        const int nb = i + (d == 0 ? 1 : w);
        const bool fn = bit_at(flipped, nb);
        const int last_n = fn ? a.last_flip[base + nb] : 0;
        const int last = last_i > last_n ? last_i : last_n;
        tot = ((fi || fn) ? *out : 0) + int(v != B[nb]) * (T - last);
      }
      *out = tot;
    }
  }
  if (lane < K) a.dist_pop_out[lane * C + c] = dp;
  if (lane == 0) {
    a.key_out[c] = static_cast<int32_t>(key0);
    a.key_out[C + c] = static_cast<int32_t>(key1);
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[8] = {pending, cur_flip, cur_sign, a.ints_in[3 * C + c] + T,
                         move_clock, acc_cnt, exh_cnt, cut_count};
#pragma unroll
    for (int q = 0; q < 8; ++q) a.ints_out[q * C + c] = ints[q];
  }
}

template <int WPL>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = board_pair_chunk_kernel<WPL>;
  const size_t smem = size_t(kChainsPerBlock) * Layout(a.h * a.w).chain;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (a.n_chains + kChainsPerBlock - 1) / kChainsPerBlock;
  kern<<<blocks, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// slot words a lane, rounded up to a power of two
int words_per_lane(int n) {
  const int per = (((n + 3) >> 2) + 31) >> 5;
  int wpl = 1;
  while (wpl < per) wpl <<= 1;
  return wpl;
}

template <int WPL>
const void* kernel_of() {
  return reinterpret_cast<const void*>(board_pair_chunk_kernel<WPL>);
}

const void* kernel_for(int n) {
  switch (words_per_lane(n)) {
    case 1: return kernel_of<1>();
    case 2: return kernel_of<2>();
    case 4: return kernel_of<4>();
    case 8: return kernel_of<8>();
    case 16: return kernel_of<16>();
    default: return kernel_of<32>();
  }
}

}  // namespace

extern "C" {

// One chunk for every chain; returns a cudaError_t.
int fce_board_pair_chunk(
    const int8_t* board_in, const int32_t* key_in, const int32_t* dist_pop_in,
    const float* scal_in, const int32_t* ints_in, const int32_t* labels,
    int8_t* board_out, int32_t* key_out, int32_t* dist_pop_out,
    float* scal_out, int32_t* ints_out, int32_t* log_f, int32_t* log_s,
    int32_t* h_cut, int32_t* h_b, float* h_wait, int32_t* h_acc,
    int32_t* cut_planes, int32_t* last_flip, int n_chains, int h, int w,
    int k, int t_inner, int patch, int geom_waits, int accept_always,
    int unit_pop, float denom, void* stream) {
  Args a;
  a.board_in = board_in; a.key_in = key_in; a.dist_pop_in = dist_pop_in;
  a.scal_in = scal_in; a.ints_in = ints_in; a.labels = labels;
  a.board_out = board_out; a.key_out = key_out;
  a.dist_pop_out = dist_pop_out; a.scal_out = scal_out;
  a.ints_out = ints_out; a.log_f = log_f; a.log_s = log_s; a.h_cut = h_cut;
  a.h_b = h_b; a.h_wait = h_wait; a.h_acc = h_acc;
  a.cut_planes = cut_planes; a.last_flip = last_flip;
  a.n_chains = n_chains; a.h = h; a.w = w; a.k = k; a.t_inner = t_inner;
  a.patch = patch; a.geom_waits = geom_waits;
  a.accept_always = accept_always; a.unit_pop = unit_pop; a.denom = denom;
  if (n_chains < 1 || h < 3 || w < 3 || h * w > kMaxCells || k < 2 ||
      k > 31 || t_inner < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (words_per_lane(h * w)) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    case 16: return launch<16>(a, s);
    default: return launch<32>(a, s);
  }
}

// The launch shape at n cells: out[0] shared memory a block (bytes),
// out[1] chains a block, out[2] blocks resident an SM, out[3] threads a
// block, out[4] a chain's shared memory (bytes), out[5] slot words a lane.
int fce_board_pair_shape(int n, int* out) {
  if (n < 9 || n > kMaxCells) return int(cudaErrorInvalidValue);
  const Layout L(n);
  const size_t smem = size_t(kChainsPerBlock) * L.chain;
  const void* kern = kernel_for(n);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return int(err);
  out[0] = int(smem);
  out[1] = kChainsPerBlock;
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = L.chain;
  out[5] = words_per_lane(n);
  return 0;
}

}  // extern "C"
