// Device helpers shared by the chunk kernels that draw the JAX package's
// threefry2x32 stream (lowered_chunk.cu, general_dense_chunk.cu,
// general_pair_chunk.cu): the threefry block and the f32 uniform of
// jax.random (rng.py holds their torch twins), the batched per-step draws
// of split(key, 4), small bit-plane and warp helpers, the layout of the
// packed graph tables the two general kernels read (staged into shared
// memory by one bulk copy, or read through L1), the mbarrier operations of
// the hand-offs between warps in shared memory (the draws ring of a chain's
// producer warp, the table copy, summary_fold.cuh's fold ring), and the
// chunk-start copy of the fields the general kernels update in place.

#pragma once

#include <cmath>
#include <cstdint>

namespace fce {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32, 20 rounds, key (k0, k1), counter (x0, x1) in place: the
// block of jax.random's threefry2x32_p (rng.py::threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define FCE_ROUND(r) \
  x0 += x1;          \
  x1 = rotl(x1, r) ^ x0;
  FCE_ROUND(13) FCE_ROUND(15) FCE_ROUND(26) FCE_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  FCE_ROUND(17) FCE_ROUND(29) FCE_ROUND(16) FCE_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  FCE_ROUND(13) FCE_ROUND(15) FCE_ROUND(26) FCE_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  FCE_ROUND(17) FCE_ROUND(29) FCE_ROUND(16) FCE_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  FCE_ROUND(13) FCE_ROUND(15) FCE_ROUND(26) FCE_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef FCE_ROUND
}

// jax.random.uniform's f32 in [0, 1) from 32 random bits: 23 bits as the
// mantissa of [1, 2), minus 1 (exact)
__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ uint32_t bit_at(const uint32_t* words, int i) {
  return (words[i >> 5] >> (i & 31)) & 1u;
}

// set or clear bit i of a shared plane; lanes may share a word
__device__ __forceinline__ void put_bit(uint32_t* words, int i, bool v) {
  const uint32_t m = 1u << (i & 31);
  if (v)
    atomicOr(words + (i >> 5), m);
  else
    atomicAnd(words + (i >> 5), ~m);
}

// position of the r-th (from 0) set bit of x, r < popc(x)
__device__ __forceinline__ int nth_bit(uint32_t x, int r) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int low = __popc(x & ((1u << s) - 1u));
    if (r >= low) {
      r -= low;
      x >>= s;
      pos += s;
    }
  }
  return pos;
}

// inclusive prefix sum of x over the warp's lanes
__device__ __forceinline__ int incl_scan(int x, int lane) {
#pragma unroll
  for (int dd = 1; dd < 32; dd <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, dd);
    if (lane >= dd) x += y;
  }
  return x;
}

// The packed graph tables of kernel/cuda_dense.py::pack_tables, read by
// general_dense_chunk.cu and general_pair_chunk.cu: patch adjacency
// bitsets (N, Pp) as uint32 and patch slots (N, Pp) as uint16, rows of
// Pp = P rounded up to 8 slots (16-byte aligned: a row is a few vector
// loads; pads hold the node itself and no adjacency), then neighbour edges
// (N, D) as uint32, each node's real patch slots (N,) as a uint32 mask,
// neighbour slots (N, D) as uint16, degrees (N,) as uint8 and, for patch
// slot s of u, the slot of u in the patch of that node (N, Pp) as uint8;
// padded to 16 bytes. The byte offset of each table and the total.
struct TableLayout {
  size_t padj, pn, nedge, slots, nbr, deg, rev, bytes;
  int pp;
};

__host__ __device__ inline TableLayout table_layout(int n, int d, int p) {
  TableLayout l;
  l.pp = (p + 7) & ~7;
  l.padj = 0;
  l.pn = l.padj + 4 * size_t(n) * l.pp;
  l.nedge = l.pn + 2 * size_t(n) * l.pp;
  l.slots = l.nedge + 4 * size_t(n) * d;
  l.nbr = l.slots + 4 * size_t(n);
  l.deg = l.nbr + 2 * size_t(n) * d;
  l.rev = l.deg + size_t(n);
  l.bytes = (l.rev + size_t(n) * l.pp + 15) & ~size_t(15);
  return l;
}

// A table read: shared memory when staged, through L1 otherwise.
template <bool kStaged, typename T>
__device__ __forceinline__ T ld(const T* p) {
  if constexpr (kStaged)
    return *p;
  else
    return __ldg(p);
}

// ---- mbarriers in shared memory ----------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra.uni DONE;\n\t"
      "bra.uni WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// whether the barrier's phase of this parity has completed, without
// waiting
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, P1;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0u;
}

// The threefry draws of up to 32 steps: the key chain (split counter 0 of
// each step's key) runs serially; lane i keeps the key of the batch's step
// i and then draws that step's subkeys (split counters 1, 2, 3: proposal,
// accept, wait), the uniform of each, and the logs that the accept test
// and the wait take of the last two, all lanes at once. The same blocks,
// and so the same stream, as splitting four ways every step. Out of line:
// it runs once every 32 steps.
struct Draws {
  uint32_t key0, key1, prop;
  float log_acc, log_wait;
};
__device__ __noinline__ Draws draw_batch(uint32_t key0, uint32_t key1,
                                         int steps) {
  const int lane = threadIdx.x & 31;
  uint32_t m0 = 0u, m1 = 0u;
  for (int i = 0; i < steps; ++i) {
    if (lane == i) {
      m0 = key0;
      m1 = key1;
    }
    uint32_t s0 = 0u, s1 = 0u;
    threefry2x32(key0, key1, s0, s1);
    key0 = s0;
    key1 = s1;
  }
  uint32_t p0 = 0u, p1 = 1u, q0 = 0u, q1 = 2u, r0 = 0u, r1 = 3u;
  threefry2x32(m0, m1, p0, p1);
  threefry2x32(m0, m1, q0, q1);
  threefry2x32(m0, m1, r0, r1);
  uint32_t a0 = 0u, a1 = 0u, b0 = 0u, b1 = 0u, c0 = 0u, c1 = 0u;
  threefry2x32(p0, p1, a0, a1);
  threefry2x32(q0, q1, b0, b1);
  threefry2x32(r0, r1, c0, c1);
  return Draws{key0, key1, a0 ^ a1,
               logf(fmaxf(uniform_of(b0 ^ b1), 1e-12f)),
               logf(fmaxf(uniform_of(c0 ^ c1), 1e-12f))};
}

// ---- the bulk copy ---------------------------------------------------
constexpr uint32_t kPiece = 32 * 1024;  // bytes a bulk copy

// one thread: copy `bytes` (a multiple of 16) from global to shared memory,
// completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  for (uint32_t o = 0; o < bytes; o += kPiece) {
    const uint32_t len = bytes - o < kPiece ? bytes - o : kPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(static_cast<char*>(dst) + o)),
        "l"(static_cast<const char*>(src) + o), "r"(len), "r"(smem_u32(bar))
        : "memory");
  }
}

// ---- a chain's draws on a producer warp ------------------------------
constexpr int kRing = 4;  // draw batches in flight

// The draws ring of a producer-mode block: kRing batches of 32 steps'
// (proposal bits, log accept uniform, log wait uniform), a full and an
// empty barrier each (initialised to 32 arrivals).
struct Ring {
  uint64_t full[kRing], empty[kRing];
  uint32_t prop[kRing][32];
  float log_acc[kRing][32], log_wait[kRing][32];
};

// The producer warp: chain c's key chain and uniforms (keys (2, C) in,
// the final key out), one batch of 32 steps after another, kRing batches
// ahead of the chain.
__device__ void produce_draws(const int32_t* key_in, int32_t* key_out, int C,
                              int T, Ring* ring, int c) {
  const int lane = threadIdx.x & 31;
  uint32_t key0 = static_cast<uint32_t>(key_in[c]);
  uint32_t key1 = static_cast<uint32_t>(key_in[C + c]);
  for (int q = 0; 32 * q < T; ++q) {
    const int slot = q % kRing;
    const Draws dr = draw_batch(key0, key1, min(32, T - 32 * q));
    key0 = dr.key0;
    key1 = dr.key1;
    // the producer runs ahead: it waits for a free slot with sleeps, so
    // that its polling leaves the chain's shared-memory accesses alone
    while (!mbar_test(&ring->empty[slot], ((q / kRing) & 1) ^ 1))
      __nanosleep(512);
    ring->prop[slot][lane] = dr.prop;
    ring->log_acc[slot][lane] = dr.log_acc;
    ring->log_wait[slot][lane] = dr.log_wait;
    mbar_arrive(&ring->full[slot]);
  }
  if (lane == 0) {
    key_out[c] = static_cast<int32_t>(key0);
    key_out[C + c] = static_cast<int32_t>(key1);
  }
}

// The chain's step t's draws from the ring (t a multiple of 32): lane i
// gets step t + i's; the slot is handed back at once.
__device__ __forceinline__ Draws take_draws(Ring* ring, int t) {
  const int lane = threadIdx.x & 31, q = t >> 5, s = q % kRing;
  mbar_wait(&ring->full[s], (q / kRing) & 1);
  Draws d{0u, 0u, ring->prop[s][lane], ring->log_acc[s][lane],
          ring->log_wait[s][lane]};
  mbar_arrive(&ring->empty[s]);
  return d;
}

// ---- the chunk start: the fields the general kernels update in place --
// Chain rows bn (of n) and be (of E) of part_sum, last_flipped, num_flips
// copied in to out, and cut_times + cut * T (each flip later adds its
// change), 16 bytes a lane between a row's first and last 16-byte
// boundaries (the arrays start on one) and the at most 3 + 3 fields either
// side one at a time.
__device__ __forceinline__ void copy_rows(
    const int32_t* part_sum_in, const int32_t* last_flipped_in,
    const int32_t* num_flips_in, const int32_t* cut_times_in,
    const int8_t* cut_in, int32_t* part_sum_out, int32_t* last_flipped_out,
    int32_t* num_flips_out, int32_t* cut_times_out, size_t bn, size_t be,
    int n, int E, int T) {
  const int lane = threadIdx.x & 31;
  const int nh = int((4 - (bn & 3)) & 3) < n ? int((4 - (bn & 3)) & 3) : n;
  const int n4 = (n - nh) >> 2;
  for (int i = lane; i < n4; i += 32) {
    const size_t at = ((bn + nh) >> 2) + i;
    reinterpret_cast<int4*>(part_sum_out)[at] =
        __ldg(reinterpret_cast<const int4*>(part_sum_in) + at);
    reinterpret_cast<int4*>(last_flipped_out)[at] =
        __ldg(reinterpret_cast<const int4*>(last_flipped_in) + at);
    reinterpret_cast<int4*>(num_flips_out)[at] =
        __ldg(reinterpret_cast<const int4*>(num_flips_in) + at);
  }
  for (int h = lane; h < nh + (n - nh - 4 * n4); h += 32) {
    const int i = h < nh ? h : h + 4 * n4;
    part_sum_out[bn + i] = part_sum_in[bn + i];
    last_flipped_out[bn + i] = last_flipped_in[bn + i];
    num_flips_out[bn + i] = num_flips_in[bn + i];
  }
  const int eh = int((4 - (be & 3)) & 3) < E ? int((4 - (be & 3)) & 3) : E;
  const int e4 = (E - eh) >> 2;
  for (int i = lane; i < e4; i += 32) {
    const size_t at = ((be + eh) >> 2) + i;
    int4 x = __ldg(reinterpret_cast<const int4*>(cut_times_in) + at);
    const char4 k = __ldg(reinterpret_cast<const char4*>(cut_in) + at);
    x.x += int(k.x) * T;
    x.y += int(k.y) * T;
    x.z += int(k.z) * T;
    x.w += int(k.w) * T;
    reinterpret_cast<int4*>(cut_times_out)[at] = x;
  }
  for (int h = lane; h < eh + (E - eh - 4 * e4); h += 32) {
    const int i = h < eh ? h : h + 4 * e4;
    cut_times_out[be + i] = cut_times_in[be + i] + int(cut_in[be + i]) * T;
  }
}

}  // namespace fce
