// Board-chunk kernel: t_inner steps of the 2-district flip chain on a
// plain H x W rook grid, one CUDA block per chain, board in shared memory.
//
// Replaces the TPU kernel flipcomplexityempirical_tpu/kernel/pallas_board.py
// ::_kernel (launched by run_pallas_chunk). It computes what that kernel
// computes, step by step and bit for bit given the same random bits:
//   - 8 "same district" neighbour bits per cell (rook + diagonal), with
//     boundary tests in place of the TPU roll masks;
//   - same/diff degree, the boundary mask, cut_e / cut_s, the ring
//     contiguity criterion and the population gate;
//   - block reductions for b_count, cut_count and the proposal: the
//     argmax of (bits | 1) over the valid set, first index on ties;
//   - one thread completes the pending geometric wait
//     floor(log u / log1p(-b / (n^2 - 1))), writes the history and
//     flip-log rows, takes the accept log u < -beta * dcut * log_base and
//     commits the flip.
//
// What bounds it on an H100: arithmetic and block synchronisation. Per
// chain and step it does ~60 integer operations on each of the N cells
// (~25 more for the Philox draw),
// two __syncthreads and a serial tail on one thread, against a few bytes
// of device memory traffic per cell per chunk (the board in and out, the
// cut_times planes out). The design keeps every per-step quantity on
// chip: the board lives in shared memory (with a guard band of W+1 cells
// on each side, so neighbour reads never leave it), each thread owns
// groups of 4 consecutive cells and keeps their cut_e / cut_s counts as
// two 16-bit halves of one register, and only the per-step (T, C) rows
// leave the chip. Packing 32 cells per word, as the JAX package's
// bit-board body does, is the redesign that would cut the per-cell work.
//
// Random bits: either read from (T, C, N) and (T, 2, C) uint32 planes
// (host-bits mode, for exactness checks at small shapes) or drawn here by
// Philox4x32-10 with key (seed, chain) and counter (cell / 4, step, chunk,
// stream) -- rng.py holds its torch twin.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py). No fast math: the
// float steps must round as the plain version's do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kStreamPlane = 0u;
constexpr uint32_t kStreamScalars = 1u;

// neighbour bits of a cell's meta word; deg sits in bits 8..11
constexpr uint32_t kE = 1u, kW = 2u, kS = 4u, kN = 8u;
constexpr uint32_t kSE = 16u, kSW = 32u, kNE = 64u, kNW = 128u;
constexpr uint32_t kActive = 1u << 12;

struct Philox4 {
  uint32_t v[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// uint32 -> f32 uniform in (0, 1): the top 24 bits, (x + 1) / 16777218
__device__ __forceinline__ float u01(uint32_t bits) {
  return (static_cast<float>(static_cast<int>(bits >> 8)) + 1.0f) *
         static_cast<float>(1.0 / 16777218.0);
}

struct Args {
  const int8_t* board_in;      // (C, N)
  const int32_t* pop;          // (N,)
  const int32_t* deg;          // (N,)
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
  int n_chains, h, w, t_inner, patch, geom_waits;
  uint32_t seed, chunk_idx;
};

template <int GROUPS>
__global__ void __launch_bounds__(512) board_chunk_kernel(const Args a) {
  extern __shared__ int8_t smem_board[];
  __shared__ uint32_t s_cnt[32];
  __shared__ unsigned long long s_best[32];
  __shared__ int s_dp[2];

  const int c = blockIdx.x;
  const int C = a.n_chains;
  const int w = a.w;
  const int n = a.h * a.w;
  const int tid = threadIdx.x;
  const int bd = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = bd >> 5;
  int8_t* sb = smem_board + (w + 1);  // guard band of w+1 cells each side
  const bool host_bits = a.bits_plane != nullptr;

  for (int i = tid - (w + 1); i < n + w + 1; i += bd)
    sb[i] = (i >= 0 && i < n) ? a.board_in[(size_t)c * n + i] : int8_t(-1);

  uint32_t meta[GROUPS * 4];
  uint32_t acc[GROUPS * 4];  // cut_e count | cut_s count << 16
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * (tid + k * bd) + j;
      uint32_t m = 0;
      if (i < n) {
        const int x = i / w, y = i - (i / w) * w;
        const bool e = y < w - 1, wk = y > 0, s = x < a.h - 1, nn = x > 0;
        m = (e ? kE : 0) | (wk ? kW : 0) | (s ? kS : 0) | (nn ? kN : 0) |
            (s && e ? kSE : 0) | (s && wk ? kSW : 0) | (nn && e ? kNE : 0) |
            (nn && wk ? kNW : 0) | (uint32_t(a.deg[i]) << 8) | kActive;
      }
      meta[k * 4 + j] = m;
      acc[k * 4 + j] = 0;
    }
  }

  const float pop_lo = a.scal_in[2 * C + c];
  const float pop_hi = a.scal_in[3 * C + c];
  // per-chain scalar state, live on thread 0 only
  float log_base = 0.f, beta = 0.f, cur_wait = 0.f, waits_sum = 0.f;
  int dp0 = 0, dp1 = 0, pending = 0, cur_flip = 0, cur_sign = 0, tyield = 0,
      move_clock = 0, acc_cnt = 0, exh_cnt = 0;
  const float denom = static_cast<float>(static_cast<double>(n) * n - 1.0);
  if (tid == 0) {
    log_base = a.scal_in[c];
    beta = a.scal_in[C + c];
    cur_wait = a.scal_in[4 * C + c];
    dp0 = a.dist_pop_in[c];
    dp1 = a.dist_pop_in[C + c];
    pending = a.ints_in[c];
    cur_flip = a.ints_in[C + c];
    cur_sign = a.ints_in[2 * C + c];
    tyield = a.ints_in[3 * C + c];
    move_clock = a.ints_in[4 * C + c];
    acc_cnt = a.ints_in[5 * C + c];
    exh_cnt = a.ints_in[6 * C + c];
    s_dp[0] = dp0;
    s_dp[1] = dp1;
  }
  __syncthreads();

  for (int t = 0; t < a.t_inner; ++t) {
    const int p0 = s_dp[0], p1 = s_dp[1];
    uint32_t cnt = 0;                // b_count | cut_count << 16
    unsigned long long best = 0ull;  // score << 32 | ~index
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) {
      const int g = tid + k * bd;
      uint32_t bits[4] = {0u, 0u, 0u, 0u};
      if (host_bits) {
        const uint32_t* row = a.bits_plane + ((size_t)t * C + c) * n;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bits[j] = (4 * g + j < n) ? row[4 * g + j] : 0u;
      } else if (4 * g < n) {
        const Philox4 r = philox4x32_10(g, t, a.chunk_idx, kStreamPlane,
                                        a.seed, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) bits[j] = r.v[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t m = meta[k * 4 + j];
        if (!(m & kActive)) continue;
        const int i = 4 * g + j;
        const int8_t v = sb[i];
        uint32_t sm = (sb[i + 1] == v ? kE : 0) | (sb[i - 1] == v ? kW : 0) |
                      (sb[i + w] == v ? kS : 0) | (sb[i - w] == v ? kN : 0) |
                      (sb[i + w + 1] == v ? kSE : 0) |
                      (sb[i + w - 1] == v ? kSW : 0) |
                      (sb[i - w + 1] == v ? kNE : 0) |
                      (sb[i - w - 1] == v ? kNW : 0);
        sm &= m;
        const int same_deg = __popc(sm & 0xFu);
        const int diff_deg = int((m >> 8) & 0xFu) - same_deg;
        const bool b_mask = diff_deg > 0;
        const uint32_t ce = (m & kE) && !(sm & kE);
        const uint32_t cs = (m & kS) && !(sm & kS);
        bool contig = true;
        if (a.patch) {
          const uint32_t e = sm & 1u, wk = (sm >> 1) & 1u, s = (sm >> 2) & 1u,
                         nn = (sm >> 3) & 1u, se = (sm >> 4) & 1u,
                         sw = (sm >> 5) & 1u, ne = (sm >> 6) & 1u,
                         nw = (sm >> 7) & 1u;
          const uint32_t runs = (e & ~(ne & nn)) + (s & ~(se & e)) +
                                (wk & ~(sw & s)) + (nn & ~(nw & wk));
          contig = same_deg <= 1 || runs <= 1;
        }
        const float popn = static_cast<float>(__ldg(a.pop + i));
        const int pop_of = v == 1 ? p1 : p0;
        const int pop_to = v == 1 ? p0 : p1;
        const bool pop_ok = (static_cast<float>(pop_of) - popn >= pop_lo) &&
                            (static_cast<float>(pop_to) + popn <= pop_hi);
        const bool valid = b_mask && contig && pop_ok;
        cnt += uint32_t(b_mask) + ((ce + cs) << 16);
        acc[k * 4 + j] += ce + (cs << 16);
        const uint32_t score = valid ? (bits[j] | 1u) : 0u;
        const unsigned long long key =
            (static_cast<unsigned long long>(score) << 32) |
            static_cast<uint32_t>(~i);
        best = key > best ? key : best;
      }
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, off);
      const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      best = o > best ? o : best;
    }
    if (lane == 0) {
      s_cnt[warp] = cnt;
      s_best[warp] = best;
    }
    __syncthreads();

    if (warp == 0) {
      cnt = lane < n_warps ? s_cnt[lane] : 0u;
      best = lane < n_warps ? s_best[lane] : 0ull;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, off);
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
        best = o > best ? o : best;
      }
      if (lane == 0) {
        const int b_count = int(cnt & 0xFFFFu);
        const int cut_count = int(cnt >> 16);
        uint32_t wbits, abits;
        if (host_bits) {
          wbits = a.bits_scal[((size_t)t * 2) * C + c];
          abits = a.bits_scal[((size_t)t * 2 + 1) * C + c];
        } else {
          const Philox4 r = philox4x32_10(0u, t, a.chunk_idx, kStreamScalars,
                                          a.seed, c);
          wbits = r.v[0];
          abits = r.v[1];
        }
        // complete the pending wait from this state's boundary count
        if (a.geom_waits && pending) {
          const float p = static_cast<float>(b_count) / denom;
          const float wn =
              floorf(logf(fmaxf(u01(wbits), 1e-12f)) / log1pf(-p));
          cur_wait = wn > 0.f ? wn : 0.f;
        }
        // record yield t
        const size_t row = (size_t)t * C + c;
        a.h_cut[row] = cut_count;
        a.h_b[row] = b_count;
        a.h_wait[row] = cur_wait;
        a.h_acc[row] = acc_cnt;
        a.log_f[row] = cur_flip;
        a.log_s[row] = cur_sign;
        waits_sum += cur_wait;
        tyield += 1;

        // propose, accept, commit
        const uint32_t score = static_cast<uint32_t>(best >> 32);
        const int idx = int(~static_cast<uint32_t>(best));
        const bool any_valid = score != 0u;
        const int d_from = sb[idx];
        const int yi = idx % w;
        const int same_rook = (yi < w - 1 && sb[idx + 1] == d_from) +
                              (yi > 0 && sb[idx - 1] == d_from) +
                              (idx + w < n && sb[idx + w] == d_from) +
                              (idx - w >= 0 && sb[idx - w] == d_from);
        const int deg_at = a.deg[idx];
        const int dcut = deg_at - 2 * (deg_at - same_rook);
        const float log_bound = -beta * static_cast<float>(dcut) * log_base;
        const float logu = logf(fmaxf(u01(abits), 1e-12f));
        const bool accept = any_valid && (logu < log_bound);
        if (accept) {
          const int d_to = 1 - d_from;
          const int popv = a.pop[idx];
          sb[idx] = static_cast<int8_t>(d_to);
          dp0 += d_from == 0 ? -popv : popv;
          dp1 += d_from == 0 ? popv : -popv;
          cur_flip = idx;
          cur_sign = 1 - 2 * d_to;
        }
        pending = accept;
        move_clock += accept;
        acc_cnt += accept;
        exh_cnt += !any_valid;
        s_dp[0] = dp0;
        s_dp[1] = dp1;
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < n; i += bd) a.board_out[(size_t)c * n + i] = sb[i];
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * (tid + k * bd) + j;
      if (i < n) {
        a.cut_e[(size_t)c * n + i] = int32_t(acc[k * 4 + j] & 0xFFFFu);
        a.cut_s[(size_t)c * n + i] = int32_t(acc[k * 4 + j] >> 16);
      }
    }
  }
  if (tid == 0) {
    a.dist_pop_out[c] = dp0;
    a.dist_pop_out[C + c] = dp1;
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[7] = {pending, cur_flip, cur_sign, tyield,
                         move_clock, acc_cnt, exh_cnt};
#pragma unroll
    for (int j = 0; j < 7; ++j) a.ints_out[j * C + c] = ints[j];
  }
}

template <int GROUPS>
void launch(const Args& a, int threads, cudaStream_t stream) {
  const size_t smem = size_t(a.h) * a.w + 2 * size_t(a.w + 1);
  board_chunk_kernel<GROUPS><<<a.n_chains, threads, smem, stream>>>(a);
}

}  // namespace

extern "C" {

// Threads per block and cell groups per thread for an N-cell board: each
// thread owns GROUPS groups of 4 consecutive cells. Returns the thread
// count (a multiple of 32), or 0 when the board is too large.
static int board_chunk_threads(int n, int* groups) {
  const int n_groups = (n + 3) / 4;
  for (int g = 1; g <= 8; g *= 2) {
    const int threads = ((n_groups + g - 1) / g + 31) / 32 * 32;
    if (threads <= 256 || (g == 8 && threads <= 512)) {
      *groups = g;
      return threads;
    }
  }
  return 0;
}

int fce_board_chunk(const int8_t* board_in, const int32_t* pop,
                    const int32_t* deg, const int32_t* dist_pop_in,
                    const float* scal_in, const int32_t* ints_in,
                    const uint32_t* bits_plane, const uint32_t* bits_scal,
                    int8_t* board_out, int32_t* dist_pop_out, float* scal_out,
                    int32_t* ints_out, int32_t* log_f, int32_t* log_s,
                    int32_t* h_cut, int32_t* h_b, float* h_wait,
                    int32_t* h_acc, int32_t* cut_e, int32_t* cut_s,
                    int n_chains, int h, int w, int t_inner, int patch,
                    int geom_waits, unsigned int seed, unsigned int chunk_idx,
                    void* stream) {
  Args a{board_in, pop,      deg,      dist_pop_in, scal_in,  ints_in,
         bits_plane, bits_scal, board_out, dist_pop_out, scal_out, ints_out,
         log_f,    log_s,    h_cut,    h_b,         h_wait,   h_acc,
         cut_e,    cut_s,    n_chains, h,           w,        t_inner,
         patch,    geom_waits, seed,   chunk_idx};
  int groups = 0;
  const int threads = board_chunk_threads(h * w, &groups);
  if (threads == 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (groups) {
    case 1: launch<1>(a, threads, s); break;
    case 2: launch<2>(a, threads, s); break;
    case 4: launch<4>(a, threads, s); break;
    default: launch<8>(a, threads, s); break;
  }
  return int(cudaGetLastError());
}

}  // extern "C"
