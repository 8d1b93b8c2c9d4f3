// The summary fold, one step at a time: the one copy of the arithmetic
// that summary_fold.cu (the standalone kernel) and the two chunk kernels
// that fold their own rows (lowered_chunk.cu, general_dense_chunk.cu)
// share.
//
// Port of the JAX package's fold_out
// (flipcomplexityempirical_tpu/stats/accumulators.py:116), which every
// scan body calls on each yield. Per chain c and step t, with x =
// float(obs[t, c]) and w = 1 + wait[t, c] (1 without a wait row), in
// fold_out's float32 order:
//
//   n1 = float(n + 1); delta = x - mean; mean += delta / n1;
//   m2 += delta * (x - mean);
//   wsum += w; wd = x - wmean; wmean += wd * (w / wsum);
//   wm2 += (w * wd) * (x - wmean); waits += wait;
//   if n % stride == 0:                       (the thinning buffer)
//     if kept >= cap: buf[c, :cap/2] = buf[c, ::2]; buf[c, cap/2:] = 0;
//                     kept = cap / 2; stride *= 2
//     buf[c, kept++] = x
//   series_k[min(n, series_cap - 1)] = row_k[t, 0]   (chain 0 only)
//   n += 1
//
// and accepts[c] = the last accepts row. Every operation is an explicitly
// rounded intrinsic (and the build passes -fmad=false), so a fold equals
// the plain version (stats/accumulators.py::fold_block) bit for bit. n,
// kept and stride are the same for every chain: each fold replays the
// schedule from the accumulator's scalars (n % stride carried as a phase
// counter), and the fold of chain 0 writes the final values to a separate
// output, so no block reads a value another has already advanced.
//
// The chunk kernels hand each step's row values to the fold as a packet
// (the observable, the wait, series sources 0 and 1), 32 steps at a time
// through shared memory: to a fold warp of the block through FoldRing (one
// lane a chain of the block), so the fold's serial steps run beside the
// chains' next ones, or, in the dense kernel's narrow form, to a batch
// fold on the chain's own warp (fold_inline_batch, one live lane).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace fce {

// a chain's moments: fold_out's mean, m2, wsum, wmean, wm2, waits
struct FoldMoments {
  float mean, m2, wsum, wmean, wm2, waits;
};

// one step of the moments, n the samples folded before it
__device__ __forceinline__ void fold_moments(FoldMoments& f, float x,
                                             float v, bool has_wait, int n) {
  const float n1 = __int2float_rn(n + 1);
  const float delta = __fsub_rn(x, f.mean);
  f.mean = __fadd_rn(f.mean, __fdiv_rn(delta, n1));
  f.m2 = __fadd_rn(f.m2, __fmul_rn(delta, __fsub_rn(x, f.mean)));
  const float w = has_wait ? __fadd_rn(1.0f, v) : 1.0f;
  f.wsum = __fadd_rn(f.wsum, w);
  const float wd = __fsub_rn(x, f.wmean);
  f.wmean = __fadd_rn(f.wmean, __fmul_rn(wd, __fdiv_rn(w, f.wsum)));
  f.wm2 = __fadd_rn(f.wm2,
                    __fmul_rn(__fmul_rn(w, wd), __fsub_rn(x, f.wmean)));
  if (has_wait) f.waits = __fadd_rn(f.waits, v);
}

// The thinning buffer's schedule, the same for every chain: n, kept,
// stride, and n % stride carried from step to step (no integer division
// a step).
struct FoldSchedule {
  int n, kept, stride, phase;

  __device__ __forceinline__ void start(int n0, int kept0, int stride0) {
    n = n0;
    kept = kept0;
    stride = stride0;
    phase = n0 % stride0;
  }

  // one sample: the buffer slot it is kept in (-1: none); `halve` is set
  // where the buffer halves first
  __device__ __forceinline__ int advance(int cap, bool& halve) {
    halve = false;
    int slot = -1;
    if (phase == 0) {
      if (kept >= cap) {
        kept = cap / 2;
        stride *= 2;
        halve = true;
      }
      slot = kept++;
    }
    ++n;
    if (halve) {
      phase = n % stride;
    } else if (++phase == stride) {
      phase = 0;
    }
    return slot;
  }
};

// the series entry of sample n: the JAX write clamps its start index
__device__ __forceinline__ int series_index(int n, int series_cap) {
  return n < series_cap - 1 ? n : series_cap - 1;
}

// halve a row in place, one thread: slot j reads slot 2j >= j, which no
// earlier j wrote; the upper half is cleared (out of line: it runs once
// per cap / 2 kept samples)
__device__ __noinline__ void halve_row(float* row, int cap) {
  const int half = cap / 2;
  for (int j = 0; j < half; ++j) row[j] = row[2 * j];
  for (int j = half; j < cap; ++j) row[j] = 0.f;
}

// halve a row in place, the whole warp: each round reads its 32 even
// slots before any lane writes (only round 0's reads and writes overlap)
__device__ __forceinline__ void halve_row_warp(float* row, int cap,
                                               int lane) {
  const int half = cap / 2;
  for (int j0 = 0; j0 < half; j0 += 32) {
    const int j = j0 + lane;
    const float v = j < half ? row[2 * j] : 0.f;
    __syncwarp();
    if (j < half) row[j] = v;
  }
  for (int j = half + lane; j < cap; j += 32) row[j] = 0.f;
}

// The accumulator a fold writes: its (C,) fields and (C, cap) buffer
// updated in place, its () scalars read, the new scalars written to a
// fresh (3,) output, chain 0's series.
struct FoldArgs {
  float* mean;
  float* m2;
  float* wsum;
  float* wmean;
  float* wm2;
  float* waits;
  int32_t* accepts;
  float* buf;               // (C, cap)
  const int32_t* n_in;      // () each
  const int32_t* kept_in;
  const int32_t* stride_in;
  int32_t* nks_out;         // (3,) [n, kept, stride]
  float* series0;           // (series_cap,) or null
  float* series1;
  int cap, series_cap;
  // a chunk kernel's choice of its record rows: the observable's and the
  // series sources' row index (-1: none), whether the rows that only the
  // fold reads are written
  int obs, src0, src1, keep_rows;
};

// FoldArgs from the chunk entries' host arrays: 14 pointers in the field
// order above, then 6 ints [cap, series_cap, obs, src0, src1, keep_rows]
inline FoldArgs fold_args(void* const* p, const int* v) {
  FoldArgs f;
  f.mean = static_cast<float*>(p[0]);
  f.m2 = static_cast<float*>(p[1]);
  f.wsum = static_cast<float*>(p[2]);
  f.wmean = static_cast<float*>(p[3]);
  f.wm2 = static_cast<float*>(p[4]);
  f.waits = static_cast<float*>(p[5]);
  f.accepts = static_cast<int32_t*>(p[6]);
  f.buf = static_cast<float*>(p[7]);
  f.n_in = static_cast<const int32_t*>(p[8]);
  f.kept_in = static_cast<const int32_t*>(p[9]);
  f.stride_in = static_cast<const int32_t*>(p[10]);
  f.nks_out = static_cast<int32_t*>(p[11]);
  f.series0 = static_cast<float*>(p[12]);
  f.series1 = static_cast<float*>(p[13]);
  f.cap = v[0];
  f.series_cap = v[1];
  f.obs = v[2];
  f.src0 = v[3];
  f.src1 = v[4];
  f.keep_rows = v[5];
  return f;
}

__device__ __forceinline__ FoldMoments load_moments(const FoldArgs& f,
                                                    int c) {
  return FoldMoments{f.mean[c], f.m2[c], f.wsum[c],
                     f.wmean[c], f.wm2[c], f.waits[c]};
}

__device__ __forceinline__ void store_moments(const FoldArgs& f, int c,
                                              const FoldMoments& m) {
  f.mean[c] = m.mean;
  f.m2[c] = m.m2;
  f.wsum[c] = m.wsum;
  f.wmean[c] = m.wmean;
  f.wm2[c] = m.wm2;
  f.waits[c] = m.waits;
}

__device__ __forceinline__ void store_schedule(const FoldArgs& f,
                                               const FoldSchedule& s) {
  f.nks_out[0] = s.n;
  f.nks_out[1] = s.kept;
  f.nks_out[2] = s.stride;
}

// The fold of `steps` packets into chains c0 + lane, lane < live, by the
// whole warp: packet j of lane i at pk[j * ld + i] = (observable, wait,
// series source 0, series source 1); every chunk kernel records a wait.
// Every lane keeps the schedule; a halving of the buffer is done by all
// lanes, row by row.
__device__ __forceinline__ void fold_batch(const FoldArgs& f, FoldMoments& m,
                                           FoldSchedule& s, const float4* pk,
                                           int ld, int steps, int c0,
                                           int live, int lane) {
  const bool mine = lane < live;
  float* const row = f.buf + size_t(c0 + (mine ? lane : 0)) * f.cap;
  const bool lead = c0 == 0 && lane == 0;
  for (int j = 0; j < steps; ++j) {
    const float4 p = mine ? pk[j * ld + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int n = s.n;
    bool halve;
    const int slot = s.advance(f.cap, halve);
    if (mine) fold_moments(m, p.x, p.y, true, n);
    if (halve) {
      for (int i = 0; i < live; ++i)
        halve_row_warp(f.buf + size_t(c0 + i) * f.cap, f.cap, lane);
      __syncwarp();
    }
    if (mine && slot >= 0) row[slot] = p.x;
    if (lead) {
      const int at = series_index(n, f.series_cap);
      if (f.series0 != nullptr) f.series0[at] = p.z;
      if (f.series1 != nullptr) f.series1[at] = p.w;
    }
  }
}

// The hand-off from a block's chain warps to its fold warp: kFoldRing
// batches of 32 steps' packets for the block's S chains, a full barrier
// (every lane of every live chain warp arrives after its batch) and an
// empty one (the fold warp's 32 lanes arrive after folding it) each. Two
// batches are enough: a fold step (~800 cycles at C=8) is shorter than a
// chain step (~2000 to ~3000), so the fold warp frees a slot before the
// chains fill the other.
constexpr int kFoldRing = 2;

template <int S>
struct FoldRing {
  uint64_t full[kFoldRing], empty[kFoldRing];
  float4 pk[kFoldRing][32][S];
};

// one thread, before the block barrier: the ring's barriers for `live`
// chain warps
template <int S>
__device__ __forceinline__ void fold_ring_init(FoldRing<S>* r, int live) {
  for (int s = 0; s < kFoldRing; ++s) {
    mbar_init(&r->full[s], 32 * live);
    mbar_init(&r->empty[s], 32);
  }
}

// a chain warp, before it stores batch q: its slot is free
template <int S>
__device__ __forceinline__ float4* fold_ring_acquire(FoldRing<S>* r, int q) {
  const int s = q % kFoldRing;
  mbar_wait(&r->empty[s], ((q / kFoldRing) & 1) ^ 1);
  return &r->pk[s][0][0];
}

// a chain warp, every lane, after batch q's last packet
template <int S>
__device__ __forceinline__ void fold_ring_publish(FoldRing<S>* r, int q) {
  mbar_arrive(&r->full[q % kFoldRing]);
}

// The fold warp: chains c0 .. c0 + live - 1 of the block, one lane each,
// their moments in registers for the whole chunk, batch after batch as the
// chain warps publish them; then the moments out and, in the block of
// chain 0, the new n, kept and stride.
template <int S>
__device__ void fold_warp(const FoldArgs& f, FoldRing<S>* r, int t_len, int c0,
                          int live) {
  const int lane = threadIdx.x & 31;
  FoldMoments m{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (lane < live) m = load_moments(f, c0 + lane);
  FoldSchedule s;
  s.start(*f.n_in, *f.kept_in, *f.stride_in);
  for (int q = 0; 32 * q < t_len; ++q) {
    const int slot = q % kFoldRing;
    // off the chains' critical path, it waits with sleeps, as the dense
    // kernel's draws producer does
    while (!mbar_test(&r->full[slot], (q / kFoldRing) & 1))
      __nanosleep(1024);
    fold_batch(f, m, s, &r->pk[slot][0][0], S, min(32, t_len - 32 * q), c0,
               live, lane);
    mbar_arrive(&r->empty[slot]);
  }
  if (lane < live) store_moments(f, c0 + lane, m);
  if (c0 == 0 && lane == 0) store_schedule(f, s);
}

// The batch fold on a chain's own warp (no fold warp): the chain's
// moments and the schedule wait in shared memory between batches, so the
// step loop keeps no register for them. Inlined: as a call, the
// registers live across it are spilled around it on every batch.
struct FoldState {
  FoldMoments m;
  FoldSchedule s;
};

__device__ __forceinline__ void fold_state_start(const FoldArgs& f,
                                                 FoldState* st, int c) {
  if ((threadIdx.x & 31) == 0) {
    st->m = load_moments(f, c);
    st->s.start(*f.n_in, *f.kept_in, *f.stride_in);
  }
  __syncwarp();
}

__device__ __forceinline__ void fold_inline_batch(const FoldArgs& f,
                                                  FoldState* st,
                                                  const float4* pk,
                                                  int steps, int c) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the batch's packets, written by every lane
  FoldMoments m = st->m;
  FoldSchedule s = st->s;
  fold_batch(f, m, s, pk, 1, steps, c, 1, lane);
  __syncwarp();
  if (lane == 0) {
    st->m = m;
    st->s = s;
  }
  __syncwarp();
}

__device__ __forceinline__ void fold_state_finish(const FoldArgs& f,
                                                  const FoldState* st,
                                                  int c) {
  if ((threadIdx.x & 31) == 0) {
    store_moments(f, c, st->m);
    if (c == 0) store_schedule(f, st->s);
  }
}

}  // namespace fce
