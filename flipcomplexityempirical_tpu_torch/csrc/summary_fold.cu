// Summary fold: (T, C) history rows folded into the run's summary
// accumulator, on the card, so a summary-mode run never copies its
// history to the host.
//
// Replaces no Pallas kernel: it is the port of the XLA fold that every
// scan body of the JAX package calls on each yield,
// flipcomplexityempirical_tpu/stats/accumulators.py:116 (fold_out; its
// scan over a block, fold_block, :167). The chunk kernels fold their own
// rows as they make them (lowered_chunk.cu, general_dense_chunk.cu); this
// kernel folds rows that a caller already holds: the runners' one-row
// records (the board runners' final yield, the general runner's initial
// one) and any history. The per-step arithmetic, fold_out's float order
// in explicitly rounded intrinsics, is summary_fold.cuh's, shared with
// the chunk kernels.
//
// Design: one thread a chain, looping over T in batches of kAhead steps
// whose rows are loaded into registers before the batch's first step
// (chain 0's thread loads its series values with them). Row t is read
// across consecutive chains, so each step's loads are coalesced; the
// buffer is the chain's own row (an append every stride steps, a
// halving in place). Bound: bytes, the rows read once (8 bytes a
// chain-step with a wait row) and the fields written; what it runs at is
// a step's latency (two IEEE divisions on the dependence chain) plus one
// load latency a batch, since C threads walk T dependent steps. wgmma and
// TMA do not apply to this recurrence.
//
// Build: see kernel/_build.py (sm_90a, -O3, -fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

#include "summary_fold.cuh"

namespace {

using namespace fce;

constexpr int kThreads = 128;
constexpr int kAhead = 16;  // rows loaded before their steps run

struct Args {
  FoldArgs f;               // the accumulator (obs, src0, src1, keep_rows
                            // unused: the rows are given)
  const void* obs;          // (T, C) int32 or float32
  const float* wait;        // (T, C) or null
  const int32_t* acc_last;  // (C,) the last accepts row, or null
  const float* row0;        // (T, C) series sources, or null
  const float* row1;
  int t_len;
  int n_chains;
  int obs_float;
};

__device__ __forceinline__ float load_obs(const Args& a, size_t i) {
  return a.obs_float ? static_cast<const float*>(a.obs)[i]
                     : __int2float_rn(static_cast<const int32_t*>(a.obs)[i]);
}

__global__ void __launch_bounds__(kThreads) summary_fold_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n_chains) return;
  const FoldArgs& f = a.f;
  FoldMoments m = load_moments(f, c);
  FoldSchedule s;
  s.start(*f.n_in, *f.kept_in, *f.stride_in);
  float* row = f.buf + static_cast<size_t>(c) * f.cap;
  const size_t cc = static_cast<size_t>(a.n_chains);
  const bool lead = c == 0;
  const bool has_wait = a.wait != nullptr;
  for (int t0 = 0; t0 < a.t_len; t0 += kAhead) {
    // a batch's loads all go out before its first step, so its steps
    // wait on one load latency instead of one a step
    float xs[kAhead], vs[kAhead], s0[kAhead], s1[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int t = t0 + j;
      xs[j] = vs[j] = s0[j] = s1[j] = 0.f;
      if (t < a.t_len) {
        const size_t i = static_cast<size_t>(t) * cc + c;
        xs[j] = load_obs(a, i);
        if (has_wait) vs[j] = a.wait[i];
        if (lead && a.row0 != nullptr) s0[j] = a.row0[i];
        if (lead && a.row1 != nullptr) s1[j] = a.row1[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j >= a.t_len) break;
      const int n = s.n;
      fold_moments(m, xs[j], vs[j], has_wait, n);
      bool halve;
      const int slot = s.advance(f.cap, halve);
      if (halve) halve_row(row, f.cap);
      if (slot >= 0) row[slot] = xs[j];
      if (lead) {
        const int at = series_index(n, f.series_cap);
        if (f.series0 != nullptr) f.series0[at] = s0[j];
        if (f.series1 != nullptr) f.series1[at] = s1[j];
      }
    }
  }
  store_moments(f, c, m);
  if (a.acc_last != nullptr) f.accepts[c] = a.acc_last[c];
  if (lead) store_schedule(f, s);
}

}  // namespace

extern "C" {

int fce_summary_fold(const void* obs, int obs_float, const float* wait,
                     const int32_t* acc_last, const float* row0,
                     const float* row1, float* mean, float* m2, float* wsum,
                     float* wmean, float* wm2, float* waits,
                     int32_t* accepts, float* buf, const int32_t* n_in,
                     const int32_t* kept_in, const int32_t* stride_in,
                     int32_t* nks_out, float* series0, float* series1,
                     int series_cap, int t_len, int n_chains, int cap,
                     void* stream) {
  Args a;
  FoldArgs& f = a.f;
  f.mean = mean; f.m2 = m2; f.wsum = wsum; f.wmean = wmean; f.wm2 = wm2;
  f.waits = waits; f.accepts = accepts; f.buf = buf; f.n_in = n_in;
  f.kept_in = kept_in; f.stride_in = stride_in; f.nks_out = nks_out;
  f.series0 = series0; f.series1 = series1; f.cap = cap;
  f.series_cap = series_cap; f.obs = 0; f.src0 = f.src1 = -1;
  f.keep_rows = 1;
  a.obs = obs; a.wait = wait; a.acc_last = acc_last; a.row0 = row0;
  a.row1 = row1; a.t_len = t_len; a.n_chains = n_chains;
  a.obs_float = obs_float;
  const int blocks = (n_chains + kThreads - 1) / kThreads;
  summary_fold_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
