// Summary fold: a chunk's (T, C) history rows folded into the run's
// summary accumulator, on the card, so a summary-mode run never copies
// its history to the host.
//
// Replaces no Pallas kernel: it is the port of the XLA fold that every
// scan body of the JAX package calls on each yield,
// flipcomplexityempirical_tpu/stats/accumulators.py:116 (fold_out; its
// scan over a block, fold_block, :167). The port's chunk kernels write
// the rows to device memory, and this kernel folds them after each chunk,
// in step order, exactly as fold_out would have inside the scan. Per
// chain c and step t, with x = float(obs[t, c]) and w = 1 + wait[t, c]
// (1 without a wait row), in fold_out's float32 order:
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
// rounded intrinsic (and the build passes -fmad=false), so the kernel
// equals its plain version (stats/accumulators.py::fold_block) bit for
// bit. n, kept and stride are the same for every chain: each thread runs
// the schedule from the input values (n % stride carried as a phase
// counter) and chain 0's thread writes the final values to a separate
// output, so no block reads a value another has already advanced.
//
// Design: one thread a chain, looping over T in batches of kAhead steps
// whose rows are loaded into registers before the batch's first step
// (chain 0's thread loads its series values with them). Row t is read
// across consecutive chains, so each step's loads are coalesced; the
// buffer is the chain's own row (an append every stride steps, a
// decimation in place). Bound: bytes, the rows read once (8 bytes a
// chain-step with a wait row) and the fields written; what it runs at is
// a step's latency (two IEEE divisions on the dependence chain) plus one
// load latency a batch, since C threads walk T dependent steps. wgmma and
// TMA do not apply to this recurrence. Fusing the fold into the chunk
// kernels (ROADMAP B13) would save the rows' round trip through device
// memory.
//
// Build: see kernel/_build.py (sm_90a, -O3, -fmad=false).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 16;  // rows loaded before their steps run

struct Args {
  const void* obs;          // (T, C) int32 or float32
  const float* wait;        // (T, C) or null
  const int32_t* acc_last;  // (C,) the last accepts row, or null
  const float* row0;        // (T, C) series sources, or null
  const float* row1;
  float* mean;              // (C,) each, updated in place
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
  int series_cap;
  int t_len;
  int n_chains;
  int cap;
  int obs_float;
};

__device__ __forceinline__ float load_obs(const Args& a, size_t i) {
  return a.obs_float ? static_cast<const float*>(a.obs)[i]
                     : __int2float_rn(static_cast<const int32_t*>(a.obs)[i]);
}

// halve the buffer in place: slot j reads slot 2j >= j, which no earlier
// j wrote; the upper half is cleared (out of line: it runs once per cap /
// 2 kept samples)
__device__ __noinline__ void decimate(float* row, int cap) {
  const int half = cap / 2;
  for (int j = 0; j < half; ++j) row[j] = row[2 * j];
  for (int j = half; j < cap; ++j) row[j] = 0.f;
}

__global__ void __launch_bounds__(kThreads) summary_fold_kernel(Args a) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= a.n_chains) return;
  int n = *a.n_in, kept = *a.kept_in, stride = *a.stride_in;
  float mean = a.mean[c], m2 = a.m2[c], wsum = a.wsum[c];
  float wmean = a.wmean[c], wm2 = a.wm2[c], waits = a.waits[c];
  float* row = a.buf + static_cast<size_t>(c) * a.cap;
  const size_t cc = static_cast<size_t>(a.n_chains);
  const bool lead = c == 0;
  // n % stride, carried from step to step: no integer division a step
  int phase = n % stride;
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
        if (a.wait != nullptr) vs[j] = a.wait[i];
        if (lead && a.row0 != nullptr) s0[j] = a.row0[i];
        if (lead && a.row1 != nullptr) s1[j] = a.row1[i];
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (t0 + j >= a.t_len) break;
      const float x = xs[j], v = vs[j];
      const float n1 = __int2float_rn(n + 1);
      const float delta = __fsub_rn(x, mean);
      mean = __fadd_rn(mean, __fdiv_rn(delta, n1));
      m2 = __fadd_rn(m2, __fmul_rn(delta, __fsub_rn(x, mean)));
      const float w = a.wait != nullptr ? __fadd_rn(1.0f, v) : 1.0f;
      wsum = __fadd_rn(wsum, w);
      const float wd = __fsub_rn(x, wmean);
      wmean = __fadd_rn(wmean, __fmul_rn(wd, __fdiv_rn(w, wsum)));
      wm2 = __fadd_rn(wm2,
                      __fmul_rn(__fmul_rn(w, wd), __fsub_rn(x, wmean)));
      if (a.wait != nullptr) waits = __fadd_rn(waits, v);
      bool doubled = false;
      if (phase == 0) {
        if (kept >= a.cap) {
          decimate(row, a.cap);
          kept = a.cap / 2;
          stride *= 2;
          doubled = true;
        }
        row[kept] = x;
        ++kept;
      }
      if (lead) {
        const int at = n < a.series_cap - 1 ? n : a.series_cap - 1;
        if (a.series0 != nullptr) a.series0[at] = s0[j];
        if (a.series1 != nullptr) a.series1[at] = s1[j];
      }
      ++n;
      if (doubled) {
        phase = n % stride;
      } else if (++phase == stride) {
        phase = 0;
      }
    }
  }
  a.mean[c] = mean;
  a.m2[c] = m2;
  a.wsum[c] = wsum;
  a.wmean[c] = wmean;
  a.wm2[c] = wm2;
  a.waits[c] = waits;
  if (a.acc_last != nullptr) a.accepts[c] = a.acc_last[c];
  if (lead) {
    a.nks_out[0] = n;
    a.nks_out[1] = kept;
    a.nks_out[2] = stride;
  }
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
  a.obs = obs; a.wait = wait; a.acc_last = acc_last; a.row0 = row0;
  a.row1 = row1; a.mean = mean; a.m2 = m2; a.wsum = wsum; a.wmean = wmean;
  a.wm2 = wm2; a.waits = waits; a.accepts = accepts; a.buf = buf;
  a.n_in = n_in; a.kept_in = kept_in; a.stride_in = stride_in;
  a.nks_out = nks_out; a.series0 = series0; a.series1 = series1;
  a.series_cap = series_cap; a.t_len = t_len; a.n_chains = n_chains;
  a.cap = cap; a.obs_float = obs_float;
  const int blocks = (n_chains + kThreads - 1) / kThreads;
  summary_fold_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
