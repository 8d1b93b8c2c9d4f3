// Probe kernels: the two toolchain probes of tools/mosaic_probes.py.
//
// Replaces the TPU kernels kA and kB that tools/mosaic_probes.py::run
// launches through pl.pallas_call. On the TPU they probed whether the
// Mosaic compiler accepts a PRNG plane drawn in a loop with a row-max carry
// (kA), and the score / any_valid loop of the board kernel (kB). Here they
// stand in for the same probe of this toolchain: that nvcc builds a kernel
// of that shape and that it launches and agrees with its plain version.
// Over an int32 input x (rows, n) for t_steps steps, one int32 per row:
//
//   probe A: out[r] = sum_t max_j int32(bits[t, r, j] ^ 0x80000000)
//   probe B: out[r] = sum_t [max_j int32(score ^ 0x80000000) > INT32_MIN],
//            score = x[r, j] > 0 ? bits[t, r, j] | 1 : 0
//
// with wrapping int32 sums, as JAX adds. One warp per row: lane l owns the
// groups of 4 consecutive columns l, l + 32, ..., draws one Philox4x32-10
// block per group (key (seed, row), counter (group, step, 0, stream 2)) or
// reads host bits (t_steps, rows, n), and a warp max reduces the row. At
// the probe's shape (128 x 128, 4 steps) the work is ~0.1 MFLOP: launch
// overhead bounds it, so the design only keeps it one launch for all rows.
//
// Build: see kernel/_build.py (sm_90a, -O3, -fmad=false).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRowsPerBlock = 4;

__global__ void __launch_bounds__(32 * kRowsPerBlock)
    probe_kernel(const int32_t* __restrict__ x,
                 const uint32_t* __restrict__ bits, int32_t* __restrict__ out,
                 int rows, int n, int t_steps, int mode, uint32_t seed) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const int n_groups = (n + 3) / 4;
  const fce::PhiloxKey0 key0 = fce::philox_key0(seed);
  uint32_t acc = 0u;  // wrapping int32 sum, held unsigned
  for (int t = 0; t < t_steps; ++t) {
    int best = INT_MIN;
    for (int q = lane; q < n_groups; q += 32) {
      uint32_t w[4];
      if (bits != nullptr) {
        const uint32_t* row = bits + ((size_t)t * rows + r) * n;
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = 4 * q + i < n ? row[4 * q + i] : 0u;
      } else {
        const fce::Philox4 p =
            fce::philox4x32_10(q, t, 0u, fce::kStreamProbe, key0.r, r);
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = p.v[i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * q + i;
        if (j >= n) break;
        uint32_t s = w[i];
        if (mode == 1) s = x[(size_t)r * n + j] > 0 ? (s | 1u) : 0u;
        const int v = static_cast<int>(s ^ 0x80000000u);
        best = v > best ? v : best;
      }
    }
    best = __reduce_max_sync(kFull, best);
    acc += mode == 0 ? static_cast<uint32_t>(best)
                     : static_cast<uint32_t>(best > INT_MIN);
  }
  if (lane == 0) out[r] = static_cast<int32_t>(acc);
}

}  // namespace

extern "C" {

// mode 0: probe A, mode 1: probe B. bits is (t_steps, rows, n) uint32 or
// null (Philox in the kernel). Returns cudaGetLastError() after the launch.
int fce_probe(const int32_t* x, const uint32_t* bits, int32_t* out, int rows,
              int n, int t_steps, int mode, unsigned int seed, void* stream) {
  if (rows < 1 || n < 1 || t_steps < 0 || (mode != 0 && mode != 1))
    return int(cudaErrorInvalidValue);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  probe_kernel<<<blocks, 32 * kRowsPerBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(x, bits, out, rows, n,
                                                      t_steps, mode, seed);
  return int(cudaGetLastError());
}

}  // extern "C"
