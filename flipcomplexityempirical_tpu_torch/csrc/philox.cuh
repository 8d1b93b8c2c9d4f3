// Philox4x32-10, shared by the package's kernels. rng.py holds its torch
// twin; the stream word (the counter's last) keeps the kernels' draws
// apart: 0 the board plane, 1 the board's per-step scalars, 2 the probes.

#pragma once

#include <cstdint>

namespace fce {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr uint32_t kStreamPlane = 0u;
constexpr uint32_t kStreamScalars = 1u;
constexpr uint32_t kStreamProbe = 2u;

struct Philox4 {
  uint32_t v[4];
};

// Counter (c0, c1, c2, c3), key (k0, k1). The first key word's round keys
// k0 + r * W0 come in k0s[0..9] (a kernel may hold them in its parameters,
// where they cost no registers); the second key word is added up round by
// round.
__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 const uint32_t* k0s,
                                                 uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) k1 += kPhiloxW1;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c0), lo0 = kPhiloxM0 * c0;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c2), lo1 = kPhiloxM1 * c2;
    const uint32_t n0 = hi1 ^ c1 ^ k0s[r], n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  return Philox4{{c0, c1, c2, c3}};
}

// the round keys k0 + r * W0 of a first key word
struct PhiloxKey0 {
  uint32_t r[10];
};

__host__ __device__ inline PhiloxKey0 philox_key0(uint32_t k0) {
  PhiloxKey0 k{};
#pragma unroll
  for (int r = 0; r < 10; ++r) k.r[r] = k0 + uint32_t(r) * kPhiloxW0;
  return k;
}

}  // namespace fce
