// Lowered-chunk kernel: t_inner steps of the 2-district flip chain on a
// lowered stencil canvas (holes, diagonal and seam edges: the sec11 grid,
// the Frankengraph, queen grids), one warp per chain, the board bit-packed
// in shared memory.
//
// Replaces the body of the JAX package's lowered chunk scan,
// flipcomplexityempirical_tpu/kernel/board.py::_scan_bits_lowered (:1267),
// bit-identical to its int8 form _scan_stencil (:1201). On the TPU that
// body is XLA code fused per scan step, not a Pallas kernel; replayed as
// torch ops (the plain version) it is hundreds of small launches a step.
// Here one launch runs the whole chunk. It is bit-equal to its plain version
// (kernel/cuda_lowered.py::lowered_chunk_reference) on every output, and
// draws the JAX package's own threefry2x32 stream: split(key, 4) per step,
// uniform() of each subkey, exactly as rng.py and jax.random do.
//
// Per step and chain (the order of the JAX scan body):
//   1. split the key four ways: (key, kprop, kacc, kwait), lanes 0..3 one
//      threefry block each, then lanes 1..3 the uniform of their subkey;
//   2. the word pass: each lane owns board words lane, lane + 32, ...
//      (cell = 32 * word + bit, the canvas in flat row-major order). Per
//      word, the 8 ring-direction "differ" planes from funnel shifts by
//      the flat offsets 1, w + 1, w, w - 1 and their negatives, masked by
//      the static adjacency planes; their OR is the boundary (holes have
//      no adjacency bits, so they never count); the population gate of a
//      uniform population is one test per district; the wall-cut edges of
//      the four forward planes feed two running minima of the wall keys;
//   3. complete the pending wait from the boundary count, record the row:
//      cut, b, wait, accepts, the flip-log pair, and slope / angle from
//      the two smallest wall keys;
//   4. contiguity (patch): the candidate cells (boundary & gate) are
//      compacted into a per-warp list and spread over the lanes; per cell
//      the exact radius-2 patch check: the member bitset over the B2
//      window (same district as the cell, in its patch), seeds = direct
//      neighbours, reach grown from the lowest seed by a worklist over the
//      patch adjacency. The JAX body runs b2_iters Jacobi rounds instead;
//      b2_iters = the largest patch size - 1 bounds every shortest path
//      inside a patch, so both reach the same closure and give the same
//      verdict. The bitsets are indexed by the position in the 5 x 5
//      window around the cell rather than by the JAX package's offset
//      index (a relabelling of the same bits), so that the member set is
//      five 5-bit board fields. The valid cells are set in a per-chain bit
//      plane (shared atomics);
//   5. select the m-th valid cell in flat order, m = min(int(u * total),
//      total - 1), by per-word popcounts and a warp scan; accept by the
//      literal base**(-dcut) bound (or always); commit.
// cut_times by events, as board_chunk.cu does for two planes: an edge's
// cut state changes only when one of its ends flips, so an accepted flip
// at step t updates its up-to-8 edges, acc += cut_old * (t + 1 - last),
// and the chunk's end adds cut_now * (T - last) to every edge of the four
// forward planes, "last" the later of the two ends' last flip steps. A
// (C, N) int32 scratch plane holds the last flip steps and a per-chain bit
// plane in shared memory marks the cells flipped in the chunk, so neither
// is initialised and only flipped cells are read.
//
// Traps the code keeps:
//   - the wait denominator is n_real**2 - 1 over the REAL node count
//     (1596 at sec11, not the canvas's 1600);
//   - the population unit is pop[cell_of_node[0]], passed in as unit_pop:
//     canvas cell 0 is a hole on sec11;
//   - a hole never counts as a boundary or valid cell: adjacency bits
//     exist only between real cells, holes pack as 0 and the board out
//     writes -1 there;
//   - with an empty valid set the selection resolves to cell 0 (a hole on
//     sec11) and nothing is committed, as in the JAX body;
//   - float steps in the JAX order, built with -fmad=false (no
//     contraction): logf, log1pf, sqrtf, acosf and IEEE division, the
//     same device functions torch's CUDA ops call, so the plain version on
//     the card agrees bit for bit.
//
// What bounds it on an H100: integer issue, not memory. Device memory
// carries the board in and out, the four cut planes out and the (T, C)
// rows; the step is two threefry blocks a lane, the word pass (8 shifted
// reads a word), and the patch check of each candidate cell: five 5-bit
// window fields and a short worklist, against the class rows in shared
// memory (with per-cell rows in device memory the check waits on L2,
// since four blocks leave the SM ~28 KB of L1). The step loop's code is
// kept small: the wall-key scan and the interface metrics are out of line,
// because a fully unrolled step cost far more with both the patch check
// and the interface on than their separate costs suggested, which points
// at the instruction cache. chip_smoke.py reports the operation floor of
// the run's data beside the measured time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChainsPerBlock = 8;
constexpr int kThreads = 32 * kChainsPerBlock;
constexpr uint32_t kIfaceBig = 1u << 30;

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

// the board word holding cells 32 * k + o .. 32 * k + o + 31, for o > 0
// and o < 0 (guards zero)
__device__ __forceinline__ uint32_t shifted_fwd(const uint32_t* B, int k,
                                                int o) {
  const int q = o >> 5;
  return __funnelshift_r(B[k + q], B[k + q + 1], o & 31);
}
__device__ __forceinline__ uint32_t shifted_back(const uint32_t* B, int k,
                                                 int o) {
  const int q = (-o) >> 5;
  return __funnelshift_l(B[k - q - 1], B[k - q], (-o) & 31);
}

struct Args {
  const int8_t* board_in;      // (C, N), holes -1
  const int32_t* key_in;       // (2, C) uint32 key words
  const int32_t* dist_pop_in;  // (2, C)
  const float* scal_in;        // (6, C): log_base, beta, pop_lo, pop_hi,
                               //         cur_wait, waits_sum
  const int32_t* ints_in;      // (8, C): pending, flip, sign, t_yield,
                               //   move_clock, accepts, exhausted, cut_count
  const uint32_t* adj_words;   // (8, NW) ring-direction edge bits
  const uint32_t* wall_words;  // (4, NW) forward cells holding a wall key
  const uint32_t* node_words;  // (NW,) real cells
  const int32_t* cell_class;   // (N,) the cell's patch class
  const int32_t* class_rows;   // (n_classes, 32): b2_in bits, neighbour
                               //   bits, then b2_adj of each offset k
  const int32_t* iface_key;    // (4, N), kIfaceBig where no wall edge
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
  float* h_slope;
  float* h_angle;
  int32_t* cut_planes;         // (4, C, N): E, SE, S, SW chunk counts
  int32_t* last_flip;          // (C, N) scratch, read only where flipped
  int n_chains, h, w, n_real, n_classes, t_inner;
  int patch, geom_waits, accept_always, iface;
  int label0, label1, unit_pop;
  int qx_off, qy_off, bx, by;
  float cx, cy;
};

// Shared memory, in 32-bit words, sized at launch (NW = the board's words):
//   per block: adj 8 * NW, wall 4 * NW, node NW, the cells' patch classes
//     (uint16, N) and the class rows (32 each);
//   per chain: board guard + NW + guard (guards zero: a window cell is at
//     most 2w + 2 cells away), flipped NW, valid NW, then a uint16 list of
//     N candidate cells.
struct Layout {
  int nw, guard, board, stat, chain;
  __host__ __device__ Layout(int n, int w, int n_classes) {
    nw = (n + 31) >> 5;
    guard = ((2 * w + 2) >> 5) + 2;
    board = nw + 2 * guard;
    stat = 13 * nw + (n + 1) / 2 + 32 * n_classes;
    chain = board + 2 * nw + (n + 1) / 2;
  }
  size_t bytes() const {
    return 4 * (size_t(stat) + size_t(kChainsPerBlock) * chain);
  }
};

// Patch classes: the B2 tables of a cell (which window cells are in its
// patch, which are direct neighbours, and the adjacency among them) repeat
// across the canvas: at sec11 and the Frankengraph a few dozen distinct
// rows serve every cell. The host dedups them (cuda_lowered.
// make_static_inputs), so the whole table sits in shared memory beside the
// board instead of ~128 KB of per-cell rows in device memory.

// the two smallest wall keys among the set bits of wc (cells 32 * k + bit
// of forward plane d): rare work, kept out of line so that the step loop's
// code stays small
__device__ __noinline__ void scan_walls(const int32_t* iface_key, int n,
                                        int d, int k, uint32_t wc,
                                        uint32_t& min1, uint32_t& min2) {
  while (wc) {
    const int bit = __ffs(wc) - 1;
    wc &= wc - 1u;
    const uint32_t key = static_cast<uint32_t>(
        __ldg(iface_key + (size_t)d * n + 32 * k + bit));
    if (key < min1) {
      min2 = min1;
      min1 = key;
    } else if (key < min2) {
      min2 = key;
    }
  }
}

// slope and angle of the two wall edges with keys first < second (the JAX
// package's _interface_stencil, float step for float step)
__device__ __noinline__ void interface_metrics(int f, int s, int qx_off,
                                               int qy_off, int bx, int by,
                                               float cx, float cy,
                                               float& slope, float& angle) {
  const int mx = (1 << bx) - 1, my = (1 << by) - 1;
  const float ax = static_cast<float>(((f >> by) & mx) + qx_off) * 0.5f;
  const float ay = static_cast<float>((f & my) + qy_off) * 0.5f;
  const float ex = static_cast<float>(((s >> by) & mx) + qx_off) * 0.5f;
  const float ey = static_cast<float>((s & my) + qy_off) * 0.5f;
  const float dx = ex - ax, dy = ey - ay;
  slope = dx != 0.f ? dy / dx : INFINITY;
  const float vax = ax - cx, vay = ay - cy;
  const float vbx = ex - cx, vby = ey - cy;
  const float norm =
      sqrtf(vax * vax + vay * vay) * sqrtf(vbx * vbx + vby * vby);
  const float cosang =
      fminf(fmaxf((vax * vbx + vay * vby) / fmaxf(norm, 1e-12f), -1.f), 1.f);
  angle = acosf(cosang);
}

// the exact radius-2 patch check of one cell (the JAX package's
// _stencil_patch_ok at that cell; see the header for the worklist), in
// window coordinates: bit 5 * (dr + 2) + (dc + 2) is the cell dr rows and
// dc columns away. The board's window is five 5-bit row fields; the class
// row holds the patch members, the direct neighbours and the patch
// adjacency of each window position.
__device__ __forceinline__ bool patch_ok(const uint32_t* B, int w,
                                         const uint16_t* cls,
                                         const uint32_t* rows, int cell) {
  const uint32_t* row = rows + 32 * cls[cell];
  const uint32_t flip = bit_at(B, cell) ? 0u : 31u;  // xnor with the centre
  uint32_t same = 0u;
#pragma unroll
  for (int dr = 0; dr < 5; ++dr) {
    const int q = cell + (dr - 2) * w - 2;
    const uint32_t field =
        __funnelshift_r(B[q >> 5], B[(q >> 5) + 1], q & 31) & 31u;
    same |= (field ^ flip) << (5 * dr);
  }
  const uint32_t member = same & row[0];
  const uint32_t seeds = member & row[1];
  if ((seeds & (seeds - 1u)) == 0u) return true;  // at most one seed
  uint32_t reach = seeds & (0u - seeds), frontier = reach;
  while (frontier) {
    const int p = __ffs(frontier) - 1;
    frontier &= frontier - 1u;
    const uint32_t nb = row[2 + p] & member & ~reach;
    reach |= nb;
    frontier |= nb;
    if ((seeds & ~reach) == 0u) return true;
  }
  return false;
}

template <int WPL>
__global__ void __launch_bounds__(kThreads, WPL <= 2 ? 4 : 2)
    lowered_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int w = a.w, n = a.h * a.w, C = a.n_chains, T = a.t_inner;
  const Layout L(n, w, a.n_classes);
  const int nw = L.nw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* adjw = smem;                     // [d * nw + k]
  uint32_t* wallw = adjw + 8 * nw;
  uint32_t* nodew = wallw + 4 * nw;
  uint16_t* cls = reinterpret_cast<uint16_t*>(nodew + nw);
  uint32_t* rows = nodew + nw + (n + 1) / 2;

  for (int i = threadIdx.x; i < 8 * nw; i += kThreads)
    adjw[i] = a.adj_words[i];
  for (int i = threadIdx.x; i < 4 * nw; i += kThreads)
    wallw[i] = a.wall_words[i];
  for (int i = threadIdx.x; i < nw; i += kThreads) nodew[i] = a.node_words[i];
  for (int i = threadIdx.x; i < n; i += kThreads)
    cls[i] = static_cast<uint16_t>(a.cell_class[i]);
  for (int i = threadIdx.x; i < 32 * a.n_classes; i += kThreads)
    rows[i] = static_cast<uint32_t>(a.class_rows[i]);
  __syncthreads();  // the only block barrier

  const int c = blockIdx.x * kChainsPerBlock + warp;
  if (c >= C) return;
  uint32_t* board_all = smem + L.stat + warp * L.chain;
  uint32_t* B = board_all + L.guard;  // B[-guard .. nw + guard) readable
  uint32_t* flipped = board_all + L.board;
  uint32_t* vw = flipped + nw;
  uint16_t* list = reinterpret_cast<uint16_t*>(vw + nw);
  const size_t base = (size_t)c * n;

  for (int k = lane; k < L.board; k += 32) board_all[k] = 0u;
  for (int k = lane; k < nw; k += 32) flipped[k] = 0u;
  __syncwarp();
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    const uint32_t word =
        __ballot_sync(kFull, i < n && a.board_in[base + i] == 1);
    if (lane == (k & 31)) B[k] = word;
  }
  __syncwarp();

  // the ring offsets E, SE, S, SW, W, NW, N, NE; lane d < 8 keeps its own
  // (directions d and d + 4 are opposite)
  const int ring[8] = {1, w + 1, w, w - 1, -1, -w - 1, -w, -w + 1};
  const int fwd = lane & 3;
  const int my_off = (fwd == 0 ? 1 : fwd == 1 ? w + 1 : fwd == 2 ? w : w - 1) *
                     ((lane & 4) ? -1 : 1);

  // per-chain state, warp-uniform
  uint32_t key0 = static_cast<uint32_t>(a.key_in[c]);
  uint32_t key1 = static_cast<uint32_t>(a.key_in[C + c]);
  const float log_base = a.scal_in[c], beta = a.scal_in[C + c];
  const float pop_lo = a.scal_in[2 * C + c], pop_hi = a.scal_in[3 * C + c];
  float cur_wait = a.scal_in[4 * C + c], waits_sum = a.scal_in[5 * C + c];
  int dp0 = a.dist_pop_in[c], dp1 = a.dist_pop_in[C + c];
  int pending = a.ints_in[c], cur_flip = a.ints_in[C + c],
      cur_sign = a.ints_in[2 * C + c], move_clock = a.ints_in[4 * C + c],
      acc_cnt = a.ints_in[5 * C + c], exh_cnt = a.ints_in[6 * C + c],
      cut_count = a.ints_in[7 * C + c];
  const float denom =
      static_cast<float>(static_cast<double>(a.n_real) * a.n_real - 1.0);
  const float unitf = static_cast<float>(a.unit_pop);
  const float lo = ceilf(pop_lo), hi = floorf(pop_hi);

  for (int t = 0; t < T; ++t) {
    // ---- 1. keys: split four ways, uniforms of the three subkeys -------
    uint32_t s0 = 0u, s1 = static_cast<uint32_t>(lane & 3);
    threefry2x32(key0, key1, s0, s1);
    uint32_t u0 = 0u, u1 = 0u;
    threefry2x32(s0, s1, u0, u1);
    const uint32_t ubits = u0 ^ u1;
    key0 = __shfl_sync(kFull, s0, 0);
    key1 = __shfl_sync(kFull, s1, 0);
    const float u_prop = uniform_of(__shfl_sync(kFull, ubits, 1));
    const float u_acc = uniform_of(__shfl_sync(kFull, ubits, 2));
    const float u_wait = uniform_of(__shfl_sync(kFull, ubits, 3));

    // ---- 2. word pass: boundary, gate, wall keys ------------------------
    const float p0f = static_cast<float>(dp0), p1f = static_cast<float>(dp1);
    const uint32_t gate0 = unitf <= fminf(p0f - lo, hi - p1f) ? kFull : 0u;
    const uint32_t gate1 = unitf <= fminf(p1f - lo, hi - p0f) ? kFull : 0u;
    int bcnt = 0;
    uint32_t min1 = kIfaceBig, min2 = kIfaceBig;
    uint32_t cand[WPL];
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      const int k = lane + 32 * j;
      cand[j] = 0u;
      if (k >= nw) continue;
      const uint32_t b = B[k];
      uint32_t bmask = 0u;
#pragma unroll
      for (int d = 0; d < 4; ++d) {  // forward: E, SE, S, SW (w >= 3)
        const uint32_t x =
            (b ^ shifted_fwd(B, k, ring[d])) & adjw[d * nw + k];
        bmask |= x;
        const uint32_t wc = x & wallw[d * nw + k];  // zero without iface
        if (wc) scan_walls(a.iface_key, n, d, k, wc, min1, min2);
      }
#pragma unroll
      for (int d = 4; d < 8; ++d)  // backward: W, NW, N, NE
        bmask |= (b ^ shifted_back(B, k, ring[d])) & adjw[d * nw + k];
      bcnt += __popc(bmask);
      cand[j] = bmask & ((b & gate1) | (~b & gate0));
    }
    const int b_count = __reduce_add_sync(kFull, bcnt);

    // ---- 3. wait, record ------------------------------------------------
    if (a.geom_waits && pending) {
      const float p = static_cast<float>(b_count) / denom;
      const float wn = floorf(logf(fmaxf(u_wait, 1e-12f)) / log1pf(-p));
      cur_wait = fmaxf(wn, 0.f);
    }
    float slope = NAN, angle = NAN;
    if (a.iface) {
      const uint32_t first = __reduce_min_sync(kFull, min1);
      const uint32_t second =
          __reduce_min_sync(kFull, min1 == first ? min2 : min1);
      if (second < kIfaceBig && lane == 0)
        interface_metrics(static_cast<int>(first), static_cast<int>(second),
                          a.qx_off, a.qy_off, a.bx, a.by, a.cx, a.cy, slope,
                          angle);
    }
    if (lane == 0) {
      const size_t row = (size_t)t * C + c;
      a.h_cut[row] = cut_count;
      a.h_b[row] = b_count;
      a.h_wait[row] = cur_wait;
      a.h_acc[row] = acc_cnt;
      a.log_f[row] = cur_flip;
      a.log_s[row] = cur_sign;
      a.h_slope[row] = slope;
      a.h_angle[row] = angle;
    }
    waits_sum += cur_wait;

    // ---- 4. validity: the patch check of each candidate cell -----------
    uint32_t valid[WPL];
    if (a.patch) {
      int mine = 0;
#pragma unroll
      for (int j = 0; j < WPL; ++j) mine += __popc(cand[j]);
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += v;
      }
      const int n_cand = __shfl_sync(kFull, incl, 31);
      int pos = incl - mine;
#pragma unroll
      for (int j = 0; j < WPL; ++j) {
        uint32_t cj = cand[j];
        while (cj) {
          const int bit = __ffs(cj) - 1;
          cj &= cj - 1u;
          list[pos++] = static_cast<uint16_t>(32 * (lane + 32 * j) + bit);
        }
        if (lane + 32 * j < nw) vw[lane + 32 * j] = 0u;
      }
      __syncwarp();
      for (int e = lane; e < n_cand; e += 32) {
        const int cell = list[e];
        if (patch_ok(B, w, cls, rows, cell))
          atomicOr(vw + (cell >> 5), 1u << (cell & 31));
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < WPL; ++j)
        valid[j] = lane + 32 * j < nw ? vw[lane + 32 * j] : 0u;
    } else {
#pragma unroll
      for (int j = 0; j < WPL; ++j) valid[j] = cand[j];
    }

    // ---- 5. select the m-th valid cell, accept, commit ------------------
    int mine = 0;
#pragma unroll
    for (int j = 0; j < WPL; ++j) mine += __popc(valid[j]);
    const int total = __reduce_add_sync(kFull, mine);
    const bool any_valid = total > 0;
    int m = static_cast<int>(u_prop * static_cast<float>(total));
    m = min(m, max(total - 1, 0));
    int flat = 0;
    if (any_valid) {
      int before = 0;  // valid cells in the words of earlier j
#pragma unroll
      for (int j = 0; j < WPL; ++j) {
        const int cnt = __popc(valid[j]);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += v;
        }
        const int lo_rank = before + incl - cnt;
        const unsigned here =
            __ballot_sync(kFull, m >= lo_rank && m < before + incl);
        if (here) {
          const int src = __ffs(here) - 1;
          int cell = 0;
          if (lane == src) {
            uint32_t word = valid[j];
            for (int r = m - lo_rank; r > 0; --r) word &= word - 1u;
            cell = 32 * (lane + 32 * j) + __ffs(word) - 1;
          }
          flat = __shfl_sync(kFull, cell, src);
          break;
        }
        before += __shfl_sync(kFull, incl, 31);
      }
    }

    const uint32_t d_from = bit_at(B, flat);
    int deg = 0, dd = 0;  // the degree of flat, its differing neighbours
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const uint32_t has = (adjw[d * nw + (flat >> 5)] >> (flat & 31)) & 1u;
      deg += int(has);
      dd += int(has && bit_at(B, flat + ring[d]) != d_from);
    }
    const int dcut = deg - 2 * dd;
    bool accept = any_valid;
    if (!a.accept_always) {
      const float log_bound = -beta * static_cast<float>(dcut) * log_base;
      accept = any_valid && (logf(fmaxf(u_acc, 1e-12f)) < log_bound);
    }
    if (accept) {
      // cut_times events for the edges of flat, lane d for direction d
      const bool was_flipped = bit_at(flipped, flat);
      int32_t* slot_ptr = nullptr;
      int32_t val = 0;
      const bool edge = lane < 8 &&
          ((adjw[lane * nw + (flat >> 5)] >> (flat & 31)) & 1u);
      if (edge) {
        const int nb = flat + my_off;
        const bool nb_flipped = bit_at(flipped, nb);
        const int last_i = was_flipped ? a.last_flip[base + flat] : 0;
        const int last_n = nb_flipped ? a.last_flip[base + nb] : 0;
        const int last = last_i > last_n ? last_i : last_n;
        // forward directions keep the edge at flat, backward at nb
        slot_ptr = a.cut_planes + ((size_t)(lane & 3) * C) * n + base +
                   (lane < 4 ? flat : nb);
        const int acc_old = (was_flipped || nb_flipped) ? *slot_ptr : 0;
        val = acc_old + int(d_from != bit_at(B, nb)) * (t + 1 - last);
      }
      __syncwarp();
      if (slot_ptr) *slot_ptr = val;
      if (lane == 0) {
        a.last_flip[base + flat] = t + 1;
        flipped[flat >> 5] |= 1u << (flat & 31);
        B[flat >> 5] ^= 1u << (flat & 31);
      }
      dp0 += d_from == 0u ? -a.unit_pop : a.unit_pop;
      dp1 += d_from == 0u ? a.unit_pop : -a.unit_pop;
      cut_count += dcut;
      cur_flip = flat;
      cur_sign = d_from == 0u ? a.label1 : a.label0;  // label of d_to
    }
    pending = accept;
    move_clock += accept;
    acc_cnt += accept;
    exh_cnt += !any_valid;
    __syncwarp();
  }

  // ---- chunk end: board out (holes -1), cut planes closed at T ----------
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    if (i >= n) break;
    const uint32_t v = bit_at(B, i);
    const bool real = (nodew[k] >> lane) & 1u;
    a.board_out[base + i] = real ? static_cast<int8_t>(v) : int8_t(-1);
    const bool fi = bit_at(flipped, i);
    const int last_i = fi ? a.last_flip[base + i] : 0;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      int32_t* out = a.cut_planes + ((size_t)d * C) * n + base + i;
      int32_t total = 0;
      if ((adjw[d * nw + k] >> lane) & 1u) {
        const int nb = i + ring[d];
        const bool fn = bit_at(flipped, nb);
        const int last_n = fn ? a.last_flip[base + nb] : 0;
        const int last = last_i > last_n ? last_i : last_n;
        total = ((fi || fn) ? *out : 0) + int(v != bit_at(B, nb)) * (T - last);
      }
      *out = total;
    }
  }
  if (lane == 0) {
    a.key_out[c] = static_cast<int32_t>(key0);
    a.key_out[C + c] = static_cast<int32_t>(key1);
    a.dist_pop_out[c] = dp0;
    a.dist_pop_out[C + c] = dp1;
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[8] = {pending, cur_flip, cur_sign, a.ints_in[3 * C + c] + T,
                         move_clock, acc_cnt, exh_cnt, cut_count};
#pragma unroll
    for (int j = 0; j < 8; ++j) a.ints_out[j * C + c] = ints[j];
  }
}

template <int WPL>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Layout(a.h * a.w, a.w, a.n_classes).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      lowered_chunk_kernel<WPL>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lowered_chunk_kernel<WPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (a.n_chains + kChainsPerBlock - 1) / kChainsPerBlock;
  lowered_chunk_kernel<WPL><<<blocks, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int fce_lowered_chunk(
    const int8_t* board_in, const int32_t* key_in, const int32_t* dist_pop_in,
    const float* scal_in, const int32_t* ints_in, const uint32_t* adj_words,
    const uint32_t* wall_words, const uint32_t* node_words,
    const int32_t* cell_class, const int32_t* class_rows,
    const int32_t* iface_key, int8_t* board_out, int32_t* key_out,
    int32_t* dist_pop_out, float* scal_out, int32_t* ints_out,
    int32_t* log_f, int32_t* log_s, int32_t* h_cut, int32_t* h_b,
    float* h_wait, int32_t* h_acc, float* h_slope, float* h_angle,
    int32_t* cut_planes, int32_t* last_flip, int n_chains, int h, int w,
    int n_real, int n_classes, int t_inner, int patch, int geom_waits,
    int accept_always, int iface, int label0, int label1, int unit_pop,
    int qx_off, int qy_off, int bx, int by, float cx, float cy,
    void* stream) {
  Args a;
  a.board_in = board_in; a.key_in = key_in; a.dist_pop_in = dist_pop_in;
  a.scal_in = scal_in; a.ints_in = ints_in; a.adj_words = adj_words;
  a.wall_words = wall_words; a.node_words = node_words;
  a.cell_class = cell_class; a.class_rows = class_rows;
  a.iface_key = iface_key; a.board_out = board_out;
  a.key_out = key_out; a.dist_pop_out = dist_pop_out; a.scal_out = scal_out;
  a.ints_out = ints_out; a.log_f = log_f; a.log_s = log_s; a.h_cut = h_cut;
  a.h_b = h_b; a.h_wait = h_wait; a.h_acc = h_acc; a.h_slope = h_slope;
  a.h_angle = h_angle; a.cut_planes = cut_planes; a.last_flip = last_flip;
  a.n_chains = n_chains; a.h = h; a.w = w; a.n_real = n_real;
  a.n_classes = n_classes; a.t_inner = t_inner; a.patch = patch;
  a.geom_waits = geom_waits; a.accept_always = accept_always;
  a.iface = iface; a.label0 = label0; a.label1 = label1;
  a.unit_pop = unit_pop; a.qx_off = qx_off; a.qy_off = qy_off; a.bx = bx;
  a.by = by; a.cx = cx; a.cy = cy;
  const int nw = (h * w + 31) >> 5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chains < 1 || h < 3 || w < 3 || t_inner < 1 || nw > 128 ||
      n_classes < 1 || Layout(h * w, w, n_classes).bytes() > 227 * 1024)
    return int(cudaErrorInvalidValue);
  if (nw <= 32) return launch<1>(a, s);
  if (nw <= 64) return launch<2>(a, s);
  return launch<4>(a, s);
}

}  // extern "C"
