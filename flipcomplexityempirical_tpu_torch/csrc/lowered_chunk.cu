// Lowered-chunk kernel: t_inner steps of the 2-district flip chain on a
// lowered stencil canvas (holes, diagonal and seam edges: the sec11 grid,
// the Frankengraph, queen grids), one warp per chain, the board bit-packed
// in shared memory.
//
// Replaces the body of the JAX package's lowered chunk scan,
// flipcomplexityempirical_tpu/kernel/board.py::_scan_bits_lowered (:1267),
// bit-identical to its int8 form _scan_stencil (:1201), and on a plain rook
// grid's stencil (edges in four of the eight ring directions, no wall keys,
// the rook radius-2 patch) the packed rook body _scan_bits (:1338), which
// draws the same stream in the same order. On the TPU these bodies are
// XLA code fused per scan step, not Pallas kernels; replayed as
// torch ops (the plain version) it is hundreds of small launches a step.
// Here one launch runs the whole chunk. It is bit-equal to its plain version
// (kernel/cuda_lowered.py::lowered_chunk_reference) on every output, and
// draws the JAX package's own threefry2x32 stream: split(key, 4) per step,
// uniform() of each subkey, exactly as rng.py and jax.random do.
//
// Resident planes. Each chain keeps, beside its board, two bit planes in
// shared memory that describe the board and change only around a flip:
//   bnd, the boundary: bit c is set where a ring edge of c is cut (holes
//     have no adjacency bits, so they never count). It depends on c and its
//     ring neighbours only, so a flip at f changes it only in the 3 x 3
//     block f + dr * w + dc, |dr|, |dc| <= 1;
//   ok, the patch verdict: bit c is the exact radius-2 patch check of c (the
//     JAX package's _stencil_patch_ok at that cell), which reads only the
//     5 x 5 window around c, so a flip at f changes it only at the <= 25
//     cells f + dr * w + dc, |dr|, |dc| <= 2. With contiguity 'none' it is
//     all ones.
// Both are filled once a chunk (the boundary by the 8-direction word pass,
// the verdict by one patch check per cell). After each committed flip at
// f, lanes 0..5 recompute the (at most six) boundary words of f's 3 x 3
// block, then lanes 0..24 the verdicts of the cells of f's window that are
// on the boundary now, written back by shared atomics. A cell off the
// boundary keeps its old verdict bit, which the valid word masks out; it
// joins the boundary only when one of its ring neighbours flips, and that
// flip's window holds it, so its verdict is recomputed then. So ok is the
// patch check wherever bnd is set, which is all that validity reads.
// The wall keys work the same way: the two smallest keys among the cut wall
// edges (first, second) and the last slope and angle stay in registers, and
// only a committed flip that has a wall edge (its edges' cut states all
// toggle) rescans the wall words, listed once a launch; the interface
// metrics run only when the pair changed.
//
// Per step and chain (the order of the JAX scan body):
//   1. the step's draws: every 32 steps one batch runs the key chain
//      (split counter 0 of each step's key) serially and then, lane i for
//      the batch's step i, the subkeys (split counters 1, 2, 3), their
//      uniforms and the logs that the accept test and the wait take; a
//      step reads its lane's values by shuffles;
//   2. the word pass: each lane owns words lane, lane + 32, ... (cell =
//      32 * word + bit, the canvas in flat row-major order); the valid word
//      is bnd & ok & the population gate (one test per district for a
//      uniform population), the boundary count a popcount of bnd; one warp
//      scan of the valid counts, two words' counts packed in one value;
//   3. complete the pending wait from the boundary count, record the row
//      (lane r < 8 writes row r): cut, b, wait, accepts, the flip-log pair,
//      and the resident slope / angle;
//   4. select the m-th valid cell in flat order, m = min(int(u * total),
//      total - 1), from the scan; accept by the literal base**(-dcut) bound
//      (or always), dcut from ballots of lanes 0..7 over the cell's edges;
//      commit, and bring the resident planes and the wall pair up to date
//      around the flip.
// The patch check is the member bitset over the B2 window (same district
// as the cell, in its patch), seeds = direct neighbours, reach grown from
// the lowest seed by a worklist over the patch adjacency. The JAX body runs
// b2_iters Jacobi rounds instead; b2_iters = the largest patch size - 1
// bounds every shortest path inside a patch, so both reach the same
// closure and give the same verdict. The bitsets are indexed by the
// position in the 5 x 5 window around the cell rather than by the JAX
// package's offset index (a relabelling of the same bits), so that the
// member set is five 5-bit board fields.
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
// Summary mode. The fold instantiation (kFold; fce_lowered_chunk with
// the fold's arrays) also folds each step's record into the run's summary
// accumulator, as the JAX package's scan bodies call fold_out on every
// yield (summary_fold.cuh): step t's record leaves a packet (the
// observable, the wait, the series sources) in lane t mod 32's registers,
// and every 32 steps the lanes store the batch to shared memory for the
// fold (a shared store in every step held back the step's other shared
// accesses). A ninth warp a block folds the batches, one lane a chain,
// through a ring of two on mbarriers, so the fold's serial steps (two
// IEEE divisions each) run beside the chains' next steps. While the
// blocks fit the SMs (C up to 8 a block times the SM count) a step's
// latency is the wall and the launch bounds let the chains take every
// register they want (with 56 a thread the C=8 chunk ran 1.00 ms against
// 0.73 on an H100); past that they keep the history kernel's blocks an
// SM, 56 registers a thread at one and two words a lane, and the fold
// warp still beat folding on each chain's warp (fold_turns.py). Without
// a history the rows only the fold reads are not written (the flip-log
// pair is). kFold = false is the history-mode kernel, untouched by any of
// it.
//
// What bounds it on an H100: instruction issue, not memory. Device memory
// carries the board in and out, the four cut planes out and the (T, C)
// rows. At C = 4096 an SM holds ~31 warps, one chain each, ~8 a scheduler,
// and each chain-step issues several hundred warp instructions: a little
// over one threefry block (the serial key chain; the rest of the draws
// are spread over the batch's lanes), three shared loads and a few logical
// operations a word, the packed scan, the wait's division (its log1p read
// from a per-block table by boundary count), and per accepted move the
// boundary words and the window's patch checks (each five 5-bit fields and
// a short worklist against the class rows in shared memory, padded so that
// lanes reading different classes do not share a bank).
// The per-step work no longer grows with the candidate count. The draws,
// the wall rescan and the interface metrics are out of line, to keep the
// step loop's code small. chip_smoke.py reports the operation floor of the
// run's data beside the measured time.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_common.cuh"
#include "summary_fold.cuh"

namespace {

using namespace fce;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChainsPerBlock = 8;
constexpr int kThreads = 32 * kChainsPerBlock;
constexpr uint32_t kIfaceBig = 1u << 30;
// a class row's stride in shared memory: 33 words, so that word q of
// different classes' rows lies in different banks
constexpr int kRowStride = 33;
// the fold warp's ring (summary_fold.cuh), one lane a chain of the block
using BlockRing = FoldRing<kChainsPerBlock>;

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
  FoldArgs fold;               // the summary accumulator (kFold only)
};

// Shared memory, in 32-bit words, sized at launch (NW = the board's words):
//   per block: the 8 record rows' pointers (16), adj 8 * NW, wall 4 * NW,
//     node NW, the class rows (kRowStride each), the wait's log1p table
//     (f32, N + 1), the cells' patch classes (uint16, N), the wall-word
//     list (uint16, NW) and its length;
//   per chain: board guard + NW + guard (guards zero: a window cell is at
//     most 2w + 2 cells away), then the planes flipped, bnd and ok, NW each;
//   under kFold, from a 16-byte boundary after the chains: the block's
//     fold ring.
struct Layout {
  int nw, guard, board, stat, chain, fold, fold_words;
  __host__ __device__ Layout(int n, int w, int n_classes, bool with_fold) {
    nw = (n + 31) >> 5;
    guard = ((2 * w + 2) >> 5) + 2;
    board = nw + 2 * guard;
    stat = 16 + 13 * nw + kRowStride * n_classes + (n + 1) + (n + 1) / 2 +
           (nw + 1) / 2 + 1;
    chain = board + 3 * nw;
    fold = (stat + kChainsPerBlock * chain + 3) & ~3;
    fold_words = with_fold ? int((sizeof(BlockRing) + 15) / 16 * 4) : 0;
  }
  size_t bytes() const {
    if (fold_words) return 4 * (size_t(fold) + size_t(fold_words));
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
// of forward plane d)
__device__ __forceinline__ void scan_walls(const int32_t* iface_key, int n,
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

// the two smallest wall keys among the cut wall edges of the board, over
// the listed wall words (the whole warp calls it): rare work, kept out of
// line so that the step loop's code stays small
__device__ __noinline__ void wall_pair(const uint32_t* B, const uint32_t* adjw,
                                       const uint32_t* wallw,
                                       const uint16_t* wlist, int n_ww,
                                       int nw, int w,
                                       const int32_t* iface_key, int n,
                                       uint32_t& first, uint32_t& second) {
  uint32_t min1 = kIfaceBig, min2 = kIfaceBig;
  const int fwd[4] = {1, w + 1, w, w - 1};  // E, SE, S, SW (w >= 3)
  for (int e = threadIdx.x & 31; e < n_ww; e += 32) {
    const int k = wlist[e];
    const uint32_t b = B[k];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint32_t wc = (b ^ shifted_fwd(B, k, fwd[d])) & adjw[d * nw + k] &
                          wallw[d * nw + k];
      if (wc) scan_walls(iface_key, n, d, k, wc, min1, min2);
    }
  }
  first = __reduce_min_sync(kFull, min1);
  second = __reduce_min_sync(kFull, min1 == first ? min2 : min1);
}

// slope and angle of the two wall edges with keys first < second (the JAX
// package's _interface_stencil, float step for float step); NaN with fewer
// than two cut wall edges
__device__ __noinline__ void interface_metrics(uint32_t first, uint32_t second,
                                               int qx_off, int qy_off, int bx,
                                               int by, float cx, float cy,
                                               float& slope, float& angle) {
  if (second >= kIfaceBig) {
    slope = angle = NAN;
    return;
  }
  const int f = static_cast<int>(first), s = static_cast<int>(second);
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
  const uint32_t* row = rows + kRowStride * cls[cell];
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

// the flat offset of ring direction d (E, SE, S, SW, W, NW, N, NE);
// directions d and d + 4 are opposite
__device__ __forceinline__ int ring_off(int d, int w) {
  const int o = (d & 3) == 0 ? 1 : (d & 3) == 1 ? w + 1 : (d & 3) == 2 ? w
                                                                     : w - 1;
  return d & 4 ? -o : o;
}

// the boundary bits of board word k: a ring edge of the cell is cut
__device__ __forceinline__ uint32_t boundary_word(const uint32_t* B,
                                                  const uint32_t* adjw,
                                                  int nw, int w, int k) {
  const uint32_t b = B[k];
  uint32_t bmask = 0u;
#pragma unroll
  for (int d = 0; d < 4; ++d)
    bmask |= (b ^ shifted_fwd(B, k, ring_off(d, w))) & adjw[d * nw + k];
#pragma unroll
  for (int d = 4; d < 8; ++d)
    bmask |= (b ^ shifted_back(B, k, ring_off(d, w))) & adjw[d * nw + k];
  return bmask;
}

// kFold adds a ninth warp that folds the block's records as the chain
// warps hand them over; without it, the history-mode kernel. MB, the
// blocks an SM the launch bounds ask for: WPL <= 2 ? 4 : 2, or 1 for a
// fold launch whose blocks fit the SMs.
template <int WPL, bool kFold, int MB>
__global__ void __launch_bounds__(kFold ? kThreads + 32 : kThreads, MB)
    lowered_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int w = a.w, n = a.h * a.w, C = a.n_chains, T = a.t_inner;
  const Layout L(n, w, a.n_classes, kFold);
  const int nw = L.nw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t** row_out = reinterpret_cast<int32_t**>(smem);  // the 8 rows
  uint32_t* adjw = smem + 16;                // [d * nw + k]
  uint32_t* wallw = adjw + 8 * nw;
  uint32_t* nodew = wallw + 4 * nw;
  uint32_t* rows = nodew + nw;
  // log1p_b[b] = log1pf(-b / (n_real**2 - 1)), the wait's denominator at
  // a boundary count of b (at most N)
  float* log1p_b = reinterpret_cast<float*>(rows + kRowStride * a.n_classes);
  uint16_t* cls = reinterpret_cast<uint16_t*>(log1p_b + n + 1);
  uint16_t* wlist = cls + 2 * ((n + 1) / 2);
  int* n_wall_words = reinterpret_cast<int*>(smem + L.stat - 1);

  if (threadIdx.x == 0) {  // the record's rows, in lane order
    row_out[0] = a.h_cut;
    row_out[1] = a.h_b;
    row_out[2] = reinterpret_cast<int32_t*>(a.h_wait);
    row_out[3] = a.h_acc;
    row_out[4] = a.log_f;
    row_out[5] = a.log_s;
    row_out[6] = reinterpret_cast<int32_t*>(a.h_slope);
    row_out[7] = reinterpret_cast<int32_t*>(a.h_angle);
  }
  for (int i = threadIdx.x; i < 8 * nw; i += kThreads)
    adjw[i] = a.adj_words[i];
  for (int i = threadIdx.x; i < 4 * nw; i += kThreads)
    wallw[i] = a.wall_words[i];
  for (int i = threadIdx.x; i < nw; i += kThreads) nodew[i] = a.node_words[i];
  for (int i = threadIdx.x; i < n; i += kThreads)
    cls[i] = static_cast<uint16_t>(a.cell_class[i]);
  for (int i = threadIdx.x; i < 32 * a.n_classes; i += kThreads)
    rows[kRowStride * (i >> 5) + (i & 31)] =
        static_cast<uint32_t>(a.class_rows[i]);
  const float denom =
      static_cast<float>(static_cast<double>(a.n_real) * a.n_real - 1.0);
  for (int i = threadIdx.x; i <= n; i += kThreads)
    log1p_b[i] = log1pf(-(static_cast<float>(i) / denom));
  if (warp == 0) {  // the words holding a wall bit, in order
    int cnt = 0;
    for (int k0 = 0; k0 < nw; k0 += 32) {
      const int k = k0 + lane;
      uint32_t any = 0u;
      if (k < nw)
        for (int d = 0; d < 4; ++d) any |= a.wall_words[d * nw + k];
      const unsigned has = __ballot_sync(kFull, any != 0u);
      if (any) wlist[cnt + __popc(has & ((1u << lane) - 1u))] = k;
      cnt += __popc(has);
    }
    if (lane == 0) *n_wall_words = cnt;
  }
  BlockRing* const ring = reinterpret_cast<BlockRing*>(smem + L.fold);
  const int c0 = blockIdx.x * kChainsPerBlock;
  if constexpr (kFold) {
    if (threadIdx.x == 0) {
      fold_ring_init(ring, min(kChainsPerBlock, C - c0));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();  // the only block barrier
  if constexpr (kFold) {
    if (warp == kChainsPerBlock) {
      fold_warp(a.fold, ring, T, c0, min(kChainsPerBlock, C - c0));
      return;
    }
  }

  const int c = c0 + warp;
  if (c >= C) return;
  uint32_t* board_all = smem + L.stat + warp * L.chain;
  uint32_t* B = board_all + L.guard;  // B[-guard .. nw + guard) readable
  uint32_t* flipped = board_all + L.board;
  uint32_t* bnd = flipped + nw;
  uint32_t* okw = bnd + nw;
  const size_t base = (size_t)c * n;
  const int n_ww = *n_wall_words;

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

  const int my_off = ring_off(lane, w);  // lane d < 8: direction d
  // after a flip at f, lane 2 * (dr + 1) + e < 6 recomputes the boundary
  // word e of the cells f + dr * w - 1 .. f + dr * w + 1 (f's ring and f
  // itself) and lane 5 * (dr + 2) + dc + 2 < 25 the patch verdict of
  // f + dr * w + dc (f's 5 x 5 window)
  const int bnd_row = (lane / 2 - 1) * w - 1;
  const int win_off = (lane / 5 - 2) * w + lane % 5 - 2;

  // ---- the resident planes of the chunk's first board ------------------
#pragma unroll
  for (int j = 0; j < WPL; ++j) {
    const int k = lane + 32 * j;
    if (k >= nw) continue;
    bnd[k] = boundary_word(B, adjw, nw, w, k);
    okw[k] = kFull;
  }
  if (a.patch) {
    for (int k = 0; k < nw; ++k) {
      const int i = 32 * k + lane;
      const uint32_t word =
          __ballot_sync(kFull, i < n && patch_ok(B, w, cls, rows, i));
      if (lane == (k & 31)) okw[k] = word;
    }
  }
  __syncwarp();
  uint32_t first = kIfaceBig, second = kIfaceBig;  // the resident wall pair
  float slope = NAN, angle = NAN;
  if (a.iface) {
    wall_pair(B, adjw, wallw, wlist, n_ww, nw, w, a.iface_key, n, first,
              second);
    interface_metrics(first, second, a.qx_off, a.qy_off, a.bx, a.by, a.cx,
                      a.cy, slope, angle);
  }

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
  const float unitf = static_cast<float>(a.unit_pop);
  const float lo = ceilf(pop_lo), hi = floorf(pop_hi);
  Draws draws{0u, 0u, 0u, 0.f, 0.f};  // lane i: step 32 * q + i's draws
  // the fold's packet of step 32 q + lane, kept in that lane's registers
  // until its batch ends (no shared store in the step), then stored into
  // the ring in one round
  float4 pk_mine = make_float4(0.f, 0.f, 0.f, 0.f);

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

    // ---- 2. word pass: bnd & ok & gate, counts by one packed scan -------
    const float p0f = static_cast<float>(dp0), p1f = static_cast<float>(dp1);
    const uint32_t gate0 = unitf <= fminf(p0f - lo, hi - p1f) ? kFull : 0u;
    const uint32_t gate1 = unitf <= fminf(p1f - lo, hi - p0f) ? kFull : 0u;
    int bcnt = 0;
    uint32_t valid[WPL];
    int cnt[WPL];
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      const int k = lane + 32 * j;
      valid[j] = 0u;
      if (k < nw) {
        const uint32_t b = B[k], bd = bnd[k];
        bcnt += __popc(bd);
        valid[j] = bd & okw[k] & ((b & gate1) | (~b & gate0));
      }
      cnt[j] = __popc(valid[j]);
    }
    const int b_count = __reduce_add_sync(kFull, bcnt);
    // inclusive prefix counts over the lanes, words j and j + 1 in the two
    // 16-bit halves of one value (at most 32 * 32 cells each)
    constexpr int NP = (WPL + 1) / 2;
    int incl[NP], tot[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      incl[p] = cnt[2 * p] + (2 * p + 1 < WPL ? cnt[2 * p + 1] << 16 : 0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int v = __shfl_up_sync(kFull, incl[p], d);
        if (lane >= d) incl[p] += v;
      }
    }
    int total = 0;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      tot[p] = __shfl_sync(kFull, incl[p], 31);
      total += (tot[p] & 0xFFFF) + (tot[p] >> 16);
    }

    // ---- 3. wait, record (lane r < 8 writes row r) ----------------------
    if (a.geom_waits && pending) {
      const float wn = floorf(log_wait / log1p_b[b_count]);
      cur_wait = fmaxf(wn, 0.f);
    }
    if constexpr (kFold) {
      // the fold's packet: the record's rows as floats, as fold_block
      // converts them (selects, not a switch: no branch in the step)
      auto rowf = [&](int r) -> float {
        const float fi = __int2float_rn(
            r == 0 ? cut_count : r == 1 ? b_count : r == 3 ? acc_cnt
            : r == 4 ? cur_flip : cur_sign);
        return r == 2 ? cur_wait : r == 6 ? slope : r == 7 ? angle : fi;
      };
      const FoldArgs& f = a.fold;
      const float4 p = make_float4(rowf(f.obs), cur_wait,
                                   f.src0 >= 0 ? rowf(f.src0) : 0.f,
                                   f.src1 >= 0 ? rowf(f.src1) : 0.f);
      if (lane == slot) pk_mine = p;
      if (t == T - 1 && lane == 0) f.accepts[c] = acc_cnt;
    }
    // without a history only the flip-log pair (rows 4, 5) is written
    if (lane < 8 &&
        (!kFold || a.fold.keep_rows || lane == 4 || lane == 5)) {
      const int v = lane == 0   ? cut_count
                    : lane == 1 ? b_count
                    : lane == 2 ? __float_as_int(cur_wait)
                    : lane == 3 ? acc_cnt
                    : lane == 4 ? cur_flip
                    : lane == 5 ? cur_sign
                    : lane == 6 ? __float_as_int(slope)
                                : __float_as_int(angle);
      row_out[lane][(size_t)t * C + c] = v;
    }
    waits_sum += cur_wait;

    // ---- 4. select the m-th valid cell in flat order --------------------
    const bool any_valid = total > 0;
    int m = static_cast<int>(u_prop * static_cast<float>(total));
    m = min(m, max(total - 1, 0));
    int before = 0, cell = -1;  // valid cells in the words of earlier j
#pragma unroll
    for (int j = 0; j < WPL; ++j) {
      const int sh = 16 * (j & 1);
      const int in_j = (incl[j / 2] >> sh) & 0xFFFF;
      const int lo_rank = before + in_j - cnt[j];
      if (m >= lo_rank && m < before + in_j)
        cell = 32 * (lane + 32 * j) + nth_bit(valid[j], m - lo_rank);
      before += (tot[j / 2] >> sh) & 0xFFFF;
    }
    const unsigned here = __ballot_sync(kFull, cell >= 0);
    const int src = here ? __ffs(here) - 1 : 0;
    const int flat = here ? __shfl_sync(kFull, cell, src) : 0;

    // ---- 5. accept and commit; lane d < 8 holds flat's edge d -----------
    const uint32_t d_from = bit_at(B, flat);
    const int nb = flat + my_off;
    const bool edge = lane < 8 && bit_at(adjw + (lane & 7) * nw, flat);
    const bool differs = edge && bit_at(B, nb) != d_from;
    const int dcut = __popc(__ballot_sync(kFull, edge)) -
                     2 * __popc(__ballot_sync(kFull, differs));
    bool accept = any_valid;
    if (!a.accept_always) {
      const float log_bound = -beta * static_cast<float>(dcut) * log_base;
      accept = any_valid && (log_acc < log_bound);
    }
    if (accept) {
      // cut_times events for the edges of flat: the loads now, the stores
      // after the planes' update, which hides their latency
      const bool was_flipped = bit_at(flipped, flat);
      // forward directions keep the edge at flat, backward at nb
      const int at = lane < 4 ? flat : nb;
      int32_t* const slot_ptr =
          a.cut_planes + ((size_t)(lane & 3) * C) * n + base + at;
      int last_i = 0, last_n = 0, acc_old = 0;
      bool wall_edge = false;
      if (edge) {
        const bool nb_flipped = bit_at(flipped, nb);
        if (was_flipped) last_i = a.last_flip[base + flat];
        if (nb_flipped) last_n = a.last_flip[base + nb];
        if (was_flipped || nb_flipped) acc_old = *slot_ptr;
        wall_edge = bit_at(wallw + (lane & 3) * nw, at);
      }
      // every edge of flat changes its cut state: a wall edge among them
      // changes the set of cut wall edges
      const bool touched = a.iface && __ballot_sync(kFull, wall_edge) != 0u;
      __syncwarp();
      if (lane == 0) {
        flipped[flat >> 5] |= 1u << (flat & 31);
        B[flat >> 5] ^= 1u << (flat & 31);
      }
      __syncwarp();
      // the resident planes around flat
      if (lane < 6) {
        const int row0 = flat + bnd_row;
        const int k = (row0 >> 5) + (lane & 1);
        if (k >= 0 && k < nw && k <= ((row0 + 2) >> 5))
          bnd[k] = boundary_word(B, adjw, nw, w, k);
      }
      __syncwarp();
      // verdicts only where the boundary now is (see the header)
      if (a.patch && lane < 25) {
        const int wc = flat + win_off;
        if (wc >= 0 && wc < n && bit_at(bnd, wc))
          put_bit(okw, wc, patch_ok(B, w, cls, rows, wc));
      }
      if (edge) {
        const int last = last_i > last_n ? last_i : last_n;
        *slot_ptr = acc_old + int(differs) * (t + 1 - last);
      }
      // after every lane's loads of it have returned (the stores above)
      if (lane == 0) a.last_flip[base + flat] = t + 1;
      if (touched) {
        uint32_t f2, s2;
        wall_pair(B, adjw, wallw, wlist, n_ww, nw, w, a.iface_key, n, f2,
                  s2);
        if (f2 != first || s2 != second) {
          first = f2;
          second = s2;
          interface_metrics(first, second, a.qx_off, a.qy_off, a.bx, a.by,
                            a.cx, a.cy, slope, angle);
        }
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
    if constexpr (kFold) {
      if (slot == 31 || t == T - 1) {  // the batch's records to the fold
        float4* fpk = fold_ring_acquire(ring, t >> 5) + warp;
        if (lane <= slot) fpk[lane * kChainsPerBlock] = pk_mine;
        fold_ring_publish(ring, t >> 5);
      }
    }
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
        const int nb = i + ring_off(d, w);
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

template <int WPL, bool kFold, int MB>
int launch(const Args& a, cudaStream_t stream) {
  auto kern = lowered_chunk_kernel<WPL, kFold, MB>;
  const size_t smem = Layout(a.h * a.w, a.w, a.n_classes, kFold).bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributePreferredSharedMemoryCarveout,
      int(cudaSharedmemCarveoutMaxShared));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (a.n_chains + kChainsPerBlock - 1) / kChainsPerBlock;
  kern<<<blocks, kFold ? kThreads + 32 : kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// kAllRegs: one block an SM in the launch bounds (MB = 1)
template <bool kFold, bool kAllRegs>
int launch_words(const Args& a, cudaStream_t s) {
  const int nw = (a.h * a.w + 31) >> 5;
  if (nw <= 32) return launch<1, kFold, kAllRegs ? 1 : 4>(a, s);
  if (nw <= 64) return launch<2, kFold, kAllRegs ? 1 : 4>(a, s);
  return launch<4, kFold, kAllRegs ? 1 : 2>(a, s);
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace

extern "C" {

// One chunk for every chain; returns a cudaError_t. With fold_ptrs (not
// null) the chunk also folds its records into the summary accumulator
// (summary_fold.cuh's fold_args: 14 pointers, 6 ints), and the rows that
// keep_rows leaves unwritten may be null.
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
    void* const* fold_ptrs, const int* fold_ints, void* stream) {
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
  const bool fold = fold_ptrs != nullptr;
  a.fold = fold ? fold_args(fold_ptrs, fold_ints) : FoldArgs{};
  const int nw = (h * w + 31) >> 5;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chains < 1 || h < 3 || w < 3 || t_inner < 1 || nw > 128 ||
      n_classes < 1 || Layout(h * w, w, n_classes, fold).bytes() > 227 * 1024)
    return int(cudaErrorInvalidValue);
  if (!fold) return launch_words<false, false>(a, s);
  const int blocks = (n_chains + kChainsPerBlock - 1) / kChainsPerBlock;
  return blocks <= sm_count() ? launch_words<true, true>(a, s)
                              : launch_words<true, false>(a, s);
}

}  // extern "C"
