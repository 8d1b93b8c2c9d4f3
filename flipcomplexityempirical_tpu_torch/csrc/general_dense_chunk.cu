// General-dense chunk kernel: t_inner steps of the rejection-free
// 2-district flip chain on an arbitrary sparse graph (the hex lattice, and
// any graph whose radius-r patches fit 32 slots), one warp per chain, the
// chunk loop inside the kernel.
//
// Replaces the JAX package's general_dense step,
// flipcomplexityempirical_tpu/kernel/dense.py::transition (:303: propose_dense
// :231, the shared commit of kernel/step.py:407 and refresh_conn_bits :186)
// followed by kernel/step.py::record (:519). On the TPU that step is XLA
// code under a scan, not a Pallas kernel; replayed as torch ops (the plain
// version, kernel/dense.py with kernel/step.py::record) it is hundreds of
// small launches a step. Here one launch runs the chunk. It is bit-equal to
// its plain version (kernel/cuda_dense.py::general_dense_chunk_reference)
// on every output, and draws the JAX package's threefry stream: split(key,
// 4) per step into (key, proposal, accept, wait), as dense.py:313 does.
//
// What bounds it on the H100. A chain's steps are serial, and the hex
// paths run few chains (8 a config, 32 a sweep batch): at C <= 132 a chunk
// takes T times one warp's latency through a step, a chain of dependent
// shared-memory loads, warp votes and shuffles; neither bytes (the state
// is read and written once) nor operations come near their bounds. At
// C=4096 (the bench) ~32 warps share an SM, and issue slots, the tables'
// L1 misses and the chunk's start (the (C, N) and (C, E) fields copied in)
// set the pace. So a step reads only shared memory and registers, and what
// it does not read back leaves its serial path:
//   - per chain in shared memory, five bit planes of ceil(N / 32) words:
//     the assignment A (district 1), the boundary Bd (a neighbour in the
//     other district), the contiguity plane Cn (the state's conn_bits), Y
//     (conn bits left stale: see 3) and R (the nodes that closed a parity
//     run in this chunk), and per group of 32 words the count of each
//     district's candidates Bd & Cn & ~A and Bd & Cn & A, kept up to date:
//     a flip changes them only at v, its neighbours and its patch;
//   - the graph's tables (patch slots and adjacency bitsets in rows of 8k
//     slots, neighbour slots and edges, degrees, node ids as uint16) are
//     staged into shared memory once a block by bulk asynchronous copies
//     (cp.async.bulk on an mbarrier) where they fit beside the block's
//     chains (hex 14x28: 166 KB), and read through L1 otherwise (64x64
//     hex: 1.6 MB); the C entry chooses by size;
//   - at C <= the SM count and patch rows of at most 24 slots (hex and
//     tri: P = 18), one chain a block with a second warp that runs
//     the threefry key chain and the step's uniforms 32 steps a batch,
//     ahead of the chain, into a ring in shared memory handed over on
//     mbarriers, and the chain's member masks (below); at larger C up to 8
//     chains a block, 64 registers a thread, each warp drawing its own
//     batches (chain_common.cuh::draw_batch).
// Per step and chain:
//   1. the step's draws from the batch (lane i holds step 32 q + i's);
//   2. the selection, m = min(int(u * total), max(total - 1, 0)), under
//      the population gate, one f32 test per district for a uniform
//      population (dense.py:210): the group of the m-th valid node from a
//      warp prefix of the gated group counts, the word from a prefix of the
//      group's gated word popcounts (one independent ballot a bit of the
//      counts), the bit by a ballot; under nobacktrack the excluded last
//      flip is taken out of its group and word. All of it but m depends on
//      the state only, so a rejected step reuses it. A population that
//      varies by node is gated per candidate: that case rebuilds the valid
//      words each step, as the kernel always did. With no valid node the
//      selection is node 0 and nothing is committed (the JAX body's
//      self-loop);
//   3. accept by the literal bound -beta * dcut * log_base against
//      log(max(u, 1e-12)), lanes s < D holding v's neighbour slot s; on an
//      accepted move, lane i holding v (i = 0) or its patch slot i - 1 (the
//      first deg(v) of which are its neighbours): each node's boundary bit
//      after the flip (a neighbour's from A and its own neighbour slots),
//      its conn bit by a kernel/contiguity.py::patch_connected check where
//      it is on the boundary, all against A with v flipped, before
//      anything is written; then the commit of A, Bd, Cn and the group
//      counts. A conn bit counts only on the boundary, so off it a node is
//      marked stale (Y) instead of checked: it is checked when it joins
//      the boundary (always as a neighbour of a flipped node, so a touched
//      one) or at the chunk's end. A check gathers its P member slots with
//      the loads issued together (narrow form) or reads the node's member
//      mask, kept up to date at every flip through the reverse-slot table
//      (wide form), then grows the reach over the slots' adjacency words
//      (a worklist, or every slot at once in registers);
//   4. the (T, C) rows cut_count, b_count, wait, accepts and weight (1 +
//      wait, under lazy_uniform), plain stores, and under record_interface
//      (kIface) slope and angle.
// The interface metrics (kernel/step.py:576 interface_metrics: the two
// wall-cut edges of smallest edge index, the slope of their midpoints and
// the angle they subtend at the center) keep, per chain in shared memory,
// a bitset W of the graph's wall edges by rank (the wall edges in edge
// order, at most 1024) that are cut. An accepted flip toggles the bits of
// v's wall edges whose cut state changes; the two lowest set bits are found
// by a warp ballot over W's words, and the metrics are recomputed only when
// one of the two changes, from the edges' f32 midpoints (the wrapper's
// table, (p0 + p1) / 2 as the plain version computes it) in the plain
// version's float order. The hex and tri lattices have no walls and run
// the kIface = false instantiations, which hold none of this.
// The records nothing in the step reads back are fire-and-forget global
// reductions (the second of the two ways the redesign allows; no flip log):
//   - cut_times: the reference adds the cut plane every yield. An edge's
//     cut state changes only when one of its ends flips, by +-1, and the
//     change at step t is seen by the T - t yields t..T-1, so the chunk
//     starts from cut_times + cut * T and each accepted flip adds
//     delta * (T - t) to each of v's edges;
//   - the parity quirk (step.py:538-551: part_sum, last_flipped and
//     num_flips of cur_flip_node advance on every yield once a first move
//     was accepted). Between two accepted moves cur_flip_node is one node
//     x in one district b, so the run of k yields ending at yield e adds
//     -s * (e - lf) to part_sum[x], with lf x's last_flipped before it, and
//     sets last_flipped[x] = e, num_flips[x] += k. The run after it at x
//     starts with a flip of x, so its sign is label[1 - b]: closing a run
//     adds (label[1 - b] - s) * e and k, stores e, and marks x in R; the
//     chunk end adds, for each x in R, s1 * lf_in[x] - label[1 - b_end] *
//     e_last with s1 the sign of x's first run in the chunk. Nothing is
//     read back inside the step; the chunk-end pass reads last_flipped
//     once per node of R (tests/test_torch_dense_bookkeeping.py holds a
//     numpy model of this arithmetic to the plain version).
// cut and cut_deg are written at the chunk's end from A.
// Summary mode (kFold; fce_general_dense_chunk with the fold's arrays)
// also folds each record into the run's summary accumulator, as the JAX
// package's scan bodies call fold_out on every yield (summary_fold.cuh):
// step t's record leaves a packet in lane t mod 32's registers, and every
// 32 steps the lanes store the batch to shared memory for the fold. In
// the wide form a third warp of the block folds it, behind a ring of two
// batches on mbarriers, so its serial steps run beside the chain's next
// ones. In the narrow form the chain's own warp folds it: a fold warp
// there, with the 4 blocks an SM kept (56 registers a thread), ran 0.07
// to 0.34 ms slower a 500-step chunk at 64x64 hex and C=4096 on an H100
// (fold_turns.py). Without a history no row is written. kFold = false is
// the history-mode kernel.
//
// Traps the code keeps:
//   - the wait denominator is N**2 - 1 over the graph's nodes, in f32
//     (double then rounded, as Python computes it);
//   - the population tests are f32 subtractions and additions of the
//     tallies and pop[i], compared with pop_lo / pop_hi, not integer ones;
//   - patch pad slots hold the node itself and are neither members nor
//     refreshed twice;
//   - float steps in the JAX order, built with -fmad=false: logf, log1pf,
//     floorf and IEEE division, the device functions torch's CUDA ops call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_common.cuh"
#include "summary_fold.cuh"

namespace {

using namespace fce;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxChainsPerBlock = 8;
constexpr int kPlanes = 5;        // A, Bd, Cn, Y, R
constexpr int kGroupShift = 10;   // 32 words, 1024 nodes, a count group
constexpr int kWidePp = 24;       // patch row slots the wide form holds
constexpr size_t kSmemLimit = 227 * 1024;
// the narrow form's fold area a chain: 32 packets and its FoldState
constexpr size_t kFoldChainBytes =
    32 * sizeof(float4) + ((sizeof(FoldState) + 15) & ~size_t(15));
constexpr size_t kFoldRingBytes = (sizeof(FoldRing<1>) + 15) & ~size_t(15);

// the packed tables (chain_common.cuh::table_layout), staged or in global
// memory
struct Tables {
  const uint32_t* padj;
  const uint16_t* pn;
  const uint32_t* nedge;
  const uint32_t* slots;
  const uint16_t* nbr;
  const uint8_t* deg;
  const uint8_t* rev;
  int pp;  // a patch row's slots
};

struct Args {
  const uint8_t* tables;        // table_layout, 16-byte aligned
  const int32_t* edges;         // (E, 2) edge ends
  const int32_t* pop;           // (N,)
  // per chain in
  const int32_t* key_in;        // (2, C) uint32 key words
  const int8_t* assign_in;      // (C, N)
  const int8_t* cut_in;         // (C, E)
  const int8_t* cut_deg_in;     // (C, N)
  const int32_t* dist_pop_in;   // (2, C)
  const int32_t* conn_in;       // (C, W), unread under fill_conn
  const float* scal_in;         // (6, C): log_base, beta, pop_lo, pop_hi,
                                //   cur_wait, waits_sum
  const int32_t* ints_in;       // (8, C): cut_count, b_count, cur_flip,
                                //   t_yield, move_clock, accepts, tries,
                                //   exhausted
  const int32_t* part_sum_in;   // (C, N)
  const int32_t* last_flipped_in;
  const int32_t* num_flips_in;
  const int32_t* cut_times_in;  // (C, E)
  // per chain out
  int32_t* key_out;
  int8_t* assign_out;
  int8_t* cut_out;
  int8_t* cut_deg_out;
  int32_t* dist_pop_out;
  int32_t* conn_out;
  float* scal_out;              // (2, C): cur_wait, waits_sum
  int32_t* ints_out;            // (8, C)
  int32_t* part_sum_out;
  int32_t* last_flipped_out;
  int32_t* num_flips_out;
  int32_t* cut_times_out;
  int32_t* h_cut;               // (T, C) rows
  int32_t* h_b;
  float* h_wait;
  int32_t* h_acc;
  float* h_weight;
  int n_chains, n, e, d, p, t_inner;
  int patch, geom_waits, nobacktrack, lazy, parity, fill_conn;
  int unit_pop;                 // > 0: every node's population; 0: varies
  int label0, label1;
  // the launch shape (the C entry's): chains a block, the bytes of a
  // chain's shared memory
  int cpb, chain_bytes;
  FoldArgs fold;                // the summary accumulator (kFold only)
  // the interface metrics (kIface only)
  const int32_t* wall_rank;     // (E,) an edge's rank among the wall
                                //   edges, -1 off the walls
  const int32_t* wall_edges;    // (n_wall,) the wall edges in edge order
  const float2* wall_mid;       // (n_wall,) their f32 midpoints
  float* h_slope;               // (T, C) rows
  float* h_angle;
  int n_wall, nww;              // wall edges, their words (0: no kIface)
  float cx, cy;                 // the angle's center
};

// the ranks of the two lowest set bits of a chain's wall bitset W (nww <=
// 32 words, lane k reading word k), -1 where there are fewer; the whole
// warp, every lane gets the same answer
__device__ __forceinline__ void wall_pair(const uint32_t* W, int nww,
                                          int& first, int& second) {
  const int lane = threadIdx.x & 31;
  const uint32_t w = lane < nww ? W[lane] : 0u;
  const uint32_t nz = __ballot_sync(kFull, w != 0u);
  first = second = -1;
  if (nz == 0u) return;
  const int f = __ffs(nz) - 1;
  const uint32_t wf = __shfl_sync(kFull, w, f);
  first = 32 * f + __ffs(wf) - 1;
  const uint32_t rest = wf & (wf - 1u);
  if (rest != 0u) {
    second = 32 * f + __ffs(rest) - 1;
    return;
  }
  const uint32_t above = nz & ~((2u << f) - 1u);  // f = 31: none above
  if (above == 0u) return;
  const int g = __ffs(above) - 1;
  second = 32 * g + __ffs(__shfl_sync(kFull, w, g)) - 1;
}

// slope and angle of the wall edges of ranks first < second (the plain
// version's float steps, kernel/step.py::interface_metrics); NaN with
// fewer than two cut wall edges
__device__ __noinline__ void wall_metrics(const float2* mid, int first,
                                          int second, float cx, float cy,
                                          float& slope, float& angle) {
  if (second < 0) {
    slope = angle = NAN;
    return;
  }
  const float2 pa = __ldg(mid + first), pb = __ldg(mid + second);
  const float ax = pa.x, ay = pa.y, ex = pb.x, ey = pb.y;
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

// kernel/contiguity.py::patch_connected of node u against the assignment
// A with v's bit flipped (the checks of a move run before its commit):
// the same-district members of u's patch (pads and u left out), seeds =
// members among the first deg(u) slots (u's neighbours), reach grown from
// the lowest seed over the members' slot adjacency until every seed is
// reached (true) or nothing new is (false).
//
// The narrow form (up to 8 chains a block, 64 registers a thread): seeds
// first (at most one: true without the rest), the other slots' loads six
// at a time, then a worklist that keeps reach, frontier and members in
// registers and reads one adjacency word a turn.
template <bool kStaged>
__device__ __forceinline__ bool patch_connected(const Tables& tab,
                                                const uint32_t* A, int u,
                                                int v, int P) {
  const int du = ld<kStaged>(tab.deg + u);
  const uint32_t au = bit_at(A, u) ^ uint32_t(u == v);
  const uint16_t* pn = tab.pn + size_t(u) * tab.pp;
  auto same = [&](int s) {  // branch-free: the loads issue together
    const int x = ld<kStaged>(pn + s);
    const uint32_t ax = bit_at(A, x) ^ uint32_t(x == v);
    return uint32_t(ax == au && x != u) << s;
  };
  uint32_t seeds = 0u;
#pragma unroll 4
  for (int s = 0; s < du; ++s) seeds |= same(s);
  if ((seeds & (seeds - 1u)) == 0u) return true;  // at most one seed
  uint32_t member = seeds;
#pragma unroll 6
  for (int s = du; s < P; ++s) member |= same(s);
  const uint32_t* pa = tab.padj + size_t(u) * tab.pp;
  uint32_t reach = seeds & (0u - seeds), frontier = reach;
  while (frontier) {
    const int s = __ffs(frontier) - 1;
    frontier &= frontier - 1u;
    const uint32_t nb = ld<kStaged>(pa + s) & member & ~reach;
    reach |= nb;
    frontier |= nb;
    if ((seeds & ~reach) == 0u) return true;
  }
  return false;
}

// The wide form (one chain a block, registers to spare) keeps each node's
// member mask M[u] (bit s: patch slot s of u is in u's district) in
// shared memory, updated at every move: a flip of v toggles v's slot in
// the mask of each node of v's patch (rev gives the slot) and every slot
// of v's own. A check then reads M[u], u's degree and its adjacency words
// (16-byte vectors, all at once) and grows the reach a frontier at a time
// over every slot in registers.
//
// The member mask of u against A, from u's slot ids as 16-byte vectors
// and the slots' assignment bits, all loads at once (branch-free).
template <bool kStaged>
__device__ __forceinline__ uint32_t member_mask(const Tables& tab,
                                                const uint32_t* A, int u) {
  const int nq = tab.pp >> 3;  // 8 slots a vector of ids, nq <= kWidePp / 8
  const uint4* pn4 =
      reinterpret_cast<const uint4*>(tab.pn + size_t(u) * tab.pp);
  const uint32_t uu = uint32_t(u) | uint32_t(u) << 16;
  uint32_t ids[kWidePp / 2];
#pragma unroll
  for (int q = 0; q < kWidePp / 8; ++q) {
    const uint4 w = q < nq ? ld<kStaged>(pn4 + q) : make_uint4(uu, uu, uu, uu);
    ids[4 * q] = w.x;
    ids[4 * q + 1] = w.y;
    ids[4 * q + 2] = w.z;
    ids[4 * q + 3] = w.w;
  }
  const uint32_t au = bit_at(A, u);
  uint32_t member = 0u;
#pragma unroll
  for (int s = 0; s < kWidePp; ++s) {
    const int x = (ids[s >> 1] >> (16 * (s & 1))) & 0xFFFF;
    member |= uint32_t(bit_at(A, x) == au && x != u) << s;
  }
  return member;
}

// kernel/contiguity.py::patch_connected of u from its member mask.
template <bool kStaged>
__device__ __forceinline__ bool patch_connected_wide(const Tables& tab,
                                                     int u, uint32_t member) {
  const int nq = tab.pp >> 3;
  const uint4* pa4 =
      reinterpret_cast<const uint4*>(tab.padj + size_t(u) * tab.pp);
  uint32_t adj[kWidePp];
#pragma unroll
  for (int q = 0; q < kWidePp / 4; ++q) {
    const uint4 w = q < 2 * nq ? ld<kStaged>(pa4 + q) : make_uint4(0, 0, 0, 0);
    adj[4 * q] = w.x;
    adj[4 * q + 1] = w.y;
    adj[4 * q + 2] = w.z;
    adj[4 * q + 3] = w.w;
  }
  const int du = ld<kStaged>(tab.deg + u);
  const uint32_t first = du >= 32 ? kFull : ((1u << du) - 1u);
  const uint32_t seeds = member & first;
  if ((seeds & (seeds - 1u)) == 0u) return true;  // at most one seed
  uint32_t reach = seeds & (0u - seeds), frontier = reach;
  while (true) {
    uint32_t g0 = 0u, g1 = 0u, g2 = 0u, g3 = 0u;
#pragma unroll
    for (int s = 0; s < kWidePp; s += 4) {
      g0 |= adj[s] & (0u - ((frontier >> s) & 1u));
      g1 |= adj[s + 1] & (0u - ((frontier >> (s + 1)) & 1u));
      g2 |= adj[s + 2] & (0u - ((frontier >> (s + 2)) & 1u));
      g3 |= adj[s + 3] & (0u - ((frontier >> (s + 3)) & 1u));
    }
    const uint32_t grown = (g0 | g1 | g2 | g3) & member & ~reach;
    reach |= grown;
    if ((seeds & ~reach) == 0u) return true;
    if (grown == 0u) return false;
    frontier = grown;
  }
}

// kWide: one chain a block with its draws warp (C up to the SM count),
// patch rows of at most kWidePp slots in registers; else up to
// kMaxChainsPerBlock chains a block, 64 registers a thread. kFold: the
// summary fold of the records (summary_fold.cuh), on a third warp of the
// block in the wide form, on the chain's own warp every 32 steps in the
// narrow one; without it, the history-mode kernel.
template <bool kStaged, bool kWide, bool kFold, bool kIface>
__global__ void __launch_bounds__(kWide ? (kFold ? 96 : 64)
                                        : 32 * kMaxChainsPerBlock,
                                  kWide ? 1 : 4)
    general_dense_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, E = a.e, D = a.d, P = a.p, C = a.n_chains, T = a.t_inner;
  const int nw = (n + 31) >> 5, ng = (nw + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TableLayout lay = table_layout(n, D, P);
  // shared memory: [table barrier | tables if staged | ring if producer |
  //                 the block's chains]
  uint64_t* tbar = reinterpret_cast<uint64_t*>(smem);
  size_t off = 16;
  const unsigned char* tbase = a.tables;
  if constexpr (kStaged) {
    tbase = smem + off;
    off += lay.bytes;
  }
  Ring* ring = reinterpret_cast<Ring*>(smem + off);
  if constexpr (kWide) off += (sizeof(Ring) + 15) & ~size_t(15);
  FoldRing<1>* fring = reinterpret_cast<FoldRing<1>*>(smem + off);
  if constexpr (kWide && kFold) off += kFoldRingBytes;
  if (threadIdx.x == 0) {
    if constexpr (kStaged) mbar_init(tbar, 1);
    if constexpr (kWide)
      for (int s = 0; s < kRing; ++s) {
        mbar_init(&ring->full[s], 32);
        mbar_init(&ring->empty[s], 32);
      }
    if constexpr (kWide && kFold) fold_ring_init(fring, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (kStaged) {
    if (threadIdx.x == 0)
      bulk_load(smem + 16, a.tables, static_cast<uint32_t>(lay.bytes), tbar);
  }
  if (kWide && warp == 1) {  // no block barrier below
    produce_draws(a.key_in, a.key_out, C, T, ring, blockIdx.x);
    return;
  }
  if constexpr (kWide && kFold) {
    if (warp == 2) {  // the chain's records, one batch behind it
      fold_warp(a.fold, fring, T, blockIdx.x, 1);
      return;
    }
  }
  const int c = blockIdx.x * a.cpb + warp;
  if (c >= C) return;  // no block barrier below
  Tables tab;
  tab.padj = reinterpret_cast<const uint32_t*>(tbase + lay.padj);
  tab.nedge = reinterpret_cast<const uint32_t*>(tbase + lay.nedge);
  tab.pn = reinterpret_cast<const uint16_t*>(tbase + lay.pn);
  tab.nbr = reinterpret_cast<const uint16_t*>(tbase + lay.nbr);
  tab.deg = tbase + lay.deg;
  tab.slots = reinterpret_cast<const uint32_t*>(tbase + lay.slots);
  tab.rev = tbase + lay.rev;
  tab.pp = lay.pp;
  uint32_t* A = reinterpret_cast<uint32_t*>(smem + off +
                                            size_t(warp) * a.chain_bytes);
  uint32_t* Bd = A + nw;
  uint32_t* Cn = Bd + nw;
  uint32_t* Y = Cn + nw;
  uint32_t* R = Y + nw;
  int* G = reinterpret_cast<int*>(R + nw);  // G[d * ng + j], district d
  uint32_t* W = reinterpret_cast<uint32_t*>(G + 2 * ng);  // kIface: (nww,)
  uint32_t* M = W + a.nww;                                // wide: (N,)
  // the fold's packet of step 32 q + lane, kept in that lane's registers
  // until its batch ends (no shared store in the step), then stored at
  // fpk[lane]; in the narrow form fpk and the chain's FoldState lie from a
  // 16-byte boundary after G
  float4 pk_mine = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* fpk = nullptr;
  FoldState* fst = nullptr;
  if constexpr (kFold && !kWide) {
    fpk = reinterpret_cast<float4*>(
        reinterpret_cast<unsigned char*>(A) +
        ((4 * (size_t(kPlanes) * nw + 2 * ng + a.nww) + 15) & ~size_t(15)));
    fst = reinterpret_cast<FoldState*>(fpk + 32);
  }
  const size_t bn = (size_t)c * n, be = (size_t)c * E;

  // ---- the chain in: planes, and the fields updated in place ----------
#pragma unroll 8
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    const bool in = i < n;
    const int8_t av = in ? a.assign_in[bn + i] : int8_t(0);
    const int8_t cd = in ? a.cut_deg_in[bn + i] : int8_t(0);
    const uint32_t wa = __ballot_sync(kFull, in && av == 1);
    const uint32_t wb = __ballot_sync(kFull, in && cd > 0);
    const uint32_t wn = __ballot_sync(kFull, in);
    if (lane == 0) {
      A[k] = wa;
      Bd[k] = wb;
      R[k] = 0u;
      // a run's first chunk: every conn bit stale (Cn filled below)
      Y[k] = a.fill_conn && a.patch ? wn : 0u;
      if (a.fill_conn) Cn[k] = a.patch ? 0u : wn;
    }
  }
  if (!a.fill_conn)
    for (int k = lane; k < nw; k += 32)
      Cn[k] = static_cast<uint32_t>(a.conn_in[(size_t)c * nw + k]);
  copy_rows(a.part_sum_in, a.last_flipped_in, a.num_flips_in, a.cut_times_in,
            a.cut_in, a.part_sum_out, a.last_flipped_out, a.num_flips_out,
            a.cut_times_out, bn, be, n, E, T);
  // the interface: the cut wall edges, and the metrics of the state in
  int w_first = -1, w_second = -1;
  float slope = NAN, angle = NAN;
  if constexpr (kIface) {
    for (int k = 0; k < a.nww; ++k) {
      const int r = 32 * k + lane;
      const uint32_t w = __ballot_sync(
          kFull, r < a.n_wall && a.cut_in[be + a.wall_edges[r]] != 0);
      if (lane == 0) W[k] = w;
    }
    __syncwarp();
    wall_pair(W, a.nww, w_first, w_second);
    wall_metrics(a.wall_mid, w_first, w_second, a.cx, a.cy, slope, angle);
  }
  if constexpr (kStaged) mbar_wait(tbar, 0);
  __syncwarp();
  if constexpr (kWide) {  // the member masks of the chain's nodes
    if (a.patch) {
      for (int i = lane; i < n; i += 32)
        M[i] = member_mask<kStaged>(tab, A, i);
      __syncwarp();
    }
  }
  // the patch check of node x against A with v's bit flipped (v = -1: A);
  // the wide form reads x's member mask, `flip` the slots v's flip toggles
  auto check = [&](int x, int v, uint32_t flip) {
    if constexpr (kWide)
      return patch_connected_wide<kStaged>(tab, x, M[x] ^ flip);
    else
      return patch_connected<kStaged>(tab, A, x, v, P);
  };
  // the conn bits of the stale nodes of `mask` (one word a turn), checked
  // against A and cleared from Y
  auto refresh_stale = [&](const uint32_t* mask) {
    for (int k = 0; k < nw; ++k) {
      const uint32_t w = Y[k] & mask[k];
      if (w == 0u) continue;
      const bool mine = (w >> lane) & 1u;
      const uint32_t ok = __ballot_sync(
          kFull, mine && check(32 * k + lane, -1, 0u));
      if (lane == 0) {
        Cn[k] = (Cn[k] & ~w) | (ok & w);
        Y[k] &= ~w;
      }
      __syncwarp();
    }
  };
  // a conn bit counts only where Bd is set: those are kept exact, the
  // others may stay stale (Y) until their node joins the boundary or the
  // chunk ends
  if (a.fill_conn && a.patch) refresh_stale(Bd);
  for (int j = 0; j < ng; ++j) {  // the candidate counts of each group
    const int k = 32 * j + lane;
    const uint32_t cand = k < nw ? Bd[k] & Cn[k] : 0u;
    const uint32_t av = k < nw ? A[k] : 0u;
    const int c0 = __reduce_add_sync(kFull, __popc(cand & ~av));
    const int c1 = __reduce_add_sync(kFull, __popc(cand & av));
    if (lane == 0) {
      G[j] = c0;
      G[ng + j] = c1;
    }
  }
  __syncwarp();

  uint32_t key0 = static_cast<uint32_t>(a.key_in[c]);
  uint32_t key1 = static_cast<uint32_t>(a.key_in[C + c]);
  const float log_base = a.scal_in[c], beta = a.scal_in[C + c];
  const float pop_lo = a.scal_in[2 * C + c], pop_hi = a.scal_in[3 * C + c];
  float cur_wait = a.scal_in[4 * C + c], waits_sum = a.scal_in[5 * C + c];
  int dp0 = a.dist_pop_in[c], dp1 = a.dist_pop_in[C + c];
  int cut_count = a.ints_in[c], b_count = a.ints_in[C + c],
      cur_flip = a.ints_in[2 * C + c];
  const int t_yield = a.ints_in[3 * C + c];
  int move_clock = a.ints_in[4 * C + c], acc_cnt = a.ints_in[5 * C + c],
      tries = a.ints_in[6 * C + c], exh_cnt = a.ints_in[7 * C + c];
  const int flip_in = cur_flip;
  int run_start = 0, first_accept = T;  // the parity run at cur_flip
  const float denom =
      static_cast<float>(static_cast<double>(n) * n - 1.0);
  const bool unit = a.unit_pop > 0;
  const float unitf = static_cast<float>(a.unit_pop);
  const int K = a.patch ? P : D;  // touched slots besides v: patch or nbrs
  auto label = [&](uint32_t b) { return b ? a.label1 : a.label0; };
  // the selection's cache (uniform population; refreshed after a move)
  bool fresh = false, open0 = false, open1 = false;
  int sel_total = 0, xg = -1, xw = -1, g_cnt = 0, g_incl = 0, last_g = -1;
  int w_cnt = 0, w_below = 0;
  uint32_t w_word = 0u;
  const uint32_t lt = (1u << lane) - 1u;  // the lanes below this one
  Draws draws{0u, 0u, 0u, 0.f, 0.f};  // lane i: step 32 * q + i's draws
  if constexpr (kFold && !kWide) fold_state_start(a.fold, fst, c);

  // a parity run at x (district b) over yields ..e, k of them, closes
  auto close_run = [&](int x, uint32_t b, int t_end) {
    const int e_last = t_yield + t_end - 1;
    const size_t at = bn + x;
    atomicAdd(a.part_sum_out + at, (label(1u - b) - label(b)) * e_last);
    atomicAdd(a.num_flips_out + at, t_end - run_start);
    a.last_flipped_out[at] = e_last;
    R[x >> 5] |= 1u << (x & 31);
  };

  for (int t = 0; t < T; ++t) {
    // ---- 1. the step's uniforms, 32 steps at a time -------------------
    const int slot = t & 31;
    if (slot == 0) {
      if constexpr (kWide) {
        draws = take_draws(ring, t);
      } else {
        draws = draw_batch(key0, key1, min(32, T - t));
        key0 = draws.key0;
        key1 = draws.key1;
      }
    }
    const float u_prop = uniform_of(__shfl_sync(kFull, draws.prop, slot));
    const float log_acc = __shfl_sync(kFull, draws.log_acc, slot);
    const float log_wait = __shfl_sync(kFull, draws.log_wait, slot);

    // ---- 2. the m-th valid node -----------------------------------------
    int total, v = 0;
    if (unit) {
      // the state changes only at an accepted move: a rejected step reuses
      // the gates, the gated counts, the group prefix and the last group's
      // word prefix, and only m changes
      if (!fresh) {
        const float p0f = static_cast<float>(dp0);
        const float p1f = static_cast<float>(dp1);
        // a node of district 0 moves to 1: 0 loses it, 1 gains it
        open0 = (p0f - unitf >= pop_lo) && (p1f + unitf <= pop_hi);
        open1 = (p1f - unitf >= pop_lo) && (p0f + unitf <= pop_hi);
        // the excluded node counts only where it is a gated candidate
        const bool excl = a.nobacktrack && cur_flip >= 0 &&
                          bit_at(Bd, cur_flip) && b_count > 1 &&
                          bit_at(Cn, cur_flip) &&
                          (bit_at(A, cur_flip) ? open1 : open0);
        xg = excl ? cur_flip >> kGroupShift : -1;
        xw = excl ? cur_flip >> 5 : -1;
        if (ng == 1) {  // every lane reads the one group's counts
          sel_total = (open0 ? G[0] : 0) + (open1 ? G[1] : 0) - int(excl);
        } else if (ng <= 32) {  // lane j holds group j's prefix
          g_cnt = lane < ng ? (open0 ? G[lane] : 0) +
                                  (open1 ? G[ng + lane] : 0) - int(lane == xg)
                            : 0;
          g_incl = incl_scan(g_cnt, lane);
          sel_total = __shfl_sync(kFull, g_incl, 31);
        } else {
          int cnt = 0;
          for (int j = lane; j < ng; j += 32)
            cnt += (open0 ? G[j] : 0) + (open1 ? G[ng + j] : 0) - int(j == xg);
          sel_total = __reduce_add_sync(kFull, cnt);
        }
        last_g = -1;
        fresh = true;
      }
      total = sel_total;
      int m = static_cast<int>(u_prop * static_cast<float>(total));
      m = min(m, max(total - 1, 0));
      if (total > 0) {
        int g = 0, r = m;
        if (ng > 1 && ng <= 32) {  // the group of the m-th valid node
          g = __ffs(__ballot_sync(kFull, g_incl > m)) - 1;
          r = m - __shfl_sync(kFull, g_incl - g_cnt, g);
        } else if (ng > 32) {  // a scan of the gated group counts
          int before = 0;
          for (int j0 = 0; j0 < ng; j0 += 32) {
            const int j = j0 + lane;
            const int cj = j < ng ? (open0 ? G[j] : 0) +
                                        (open1 ? G[ng + j] : 0) - int(j == xg)
                                  : 0;
            const int incl = incl_scan(cj, lane);
            const int round = __shfl_sync(kFull, incl, 31);
            if (m < before + round) {
              const int rr = m - before;
              const int src = __ffs(__ballot_sync(kFull, incl > rr)) - 1;
              g = j0 + src;
              r = rr - __shfl_sync(kFull, incl - cj, src);
              break;
            }
            before += round;
          }
        }
        if (g != last_g) {
          // the group's gated words and the prefix of their popcounts,
          // one independent ballot a bit of the counts (at most 32)
          const int k = (g << 5) + lane;
          w_word = 0u;
          if (k < nw) {
            const uint32_t av = A[k];
            w_word = Bd[k] & Cn[k] & ((open1 ? av : 0u) | (open0 ? ~av : 0u));
            if (k == xw) w_word &= ~(1u << (cur_flip & 31));
          }
          w_cnt = __popc(w_word);
          w_below = 0;
#pragma unroll
          for (int b = 0; b < 6; ++b)
            w_below += __popc(__ballot_sync(kFull, (w_cnt >> b) & 1) & lt)
                       << b;
          last_g = g;
        }
        // the word, then the bit: the lane whose bit of the word is set
        // with rr set bits below it
        const int src = __ffs(__ballot_sync(kFull, w_below + w_cnt > r)) - 1;
        const int rr = r - __shfl_sync(kFull, w_below, src);
        const uint32_t ws = __shfl_sync(kFull, w_word, src);
        const uint32_t hit = __ballot_sync(
            kFull, ((ws >> lane) & 1u) && __popc(ws & lt) == rr);
        v = min(32 * ((g << 5) + src) + __ffs(hit) - 1, n - 1);
      }
    } else {
      // a population that varies by node: the valid words rebuilt, each
      // candidate's gate tested in f32 (dense.py::_pop_plane_bi)
      const float p0f = static_cast<float>(dp0);
      const float p1f = static_cast<float>(dp1);
      const bool excl = a.nobacktrack && cur_flip >= 0 &&
                        bit_at(Bd, cur_flip) && b_count > 1;
      auto valid_word = [&](int k) {
        uint32_t w = Bd[k] & Cn[k];
        if (excl && (cur_flip >> 5) == k) w &= ~(1u << (cur_flip & 31));
        const uint32_t av = A[k];
        uint32_t rest = w;
        while (rest) {
          const int bit = __ffs(rest) - 1;
          rest &= rest - 1u;
          const float pf = static_cast<float>(__ldg(a.pop + 32 * k + bit));
          const bool one = (av >> bit) & 1u;
          const float from = one ? p1f : p0f, to = one ? p0f : p1f;
          if (!((from - pf >= pop_lo) && (to + pf <= pop_hi)))
            w &= ~(1u << bit);
        }
        return w;
      };
      int cnt = 0;
      for (int k = lane; k < nw; k += 32) cnt += __popc(valid_word(k));
      total = __reduce_add_sync(kFull, cnt);
      int m = static_cast<int>(u_prop * static_cast<float>(total));
      m = min(m, max(total - 1, 0));
      if (total > 0) {
        int before = 0;
        for (int k0 = 0; k0 < nw; k0 += 32) {
          const int k = k0 + lane;
          const uint32_t w = k < nw ? valid_word(k) : 0u;
          const int cw = __popc(w);
          const int incl = incl_scan(cw, lane);
          const int round = __shfl_sync(kFull, incl, 31);
          if (m < before + round) {
            const int r = m - before;
            const int src = __ffs(__ballot_sync(kFull, incl > r)) - 1;
            const int below = __shfl_sync(kFull, incl - cw, src);
            const uint32_t ws = __shfl_sync(kFull, w, src);
            v = min(32 * (k0 + src) + nth_bit(ws, r - below), n - 1);
            break;
          }
          before += round;
        }
      }
    }

    // ---- 3. accept and commit; lane s < D holds v's slot s -------------
    const bool valid = total > 0;
    const uint32_t d_from = bit_at(A, v);
    const int dv = ld<kStaged>(tab.deg + v);
    const bool msk = lane < dv;
    const int nb = lane < D ? int(ld<kStaged>(tab.nbr + (size_t)v * D + lane))
                            : v;
    const uint32_t na = bit_at(A, nb);
    const bool oc = msk && na != d_from;
    const bool nc = msk && na == d_from;  // na != d_to
    const int n_new = __popc(__ballot_sync(kFull, nc));
    const int dcut = n_new - __popc(__ballot_sync(kFull, oc));
    const float log_bound = -beta * static_cast<float>(dcut) * log_base;
    const bool accept = valid && (log_acc < log_bound);
    if (accept) {
      // cut_times: v's edges change state now, seen by T - t yields
      const int eid = msk ? int(ld<kStaged>(tab.nedge + (size_t)v * D + lane))
                          : 0;
      if (msk)
        atomicAdd(a.cut_times_out + be + eid, (int(nc) - int(oc)) * (T - t));
      if constexpr (kIface) {  // v's wall edges whose cut state changes
        const int r = msk && nc != oc ? __ldg(a.wall_rank + eid) : -1;
        if (r >= 0) atomicXor(W + (r >> 5), 1u << (r & 31));
        if (__ballot_sync(kFull, r >= 0)) {
          __syncwarp();
          int f, s2;
          wall_pair(W, a.nww, f, s2);
          if (f != w_first || s2 != w_second) {
            w_first = f;
            w_second = s2;
            wall_metrics(a.wall_mid, f, s2, a.cx, a.cy, slope, angle);
          }
        }
      }
      // neighbour nb's boundary bit after the flip: a neighbour slot of nb
      // in the other district, v's district flipped (pads hold nb itself)
      bool bd_nb = false;
      if (msk) {  // up to 8 slots' loads at once, branch-free
        const uint16_t* row = tab.nbr + (size_t)nb * D;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int x = r < D ? int(ld<kStaged>(row + r)) : nb;
          bd_nb |= (bit_at(A, x) ^ uint32_t(x == v)) != na;
        }
        for (int r = 8; r < D; ++r) {
          const int x = ld<kStaged>(row + r);
          bd_nb |= (bit_at(A, x) ^ uint32_t(x == v)) != na;
        }
      }
      const bool bd_up = __shfl_up_sync(kFull, bd_nb, 1);
      const bool bd_31 = __shfl_sync(kFull, bd_nb, 31);
      // the touched nodes, slot i = lane (+ 32): v, then its patch (its
      // neighbours without contiguity), pads left out. A patch starts with
      // the node's neighbours in neighbour-slot order, so slot i <= deg(v)
      // is neighbour slot i - 1. Each slot's boundary bit after the flip,
      // and its conn bit checked there if on the boundary (marked stale
      // off it), all against A with v flipped, before anything is written.
      int u[2];
      uint32_t old_bits[2] = {0u, 0u}, new_bits[2] = {0u, 0u};  // Bd, Cn,
                                                            // A, Y: bits 0-3
      uint32_t flip[2] = {0u, 0u};  // wide: the slots of x's mask v toggles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        int x = v;
        if (i > 0 && i <= K)
          x = a.patch ? int(ld<kStaged>(tab.pn + (size_t)v * tab.pp + i - 1))
                      : int(ld<kStaged>(tab.nbr + (size_t)v * D + i - 1));
        const bool live = i == 0 || (i <= K && x != v);
        u[h] = live ? x : -1;
        if (!live) continue;
        const uint32_t bd = bit_at(Bd, x), cn = bit_at(Cn, x),
                       av = bit_at(A, x), st = bit_at(Y, x);
        const bool bd_new = i == 0 ? n_new > 0
                            : i <= dv ? (h ? bd_31 : bd_up)
                                      : bool(bd);
        if (kWide && a.patch)
          flip[h] = i == 0 ? ld<kStaged>(tab.slots + v)
                           : 1u << ld<kStaged>(tab.rev + (size_t)v * tab.pp +
                                                i - 1);
        bool cn_new = cn;
        if (a.patch && bd_new) cn_new = check(x, v, flip[h]);
        old_bits[h] = bd | cn << 1 | av << 2 | st << 3;
        new_bits[h] = uint32_t(bd_new) | uint32_t(cn_new) << 1 |
                      (av ^ uint32_t(x == v)) << 2 |
                      uint32_t(a.patch && !bd_new) << 3;
      }
      // the parity run at the last flip closes: district before this flip
      const uint32_t b_prev = cur_flip >= 0 ? bit_at(A, cur_flip) : 0u;
      // the boundary count, tallies and wait after the move, issued ahead
      // of the commit's shared-memory updates, which do not wait on them
      int b_delta = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (u[h] >= 0)
          b_delta += int(new_bits[h] & 1u) - int(old_bits[h] & 1u);
      b_count += __reduce_add_sync(kFull, b_delta);
      const int popv = unit ? a.unit_pop : __ldg(a.pop + v);
      dp0 += d_from == 0u ? -popv : popv;
      dp1 += d_from == 0u ? popv : -popv;
      cut_count += dcut;
      if (a.geom_waits) {
        const float pr = static_cast<float>(b_count) / denom;
        cur_wait = fmaxf(floorf(log_wait / log1pf(-pr)), 0.f);
      }
      __syncwarp();
      // the commit: A, Bd, Cn, Y and the group counts at the touched nodes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = u[h];
        if (x < 0) continue;
        const uint32_t o = old_bits[h], w = new_bits[h], diff = o ^ w;
        if (diff & 1u) put_bit(Bd, x, w & 1u);
        if (diff & 2u) put_bit(Cn, x, w & 2u);
        if (diff & 8u) put_bit(Y, x, w & 8u);
        if (kWide) M[x] ^= flip[h];  // the nodes differ: no two lanes meet
        const uint32_t c_old = o & (o >> 1) & 1u, c_new = w & (w >> 1) & 1u;
        const int j = x >> kGroupShift;
        if (c_old && (!c_new || (diff & 4u)))
          atomicSub(G + ((o >> 2) & 1u) * ng + j, 1);
        if (c_new && (!c_old || (diff & 4u)))
          atomicAdd(G + ((w >> 2) & 1u) * ng + j, 1);
      }
      if (lane == 0) {
        A[v >> 5] ^= 1u << (v & 31);
        if (a.parity && cur_flip >= 0 && t > run_start)
          close_run(cur_flip, b_prev, t);
      }
      cur_flip = v;
      run_start = t;
      fresh = false;
      if (first_accept == T) first_accept = t;
      __syncwarp();
    }
    move_clock += accept;
    acc_cnt += accept;
    tries += 1;
    exh_cnt += !valid;

    // ---- 4. the record ---------------------------------------------------
    if (!kFold || a.fold.keep_rows) {  // rows only the fold reads: a history
      const size_t row = (size_t)t * C + c;
      if (lane == 0) a.h_cut[row] = cut_count;
      if (lane == 1) a.h_b[row] = b_count;
      if (lane == 2) a.h_wait[row] = cur_wait;
      if (lane == 3) a.h_acc[row] = acc_cnt;
      if (lane == 4 && a.lazy) a.h_weight[row] = 1.0f + cur_wait;
      if constexpr (kIface) {
        if (lane == 5) a.h_slope[row] = slope;
        if (lane == 6) a.h_angle[row] = angle;
      }
    }
    waits_sum += cur_wait;
    if constexpr (kFold) {
      // the fold's packet: the record's rows as floats, as fold_block
      // converts them (selects, not a switch: no branch in the step; row
      // 4, the weight, exists under lazy_uniform, rows 5 and 6, slope and
      // angle, under kIface)
      auto rowf = [&](int r) -> float {
        const float fi = __int2float_rn(
            r == 0 ? cut_count : r == 1 ? b_count : acc_cnt);
        const float fl =
            r == 2 ? cur_wait : r == 4 ? __fadd_rn(1.0f, cur_wait) : fi;
        if constexpr (kIface) return r == 5 ? slope : r == 6 ? angle : fl;
        return fl;
      };
      const FoldArgs& f = a.fold;
      const float4 p = make_float4(rowf(f.obs), cur_wait,
                                   f.src0 >= 0 ? rowf(f.src0) : 0.f,
                                   f.src1 >= 0 ? rowf(f.src1) : 0.f);
      if (lane == slot) pk_mine = p;
      if (slot == 31 || t == T - 1) {  // the batch's records to the fold
        if constexpr (kWide) fpk = fold_ring_acquire(fring, t >> 5);
        if (lane <= slot) fpk[lane] = pk_mine;
        if constexpr (kWide)
          fold_ring_publish(fring, t >> 5);
        else
          fold_inline_batch(f, fst, fpk, slot + 1, c);
      }
    }
  }
  if constexpr (kFold) {
    if constexpr (!kWide) fold_state_finish(a.fold, fst, c);
    // the last record follows the last transition: its accepts are these
    if (lane == 0) a.fold.accepts[c] = acc_cnt;
  }

  // ---- chunk end: the last parity run, then each run node's first-run and
  // last-run terms ---------------------------------------------------------
  if (a.parity) {
    if (lane == 0 && cur_flip >= 0) close_run(cur_flip, bit_at(A, cur_flip), T);
    __syncwarp();
    for (int k = lane; k < nw; k += 32) {
      uint32_t rest = R[k];
      while (rest) {
        const int x = 32 * k + __ffs(rest) - 1;
        rest &= rest - 1u;
        const size_t at = bn + x;
        // the first run's district: x's own before its first flip if the
        // chunk began inside x's run, else the other one
        const uint32_t a_in = a.assign_in[at] == 1;
        const uint32_t b1 =
            (x == flip_in && first_accept > 0) ? a_in : 1u - a_in;
        const int e_last = __ldcg(a.last_flipped_out + at);
        atomicAdd(a.part_sum_out + at, label(b1) * a.last_flipped_in[at] -
                                           label(1u - bit_at(A, x)) * e_last);
      }
    }
  }
  // ---- chunk end: the stale conn bits; assignment, conn bits, cut and
  // cut_deg from A ------------------------------------------------------
  if (a.patch) refresh_stale(Y);
#pragma unroll 4
  for (int i = lane; i < n; i += 32) {
    const uint32_t ai = bit_at(A, i);
    const uint16_t* row = tab.nbr + (size_t)i * D;
    int cd = 0;
    for (int r = 0; r < D; ++r) cd += bit_at(A, ld<kStaged>(row + r)) != ai;
    a.assign_out[bn + i] = static_cast<int8_t>(ai);
    a.cut_deg_out[bn + i] = static_cast<int8_t>(cd);
  }
  for (int k = lane; k < nw; k += 32)
    a.conn_out[(size_t)c * nw + k] = static_cast<int32_t>(Cn[k]);
#pragma unroll 4
  for (int i = lane; i < E; i += 32) {
    const int2 ends = __ldg(reinterpret_cast<const int2*>(a.edges) + i);
    a.cut_out[be + i] =
        static_cast<int8_t>(bit_at(A, ends.x) != bit_at(A, ends.y));
  }
  if (lane == 0) {
    if (!kWide) {
      a.key_out[c] = static_cast<int32_t>(key0);
      a.key_out[C + c] = static_cast<int32_t>(key1);
    }
    a.dist_pop_out[c] = dp0;
    a.dist_pop_out[C + c] = dp1;
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[8] = {cut_count, b_count,  cur_flip, t_yield + T,
                         move_clock, acc_cnt, tries,    exh_cnt};
#pragma unroll
    for (int j = 0; j < 8; ++j) a.ints_out[j * C + c] = ints[j];
  }
}

// The launch shape of (n, d, p, n_chains): the wide form (one chain a
// block with its producer warp and member masks, patch rows of up to
// kWidePp slots in registers: hex and tri, P = 18) while the chains fit on
// the SMs, the masks in shared memory and the rows in kWidePp slots, else
// up to kMaxChainsPerBlock chains a block (any P up to 32); the tables
// staged when they fit beside the block's chains.
struct Shape {
  int staged, cpb, wide, chain_bytes, threads, blocks;
  size_t smem;
};

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// A fold launch (kFold) adds a fold warp and its ring to the wide form,
// a chain's fold area to the narrow one.
// The interface's wall bitset (nww words) adds to a chain's bytes.
Shape launch_shape(int n, int d, int p, int n_chains, bool fold = false,
                   int nww = 0) {
  Shape s;
  const int nw = (n + 31) >> 5, ng = (nw + 31) >> 5;
  s.chain_bytes = ((4 * (kPlanes * nw + 2 * ng + nww)) + 15) & ~15;
  const int sms = sm_count();
  const size_t wide_chain = ((size_t(s.chain_bytes) + 4 * size_t(n)) + 15) &
                            ~size_t(15);
  const size_t fring = fold ? kFoldRingBytes : 0;
  const bool wide = n_chains <= sms && table_layout(n, d, p).pp <= kWidePp &&
                    16 + ((sizeof(Ring) + 15) & ~size_t(15)) + fring +
                            wide_chain <=
                        kSmemLimit;
  s.wide = wide;
  if (wide) s.chain_bytes = int(wide_chain);
  else if (fold) s.chain_bytes += int(kFoldChainBytes);
  s.cpb = wide ? 1 : std::min(kMaxChainsPerBlock, (n_chains + sms - 1) / sms);
  const size_t ring = wide ? ((sizeof(Ring) + 15) & ~size_t(15)) + fring : 0;
  // as many chains as fit (a 65536-node chain takes 33 KB)
  s.cpb = std::max(1, std::min<int>(s.cpb, (kSmemLimit - 16 - ring) /
                                               size_t(s.chain_bytes)));
  s.threads = 32 * (wide ? (fold ? 3 : 2) : s.cpb);
  s.blocks = (n_chains + s.cpb - 1) / s.cpb;
  const size_t base = 16 + ring + size_t(s.cpb) * s.chain_bytes;
  const size_t tables = table_layout(n, d, p).bytes;
  s.staged = base + tables <= kSmemLimit;
  s.smem = base + (s.staged ? tables : 0);
  return s;
}

template <bool kStaged, bool kWide, bool kFold, bool kIface>
int launch(const Args& a, const Shape& s, cudaStream_t stream) {
  auto kern = general_dense_kernel<kStaged, kWide, kFold, kIface>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(s.smem));
  if (err != cudaSuccess) return int(err);
  kern<<<s.blocks, s.threads, s.smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool kStaged, bool kWide, bool kFold, bool kIface>
int occupancy(const Shape& s) {
  auto kern = general_dense_kernel<kStaged, kWide, kFold, kIface>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(s.smem)) != cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, s.threads,
                                                    s.smem) != cudaSuccess)
    return -1;
  return blocks;
}

// the row fields are copied 16 bytes a lane from 16-byte boundaries
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool shape_ok(int n_chains, int n, int e, int d, int p, int t_inner,
              const Shape& s) {
  return n_chains >= 1 && n >= 2 && n <= (1 << 16) && e >= 1 && d >= 1 &&
         d <= 32 && p >= 1 && p <= 32 && t_inner >= 1 && s.smem <= kSmemLimit;
}

template <bool kFold, bool kIface>
int run(Args& a, cudaStream_t st) {
  const Shape s = launch_shape(a.n, a.d, a.p, a.n_chains, kFold, a.nww);
  if (!shape_ok(a.n_chains, a.n, a.e, a.d, a.p, a.t_inner, s) ||
      !aligned16(a.tables) || !aligned16(a.cut_in) ||
      !aligned16(a.part_sum_in) || !aligned16(a.last_flipped_in) ||
      !aligned16(a.num_flips_in) || !aligned16(a.cut_times_in) ||
      !aligned16(a.part_sum_out) || !aligned16(a.last_flipped_out) ||
      !aligned16(a.num_flips_out) || !aligned16(a.cut_times_out))
    return int(cudaErrorInvalidValue);
  a.cpb = s.cpb;
  a.chain_bytes = s.chain_bytes;
  if (s.staged)
    return s.wide ? launch<true, true, kFold, kIface>(a, s, st)
                  : launch<true, false, kFold, kIface>(a, s, st);
  return s.wide ? launch<false, true, kFold, kIface>(a, s, st)
                : launch<false, false, kFold, kIface>(a, s, st);
}

template <bool kFold, bool kIface>
int shape_occupancy(const Shape& s) {
  return s.staged ? (s.wide ? occupancy<true, true, kFold, kIface>(s)
                            : occupancy<true, false, kFold, kIface>(s))
                  : (s.wide ? occupancy<false, true, kFold, kIface>(s)
                            : occupancy<false, false, kFold, kIface>(s));
}

}  // namespace

extern "C" {

// The launch shape of a chunk (fold != 0: of its fold instantiation;
// n_wall > 0: of its interface instantiation over that many wall edges):
// out[0] 1 if the tables are staged in shared memory (0: read through
// L1), out[1] the shared memory of a block in bytes, out[2] chains a
// block, out[3] 1 in the wide form (a producer warp a chain), out[4]
// resident blocks an SM (cudaOccupancy...), out[5] threads a block.
// Returns a cudaError_t.
int fce_general_dense_shape(int n_chains, int n, int e, int d, int p,
                            int fold, int n_wall, int* out) {
  const int nww = (n_wall + 31) >> 5;
  if (nww > 32) return int(cudaErrorInvalidValue);
  const Shape s = launch_shape(n, d, p, n_chains, fold != 0, nww);
  if (!shape_ok(n_chains, n, e, d, p, 1, s)) return int(cudaErrorInvalidValue);
  out[0] = s.staged;
  out[1] = int(s.smem);
  out[2] = s.cpb;
  out[3] = s.wide;
  out[4] = fold ? (nww ? shape_occupancy<true, true>(s)
                       : shape_occupancy<true, false>(s))
                : (nww ? shape_occupancy<false, true>(s)
                       : shape_occupancy<false, false>(s));
  out[5] = s.threads;
  return out[4] < 0 ? int(cudaErrorInvalidValue) : 0;
}

// One chunk for every chain; returns a cudaError_t (0 on success). With
// fold_ptrs (not null) the chunk also folds its records into the summary
// accumulator (summary_fold.cuh's fold_args: 14 pointers, 6 ints), and
// the rows that keep_rows leaves unwritten may be null. With n_wall > 0
// (at most 1024 wall edges) it records the interface metrics into
// h_slope and h_angle.
int fce_general_dense_chunk(
    const uint8_t* tables, const int32_t* edges, const int32_t* pop,
    const int32_t* key_in, const int8_t* assign_in, const int8_t* cut_in,
    const int8_t* cut_deg_in, const int32_t* dist_pop_in,
    const int32_t* conn_in, const float* scal_in, const int32_t* ints_in,
    const int32_t* part_sum_in, const int32_t* last_flipped_in,
    const int32_t* num_flips_in, const int32_t* cut_times_in,
    int32_t* key_out, int8_t* assign_out, int8_t* cut_out,
    int8_t* cut_deg_out, int32_t* dist_pop_out, int32_t* conn_out,
    float* scal_out, int32_t* ints_out, int32_t* part_sum_out,
    int32_t* last_flipped_out, int32_t* num_flips_out,
    int32_t* cut_times_out, int32_t* h_cut, int32_t* h_b, float* h_wait,
    int32_t* h_acc, float* h_weight, int n_chains, int n, int e, int d,
    int p, int t_inner, int patch, int geom_waits, int nobacktrack, int lazy,
    int parity, int fill_conn, int unit_pop, int label0, int label1,
    void* const* fold_ptrs, const int* fold_ints, const int32_t* wall_rank,
    const int32_t* wall_edges, const float* wall_mid, float* h_slope,
    float* h_angle, int n_wall, float cx, float cy, void* stream) {
  Args a;
  a.tables = tables; a.edges = edges; a.pop = pop;
  a.key_in = key_in; a.assign_in = assign_in; a.cut_in = cut_in;
  a.cut_deg_in = cut_deg_in; a.dist_pop_in = dist_pop_in;
  a.conn_in = conn_in; a.scal_in = scal_in; a.ints_in = ints_in;
  a.part_sum_in = part_sum_in; a.last_flipped_in = last_flipped_in;
  a.num_flips_in = num_flips_in; a.cut_times_in = cut_times_in;
  a.key_out = key_out; a.assign_out = assign_out; a.cut_out = cut_out;
  a.cut_deg_out = cut_deg_out; a.dist_pop_out = dist_pop_out;
  a.conn_out = conn_out; a.scal_out = scal_out; a.ints_out = ints_out;
  a.part_sum_out = part_sum_out; a.last_flipped_out = last_flipped_out;
  a.num_flips_out = num_flips_out; a.cut_times_out = cut_times_out;
  a.h_cut = h_cut; a.h_b = h_b; a.h_wait = h_wait; a.h_acc = h_acc;
  a.h_weight = h_weight;
  a.n_chains = n_chains; a.n = n; a.e = e; a.d = d; a.p = p;
  a.t_inner = t_inner; a.patch = patch; a.geom_waits = geom_waits;
  a.nobacktrack = nobacktrack; a.lazy = lazy; a.parity = parity;
  a.fill_conn = fill_conn;
  a.unit_pop = unit_pop; a.label0 = label0; a.label1 = label1;
  a.cpb = 0; a.chain_bytes = 0;
  a.wall_rank = wall_rank; a.wall_edges = wall_edges;
  a.wall_mid = reinterpret_cast<const float2*>(wall_mid);
  a.h_slope = h_slope; a.h_angle = h_angle;
  a.n_wall = n_wall; a.nww = (n_wall + 31) >> 5; a.cx = cx; a.cy = cy;
  if (a.nww > 32) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool iface = n_wall > 0;
  if (fold_ptrs == nullptr) {
    a.fold = FoldArgs{};
    return iface ? run<false, true>(a, st) : run<false, false>(a, st);
  }
  a.fold = fold_args(fold_ptrs, fold_ints);
  return iface ? run<true, true>(a, st) : run<true, false>(a, st);
}

}  // extern "C"
