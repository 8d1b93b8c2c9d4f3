// General pair chunk kernel: t_inner steps of the rejection-free k-district
// pair walk on an arbitrary sparse graph (the precinct dual graphs, the hex
// lattice, and any graph whose radius-r patches fit 32 slots), one warp per
// chain, the chunk loop inside the kernel.
//
// Replaces the JAX package's general_dense step under proposal 'pair',
// flipcomplexityempirical_tpu/kernel/dense.py::transition (:303:
// propose_dense's pair branch :257, the shared commit of kernel/step.py:407
// with the distinct-pair count :430 and the boundary-length score :449,
// refresh_conn_bits :186) followed by kernel/step.py::record (:519). On the
// TPU that step is XLA code under a scan; replayed as torch ops (the plain
// version, kernel/cuda_pair.py::general_pair_chunk_reference) it is hundreds
// of small launches a step. Here one launch runs the chunk. It is bit-equal
// to its plain version on every output and draws the JAX package's
// threefry stream: split(key, 4) per step into (key, proposal, accept,
// wait), as dense.py:313 does.
//
// What bounds it on the H100. A chain's steps are serial. At the bench's
// shape (hex 64x64, k = 4, C=4096) many chains share an SM, so the work a
// step issues and the chains an SM holds set the pace; at the dual sweep's
// C=8 one warp's latency through a step does. Neither bytes (the state is
// read and written once) nor operations come near their bounds. So a step
// does no pass over the nodes and keeps its serial path short:
//   - per chain in shared memory, a cell a node: its neighbouring
//     districts NB (bit d: a neighbour lies in district d), its district
//     A, its conn bit (the state's conn_bits) and a stale bit, a byte at
//     k <= 4 (8448 nodes: 8.8 KB a chain) and 16 bits at k <= 8; the
//     count of valid (node, district) pairs of each word of 32 nodes (a
//     byte) and of each group of 32 words (1024 nodes); under a population
//     that varies by node, each node's valid set (a byte); the k tallies in
//     every lane's registers. A conn bit is kept only where the node has
//     another district among its neighbours (elsewhere it has no valid
//     pair): off every boundary it is marked stale and checked when the
//     node joins one, always as a node a move touches, or at the chunk's
//     end;
//   - the graph's tables (patch slots and adjacency bitsets, neighbour
//     slots and edges, degrees) and the populations and boundary lengths
//     are staged into shared memory once a block, the tables by a bulk
//     asynchronous copy on an mbarrier, where they fit beside the block's
//     chains (the dual's 144 nodes), and read through L1 otherwise (hex
//     64x64: 1.6 MB);
//   - at C <= the SM count one chain a block with a second warp that runs
//     the threefry key chain and the step's uniforms 32 steps a batch,
//     ahead of the chain, into a ring handed over on mbarriers
//     (chain_common.cuh::produce_draws); at larger C up to 8 chains a
//     block, each warp drawing its own batches (draw_batch), two blocks an
//     SM at 128 registers a thread (hex 64x64: 16 chains an SM, C=4096 in
//     two waves; three blocks at 80 registers spilled and ran slower).
// Per step and chain:
//   1. the step's draws from the batch (lane i holds step 32 q + i's);
//   2. the m-th valid pair in node-major order (pair index node * k +
//      district), m = min(int(u * total), max(total - 1, 0)), in three warp
//      rounds: the group from a warp prefix of the group counts, the word
//      from the prefix of the group's word counts (one ballot a bit of the
//      counts), the node from the prefix of the word's 32 valid-set
//      popcounts, then the district by nth_bit. A node's valid set is
//      NB & ~{A} under its conn bit and the f32 population gates
//      (dense.py::_pop_planes): under a uniform population two masks of
//      districts, fmask (may lose a node) and tmask (may gain one), under
//      one that varies by node a test of the node's population against each
//      tally. All of it but m depends on the state only, so a rejected step
//      reuses the group prefix and the last group's and word's rounds. With
//      no valid pair node 0, district 0 and nothing committed (the JAX
//      body's self-loop);
//   3. accept by the literal bound -beta * score * log_base against
//      log(max(u, 1e-12)), the score the cut change or, under weighted_cut,
//      the f32 sum of delta * edge_len over v's D neighbour slots in slot
//      order (lane s holds slot s; the shuffles of 8 slots issue together,
//      the adds stay in order). On an accepted move, lane i takes v (i = 0)
//      or its patch slot i - 1 (its neighbour slot i - 1 without
//      contiguity; pads left out; a patch starts with the neighbours in
//      neighbour-slot order): the node's cell after the move (A at v, NB
//      at v's neighbours, the conn bit by the kernel/contiguity.py::
//      patch_connected check where the node ends on a boundary, else the
//      stale bit), all against A with v moved, before anything is
//      written; the pair count b_count by the change of the rows
//      popc(NB & ~{A}); the tallies, the masks and the wait. Under a uniform
//      population whose masks did not change, each touched node adds the
//      change of its valid set's popcount to its word's and group's counts
//      (shared atomics; the word counts are bytes added as 32-bit words,
//      exact mod 2**32); a change of a mask, or any move under a population
//      that varies by node, recounts every node's valid set and the counts
//      at the next step (the only passes over the nodes);
//   4. the (T, C) rows cut_count, b_count, wait, accepts and weight (1 +
//      wait, under lazy_uniform).
// cut_times starts from cut_times + cut * T and each accepted move adds
// delta * (T - t) to v's edges, fire-and-forget (the change at step t is
// seen by T - t yields). The parity quirk (step.py:538-551) runs at
// cur_flip_node on lane 0 in registers and reaches memory when that node
// changes. cut and cut_deg are written at the chunk's end from A.
//
// Traps the code keeps:
//   - the wait denominator is N**k - 1 in f32 (double then rounded, as
//     Python computes it; the wrapper passes it);
//   - the population tests are f32 subtractions and additions of the
//     tallies and pop[i], compared with pop_lo / pop_hi;
//   - patch pad slots hold the node itself and are never members; a
//     neighbour row's pads hold the node itself and are not neighbours;
//   - float steps in the JAX order, built with -fmad=false.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace {

using namespace fce;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxK = 8;
constexpr int kMaxChainsPerBlock = 8;
constexpr int kBlocksPerSm = 2;   // the many-chain form's launch bound
constexpr int kGroupShift = 10;   // 32 words, 1024 nodes, a count group
constexpr size_t kSmemLimit = 227 * 1024;

// The tables this kernel reads of kernel/cuda_dense.py::pack_tables
// (chain_common.cuh::table_layout), and the populations and boundary
// lengths; staged or in global memory.
struct Tables {
  const uint32_t* padj;
  const uint16_t* pn;
  const uint32_t* nedge;
  const uint16_t* nbr;
  const uint8_t* deg;
  const int32_t* pop;
  const float* elen;
  int pp;
};

// A node's cell: NB in bits [0, kA), A in the kAw bits from kA, then the
// stale bit (the conn bit not kept, as a node off every boundary needs
// none), the conn bit last. Cell = uint8_t holds k <= 4 districts (NB 0-3,
// A 4-5, stale 6, conn 7), uint16_t k <= 8 (NB 0-7, A 8-10, stale 11,
// conn 15).
template <typename Cell>
struct Fmt {
  static constexpr int kA = sizeof(Cell) == 1 ? 4 : 8;
  static constexpr int kAw = sizeof(Cell) == 1 ? 2 : 3;
  static constexpr int kStale = kA + kAw;
  static constexpr int kConn = 8 * sizeof(Cell) - 1;
  __device__ static uint32_t nb(uint32_t c) { return c & ((1u << kA) - 1u); }
  __device__ static uint32_t a(uint32_t c) {
    return (c >> kA) & ((1u << kAw) - 1u);
  }
  __device__ static uint32_t stale(uint32_t c) { return (c >> kStale) & 1u; }
  __device__ static uint32_t conn(uint32_t c) { return (c >> kConn) & 1u; }
  // a node's other districts among its neighbours: its pair-plane row
  __device__ static uint32_t row(uint32_t c) { return nb(c) & ~(1u << a(c)); }
  __device__ static uint32_t make(uint32_t nb, uint32_t a, uint32_t stale,
                                  uint32_t conn) {
    return nb | a << kA | stale << kStale | conn << kConn;
  }
};

// A chain's shared memory: the group counts (ng ints, rounded to 4), the
// word counts (nw bytes, rounded to 16), the cells, and under a population
// that varies by node each node's valid set (n bytes); byte offsets and
// the total.
struct ChainLayout {
  size_t wc, cells, vs, bytes;
};

__host__ __device__ inline ChainLayout chain_layout(int n, int cell,
                                                    bool varies) {
  const size_t nw = (size_t(n) + 31) >> 5, ng = (nw + 31) >> 5;
  ChainLayout l;
  l.wc = 4 * ((ng + 3) & ~size_t(3));
  l.cells = l.wc + ((nw + 15) & ~size_t(15));
  l.vs = l.cells + ((size_t(n) * cell + 15) & ~size_t(15));
  l.bytes = l.vs + (varies ? (size_t(n) + 15) & ~size_t(15) : 0);
  return l;
}

// The staged block: the tables, then pop (N) and edge_len (E), each from a
// 16-byte boundary.
__host__ __device__ inline size_t staged_bytes(const TableLayout& l, int n,
                                               int e) {
  return l.bytes + ((4 * size_t(n) + 15) & ~size_t(15)) +
         ((4 * size_t(e) + 15) & ~size_t(15));
}

struct Args {
  const uint8_t* tables;        // pack_tables, 16-byte aligned
  const int32_t* edges;         // (E, 2) edge ends
  const int32_t* pop;           // (N,)
  const float* edge_len;        // (E,)
  const int32_t* labels;        // (K,) district -> part_sum label
  // per chain in
  const int32_t* key_in;        // (2, C) uint32 key words
  const int8_t* assign_in;      // (C, N)
  const int8_t* cut_in;         // (C, E)
  const int32_t* dist_pop_in;   // (K, C)
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
  int32_t* dist_pop_out;        // (K, C)
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
  int32_t* recounts;            // (C,) full recounts after moves, or null
  int n_chains, n, e, d, p, k, t_inner;
  int patch, geom_waits, lazy, parity, weighted, fill_conn;
  int unit_pop;                 // > 0: every node's population; 0: varies
  float denom;                  // n**k - 1 in f32
  int cpb;                      // chains a block
};

// the districts among node x's neighbours against A with v in district
// d_to (v = -1: A), a bit each; the row's pads (x itself) left out
template <bool kStaged, typename Cell>
__device__ __forceinline__ uint32_t nbr_set(const Tables& tab, const Cell* S,
                                            int x, int D, int v,
                                            uint32_t d_to) {
  using F = Fmt<Cell>;
  const int dx = ld<kStaged>(tab.deg + x);
  const uint16_t* row = tab.nbr + size_t(x) * D;
  uint32_t s = 0u;
#pragma unroll
  for (int r = 0; r < 8; ++r) {  // the loads issue together
    if (r < D) {
      const int y = ld<kStaged>(row + r);
      const uint32_t ay = y == v ? d_to : F::a(S[y]);
      s |= uint32_t(r < dx) << ay;
    }
  }
  for (int r = 8; r < dx; ++r) {
    const int y = ld<kStaged>(row + r);
    s |= 1u << (y == v ? d_to : F::a(S[y]));
  }
  return s;
}

// kernel/contiguity.py::patch_connected of node u against A with v in
// district d_to (v = -1: A; the checks of a move run before its commit):
// the same-district members of u's patch (pads and u left out), seeds =
// members among the first deg(u) slots (u's neighbours), reach grown from
// the lowest seed over the members' slot adjacency until every seed is
// reached (true) or nothing new is (false). The member slots in one loop
// bounded by the warp's P, six loads at a time: the lanes' checks run
// together (a loop over each lane's own neighbours first, for an early
// answer, diverged and ran slower).
template <bool kStaged, typename Cell>
__device__ __forceinline__ bool patch_connected(const Tables& tab,
                                                const Cell* S, int u, int v,
                                                uint32_t d_to, int P) {
  using F = Fmt<Cell>;
  const int du = ld<kStaged>(tab.deg + u);
  const uint32_t au = u == v ? d_to : F::a(S[u]);
  const uint16_t* pn = tab.pn + size_t(u) * tab.pp;
  auto same = [&](int s) {
    const int x = ld<kStaged>(pn + s);
    const uint32_t ax = x == v ? d_to : F::a(S[x]);
    return uint32_t(ax == au && x != u) << s;
  };
  uint32_t member = 0u;
#pragma unroll 6
  for (int s = 0; s < P; ++s) member |= same(s);
  const uint32_t seeds = member & (du >= 32 ? kFull : ((1u << du) - 1u));
  if ((seeds & (seeds - 1u)) == 0u) return true;  // at most one seed
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

// kStaged: the tables, populations and boundary lengths in shared memory.
// kProd: one chain a block with its draws warp (C up to the SM count);
// else up to kMaxChainsPerBlock chains a block, kBlocksPerSm blocks an SM
// (128 registers a thread: at three blocks, 80, the step spilled to local
// memory and ran slower). Cell: the cell's width (k <= 4: a byte).
template <bool kStaged, bool kProd, typename Cell>
__global__ void __launch_bounds__(kProd ? 64 : 32 * kMaxChainsPerBlock,
                                  kProd ? 1 : kBlocksPerSm)
    general_pair_kernel(const Args a) {
  using F = Fmt<Cell>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, E = a.e, D = a.d, P = a.p, K = a.k, C = a.n_chains,
            T = a.t_inner;
  const int nw = (n + 31) >> 5, ng = (nw + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TableLayout lay = table_layout(n, D, P);
  // shared memory: [table barrier | tables, pop, edge_len if staged |
  //                 ring if producer | the block's chains]
  uint64_t* tbar = reinterpret_cast<uint64_t*>(smem);
  size_t off = 16;
  const unsigned char* tbase = a.tables;
  Tables tab;
  tab.pop = a.pop;
  tab.elen = a.edge_len;
  if constexpr (kStaged) {
    tbase = smem + off;
    int32_t* sp = reinterpret_cast<int32_t*>(smem + off + lay.bytes);
    float* se = reinterpret_cast<float*>(
        smem + off + lay.bytes + ((4 * size_t(n) + 15) & ~size_t(15)));
    for (int i = threadIdx.x; i < n; i += blockDim.x) sp[i] = a.pop[i];
    for (int i = threadIdx.x; i < E; i += blockDim.x) se[i] = a.edge_len[i];
    tab.pop = sp;
    tab.elen = se;
    off += staged_bytes(lay, n, E);
  }
  Ring* ring = reinterpret_cast<Ring*>(smem + off);
  if constexpr (kProd) off += (sizeof(Ring) + 15) & ~size_t(15);
  if (threadIdx.x == 0) {
    if constexpr (kStaged) mbar_init(tbar, 1);
    if constexpr (kProd)
      for (int s = 0; s < kRing; ++s) {
        mbar_init(&ring->full[s], 32);
        mbar_init(&ring->empty[s], 32);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (kStaged) {
    if (threadIdx.x == 0)
      bulk_load(smem + 16, a.tables, static_cast<uint32_t>(lay.bytes), tbar);
  }
  if (kProd && warp == 1) {  // no block barrier below
    produce_draws(a.key_in, a.key_out, C, T, ring, blockIdx.x);
    return;
  }
  const int c = blockIdx.x * a.cpb + warp;
  if (c >= C) return;  // no block barrier below
  tab.padj = reinterpret_cast<const uint32_t*>(tbase + lay.padj);
  tab.pn = reinterpret_cast<const uint16_t*>(tbase + lay.pn);
  tab.nedge = reinterpret_cast<const uint32_t*>(tbase + lay.nedge);
  tab.nbr = reinterpret_cast<const uint16_t*>(tbase + lay.nbr);
  tab.deg = tbase + lay.deg;
  tab.pp = lay.pp;
  const bool unit = a.unit_pop > 0;
  const ChainLayout cl = chain_layout(n, sizeof(Cell), !unit);
  unsigned char* base = smem + off + size_t(warp) * cl.bytes;
  int* G = reinterpret_cast<int*>(base);
  uint8_t* WC = base + cl.wc;
  Cell* S = reinterpret_cast<Cell*>(base + cl.cells);
  uint8_t* VS = base + cl.vs;  // a varying population only
  const size_t bn = size_t(c) * n, be = size_t(c) * E;

  // ---- the chain in ------------------------------------------------------
  copy_rows(a.part_sum_in, a.last_flipped_in, a.num_flips_in, a.cut_times_in,
            a.cut_in, a.part_sum_out, a.last_flipped_out, a.num_flips_out,
            a.cut_times_out, bn, be, n, E, T);
  for (int i = lane; i < n; i += 32) {
    const uint32_t cn =
        a.fill_conn ? 0u
                    : (uint32_t(a.conn_in[size_t(c) * nw + (i >> 5)]) >>
                       (i & 31)) & 1u;
    S[i] = static_cast<Cell>(
        F::make(0u, static_cast<uint32_t>(a.assign_in[bn + i]), 0u, cn));
  }
  if constexpr (kStaged) mbar_wait(tbar, 0);
  __syncwarp();
  // the patch check of node x against A with v moved to d_to (v = -1: A)
  auto connected = [&](int x, int v, uint32_t d_to) {
    return patch_connected<kStaged>(tab, S, x, v, d_to, P);
  };
  // NB, then (a run's first chunk) the conn bits, each lane its own nodes'
  // cells; the other lanes read only the A bits, which stay as they are
  for (int i = lane; i < n; i += 32)
    S[i] |= static_cast<Cell>(nbr_set<kStaged>(tab, S, i, D, -1, 0u));
  __syncwarp();
  if (a.fill_conn) {  // dense.py::conn_plane: each node on a boundary
                      // checked, the others stale; all set without
                      // contiguity
    for (int i = lane; i < n; i += 32) {
      const uint32_t ci = S[i];
      if (!a.patch)
        S[i] = static_cast<Cell>(ci | 1u << F::kConn);
      else if (F::row(ci) == 0u)
        S[i] = static_cast<Cell>(ci | 1u << F::kStale);
      else if (connected(i, -1, 0u))
        S[i] = static_cast<Cell>(ci | 1u << F::kConn);
    }
    __syncwarp();
  }

  uint32_t key0 = static_cast<uint32_t>(a.key_in[c]);
  uint32_t key1 = static_cast<uint32_t>(a.key_in[C + c]);
  const float log_base = a.scal_in[c], beta = a.scal_in[C + c];
  const float pop_lo = a.scal_in[2 * C + c], pop_hi = a.scal_in[3 * C + c];
  float cur_wait = a.scal_in[4 * C + c], waits_sum = a.scal_in[5 * C + c];
  int cut_count = a.ints_in[c], b_count = a.ints_in[C + c],
      cur_flip = a.ints_in[2 * C + c];
  const int t_yield = a.ints_in[3 * C + c];
  int move_clock = a.ints_in[4 * C + c], acc_cnt = a.ints_in[5 * C + c],
      tries = a.ints_in[6 * C + c], exh_cnt = a.ints_in[7 * C + c];
  const float unitf = static_cast<float>(a.unit_pop);
  // the k tallies, in every lane (constant indices only: registers)
  int dp[kMaxK];
#pragma unroll
  for (int d = 0; d < kMaxK; ++d) dp[d] = d < K ? a.dist_pop_in[d * C + c] : 0;
  // under a uniform population, bit d of fm: district d may lose a node;
  // of tm: it may gain one
  auto masks = [&](uint32_t& fm, uint32_t& tm) {
    fm = tm = 0u;
#pragma unroll
    for (int d = 0; d < kMaxK; ++d) {
      const float pf = static_cast<float>(dp[d]);
      fm |= uint32_t(d < K && pf - unitf >= pop_lo) << d;
      tm |= uint32_t(d < K && pf + unitf <= pop_hi) << d;
    }
  };
  uint32_t fmask = 0u, tmask = 0u;
  if (unit) masks(fmask, tmask);
  // node i's valid districts: NB & ~{A} under its conn bit and the gates
  // (a stale node has no other district among its neighbours)
  auto vset_unit = [&](uint32_t cell, uint32_t fm, uint32_t tm) {
    const uint32_t ai = F::a(cell);
    const uint32_t cand = F::conn(cell) ? F::row(cell) : 0u;
    return (fm >> ai) & 1u ? cand & tm : 0u;
  };
  auto vset = [&](uint32_t cell, int i) -> uint32_t {
    if (unit) return vset_unit(cell, fmask, tmask);
    // without a branch, so that the recount's words interleave
    const uint32_t ai = F::a(cell);
    const uint32_t cand = F::conn(cell) ? F::row(cell) : 0u;
    const float pf = static_cast<float>(ld<kStaged>(tab.pop + i));
    float from = 0.f;
    uint32_t to = 0u;
#pragma unroll
    for (int d = 0; d < kMaxK; ++d) {
      const float pd = static_cast<float>(dp[d]);
      if (ai == uint32_t(d)) from = pd;
      to |= uint32_t(pd + pf <= pop_hi) << d;
    }
    return from - pf >= pop_lo ? cand & to : 0u;
  };
  // every node's valid set (kept under a varying population): the word
  // and group counts anew, four words' sets at a time before their sums
  auto recount = [&]() {
    int gsum = 0;
    for (int k0 = 0; k0 < nw; k0 += 4) {
      int pc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 32 * (k0 + j) + lane;
        const uint32_t vs = i < n ? vset(S[i], i) : 0u;
        if (!unit && i < n) VS[i] = static_cast<uint8_t>(vs);
        pc[j] = __popc(vs);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + j;
        if (k >= nw) break;
        const int cnt = __reduce_add_sync(kFull, pc[j]);
        gsum += cnt;
        if (lane == 0) {
          WC[k] = static_cast<uint8_t>(cnt);
          if ((k & 31) == 31 || k == nw - 1) G[k >> 5] = gsum;
        }
        if ((k & 31) == 31) gsum = 0;
      }
    }
    __syncwarp();
  };
  recount();

  // lane 0's parity run at cur_flip: its node, last_flipped, and the
  // part_sum and num_flips it has added, not yet stored (added
  // fire-and-forget); the next run's last_flipped and cur_flip's label,
  // loaded when the node is known (the input's cur_flip, then each
  // accepted move's v)
  int rx = -1, run_lf = 0, run_ps = 0, run_nf = 0, lf_next = 0, lab = 0;
  if (a.parity && lane == 0 && cur_flip >= 0) {
    lf_next = a.last_flipped_out[bn + cur_flip];
    lab = __ldg(a.labels + F::a(S[cur_flip]));
  }
  auto flush_run = [&]() {
    if (rx < 0) return;
    atomicAdd(a.part_sum_out + bn + rx, run_ps);
    atomicAdd(a.num_flips_out + bn + rx, run_nf);
    a.last_flipped_out[bn + rx] = run_lf;
  };
  // the selection's cache, refreshed after an accepted move: the group
  // prefix (lane j: groups j and 32 + j), the last group's word round and
  // the last word's node round
  bool fresh = false, need_recount = false;
  int n_recounts = 0, total = 0;
  int g_lo = 0, g_hi = 0, i_lo = 0, i_hi = 0, last_g = -1, last_w = -1;
  int w_cnt = 0, w_below = 0, v_cnt = 0, v_below = 0;
  uint32_t v_set = 0u;
  const uint32_t lt = (1u << lane) - 1u;  // the lanes below this one
  const int Kt = a.patch ? P : D;  // touched slots besides v
  Draws draws{0u, 0u, 0u, 0.f, 0.f};  // lane i: step 32 * q + i's draws

  for (int t = 0; t < T; ++t) {
    // ---- 1. the step's uniforms, 32 steps at a time -------------------
    const int slot = t & 31;
    if (slot == 0) {
      if constexpr (kProd) {
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

    // ---- 2. the counts after a move, and the m-th valid pair -------------
    if (!fresh) {
      if (need_recount) {
        recount();
        ++n_recounts;
        need_recount = false;
      }
      if (ng == 1) {
        total = G[0];
      } else {
        g_lo = lane < ng ? G[lane] : 0;
        i_lo = incl_scan(g_lo, lane);
        total = __shfl_sync(kFull, i_lo, 31);
        if (ng > 32) {
          g_hi = lane + 32 < ng ? G[lane + 32] : 0;
          i_hi = incl_scan(g_hi, lane) + total;
          total = __shfl_sync(kFull, i_hi, 31);
        }
      }
      last_g = last_w = -1;
      fresh = true;
    }
    int m = static_cast<int>(u_prop * static_cast<float>(total));
    m = min(m, max(total - 1, 0));
    int v = 0, d_to = 0;
    if (total > 0) {
      int g = 0, r = m;
      if (ng > 1) {  // the group
        const uint32_t lo = __ballot_sync(kFull, i_lo > m);
        if (lo) {
          g = __ffs(lo) - 1;
          r = m - __shfl_sync(kFull, i_lo - g_lo, g);
        } else {
          const int s = __ffs(__ballot_sync(kFull, i_hi > m)) - 1;
          g = 32 + s;
          r = m - __shfl_sync(kFull, i_hi - g_hi, s);
        }
      }
      if (g != last_g) {  // the group's word counts and their prefix
        const int k = (g << 5) + lane;
        w_cnt = k < nw ? int(WC[k]) : 0;
        w_below = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b)
          w_below += __popc(__ballot_sync(kFull, (w_cnt >> b) & 1) & lt) << b;
        last_g = g;
        last_w = -1;
      }
      const int ws = __ffs(__ballot_sync(kFull, w_below + w_cnt > r)) - 1;
      r -= __shfl_sync(kFull, w_below, ws);
      const int w = (g << 5) + ws;
      if (w != last_w) {  // the word's valid sets and their prefix
        const int i = (w << 5) + lane;
        v_set = i >= n ? 0u : unit ? vset(S[i], i) : uint32_t(VS[i]);
        v_cnt = __popc(v_set);
        v_below = 0;
#pragma unroll
        for (int b = 0; b < 3; ++b)
          v_below += __popc(__ballot_sync(kFull, (v_cnt >> b) & 1) & lt) << b;
        last_w = w;
      }
      const int src = __ffs(__ballot_sync(kFull, v_below + v_cnt > r)) - 1;
      const int rr = r - __shfl_sync(kFull, v_below, src);
      v = (w << 5) + src;
      d_to = nth_bit(__shfl_sync(kFull, v_set, src), rr);
    }

    // ---- 3. accept and commit; lane s < D holds v's slot s -------------
    const bool valid = total > 0;
    const uint32_t d_from = F::a(S[v]);
    const int dv = ld<kStaged>(tab.deg + v);
    const bool msk = lane < dv;
    const int nb =
        lane < D ? int(ld<kStaged>(tab.nbr + size_t(v) * D + lane)) : v;
    const uint32_t na = F::a(S[nb]);
    const bool oc = msk && na != d_from;
    const bool nc = msk && na != uint32_t(d_to);
    const int dcut = __popc(__ballot_sync(kFull, nc)) -
                     __popc(__ballot_sync(kFull, oc));
    const int eid =
        msk ? int(ld<kStaged>(tab.nedge + size_t(v) * D + lane)) : 0;
    float score;
    if (a.weighted) {  // the D slots' terms added in slot order
      const float term =
          msk ? static_cast<float>(int(nc) - int(oc)) *
                    ld<kStaged>(tab.elen + eid)
              : 0.f;
      score = __shfl_sync(kFull, term, 0);
      for (int j0 = 1; j0 < D; j0 += 8) {
        float t8[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          t8[j] = __shfl_sync(kFull, term, (j0 + j) & 31);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j0 + j < D) score += t8[j];
      }
    } else {
      score = static_cast<float>(dcut);
    }
    const float log_bound = -beta * score * log_base;
    const bool accept = valid && (log_acc < log_bound);
    if (accept) {
      // the parity run that v starts: its last_flipped and label, loaded
      // ahead
      if (a.parity && lane == 0) {
        lf_next = a.last_flipped_out[bn + v];
        lab = __ldg(a.labels + d_to);
      }
      // cut_times: v's edges change state now, seen by T - t yields
      if (msk)
        atomicAdd(a.cut_times_out + be + eid, (int(nc) - int(oc)) * (T - t));
      // the touched nodes, slot i = lane (+ 32): each one's cell after the
      // move against A with v moved, before anything is written; its conn
      // bit checked where it has another district among its neighbours,
      // else left stale
      int xs[2];
      uint32_t co[2] = {0u, 0u}, cw[2] = {0u, 0u};
      int rows = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        int x = v;
        if (i > 0 && i <= Kt)
          x = a.patch ? int(ld<kStaged>(tab.pn + size_t(v) * tab.pp + i - 1))
                      : int(ld<kStaged>(tab.nbr + size_t(v) * D + i - 1));
        const bool live = i == 0 || (i <= Kt && x != v);
        xs[h] = live ? x : -1;
        if (!live) continue;
        const uint32_t o = S[x];
        const uint32_t nbx = i >= 1 && i <= dv
                                 ? nbr_set<kStaged>(tab, S, x, D, v,
                                                    uint32_t(d_to))
                                 : F::nb(o);
        const uint32_t ax = x == v ? uint32_t(d_to) : F::a(o);
        const uint32_t rx_new = nbx & ~(1u << ax);
        const bool check = a.patch && rx_new != 0u;
        const uint32_t cx =
            check ? uint32_t(connected(x, v, uint32_t(d_to))) : F::conn(o);
        co[h] = o;
        cw[h] = F::make(nbx, ax, uint32_t(a.patch && !check), cx);
        // the node's row of the (N, K) pair plane, before and after
        rows += __popc(rx_new) - __popc(F::row(o));
      }
      b_count += __reduce_add_sync(kFull, rows);
      const int popv = unit ? a.unit_pop : ld<kStaged>(tab.pop + v);
#pragma unroll
      for (int d = 0; d < kMaxK; ++d)
        dp[d] += (uint32_t(d) == d_from ? -popv : 0) +
                 (d == d_to ? popv : 0);
      cut_count += dcut;
      if (a.geom_waits) {
        const float pr = static_cast<float>(b_count) / a.denom;
        cur_wait = fmaxf(floorf(log_wait / log1pf(-pr)), 0.f);
      }
      // the counts: a uniform population's masks unchanged, each touched
      // node's change; else a recount at the next step
      uint32_t fm = fmask, tm = tmask;
      if (unit) masks(fm, tm);
      need_recount = !unit || fm != fmask || tm != tmask;
      int dc[2] = {0, 0};
      if (!need_recount) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (xs[h] >= 0)
            dc[h] = __popc(vset_unit(cw[h], fm, tm)) -
                    __popc(vset_unit(co[h], fmask, tmask));
      }
      fmask = fm;
      tmask = tm;
      __syncwarp();  // every read of the cells done
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = xs[h];
        if (x < 0) continue;
        S[x] = static_cast<Cell>(cw[h]);
        if (dc[h] != 0) {
          const int k = x >> 5;
          atomicAdd(reinterpret_cast<unsigned int*>(WC) + (k >> 2),
                    static_cast<unsigned int>(dc[h]) << (8 * (k & 3)));
          atomicAdd(G + (x >> kGroupShift), dc[h]);
        }
      }
      cur_flip = v;
      fresh = false;
      __syncwarp();
    }
    move_clock += accept;
    acc_cnt += accept;
    tries += 1;
    exh_cnt += !valid;

    // ---- 4. the record ---------------------------------------------------
    if (a.parity && lane == 0 && cur_flip >= 0) {
      if (rx != cur_flip) {
        flush_run();
        rx = cur_flip;
        run_lf = lf_next;
        run_ps = 0;
        run_nf = 0;
      }
      const int te = t_yield + t;
      run_ps += -lab * (te - run_lf);
      run_lf = te;
      run_nf += 1;
    }
    const size_t row = size_t(t) * C + c;
    if (lane == 0) a.h_cut[row] = cut_count;
    if (lane == 1) a.h_b[row] = b_count;
    if (lane == 2) a.h_wait[row] = cur_wait;
    if (lane == 3) a.h_acc[row] = acc_cnt;
    if (lane == 4 && a.lazy) a.h_weight[row] = 1.0f + cur_wait;
    waits_sum += cur_wait;
  }
  if (lane == 0) flush_run();

  // ---- chunk end: the stale conn bits; assignment, conn bits, cut and
  // cut_deg from A ----------------------------------------------------------
  if (a.patch) {
    for (int i = lane; i < n; i += 32) {
      const uint32_t ci = S[i];
      if (F::stale(ci))
        S[i] = static_cast<Cell>(
            F::make(F::nb(ci), F::a(ci), 0u, connected(i, -1, 0u)));
    }
    __syncwarp();
  }
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    const uint32_t ci = i < n ? uint32_t(S[i]) : 0u;
    const uint32_t w = __ballot_sync(kFull, F::conn(ci));
    if (lane == 0) a.conn_out[size_t(c) * nw + k] = static_cast<int32_t>(w);
    if (i >= n) continue;
    const uint32_t ai = F::a(ci);
    const int di = ld<kStaged>(tab.deg + i);
    const uint16_t* nrow = tab.nbr + size_t(i) * D;
    int cd = 0;
    for (int r = 0; r < di; ++r) cd += F::a(S[ld<kStaged>(nrow + r)]) != ai;
    a.assign_out[bn + i] = static_cast<int8_t>(ai);
    a.cut_deg_out[bn + i] = static_cast<int8_t>(cd);
  }
  for (int i = lane; i < E; i += 32) {
    const int2 ends = __ldg(reinterpret_cast<const int2*>(a.edges) + i);
    a.cut_out[be + i] =
        static_cast<int8_t>(F::a(S[ends.x]) != F::a(S[ends.y]));
  }
  int dp_mine = 0;
#pragma unroll
  for (int d = 0; d < kMaxK; ++d)
    if (lane == d) dp_mine = dp[d];
  if (lane < K) a.dist_pop_out[lane * C + c] = dp_mine;
  if (lane == 0) {
    if constexpr (!kProd) {
      a.key_out[c] = static_cast<int32_t>(key0);
      a.key_out[C + c] = static_cast<int32_t>(key1);
    }
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[8] = {cut_count, b_count,  cur_flip, t_yield + T,
                         move_clock, acc_cnt, tries,    exh_cnt};
#pragma unroll
    for (int j = 0; j < 8; ++j) a.ints_out[j * C + c] = ints[j];
    if (a.recounts != nullptr) a.recounts[c] = n_recounts;
  }
}

// The launch shape of (n, e, d, p, k, a population that varies by node,
// n_chains): one chain a block with
// its draws warp while the chains fit on the SMs, else up to
// kMaxChainsPerBlock chains a block; the tables, populations and boundary
// lengths staged when they fit beside the block's chains.
struct Shape {
  int staged, prod, cpb, threads, blocks, chain_bytes, cell;
  size_t smem;
};

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

Shape launch_shape(int n, int e, int d, int p, int k, bool varies,
                   int n_chains) {
  Shape s;
  s.cell = k <= 4 ? 1 : 2;
  s.chain_bytes = int(chain_layout(n, s.cell, varies).bytes);
  const int sms = sm_count();
  const size_t ring = (sizeof(Ring) + 15) & ~size_t(15);
  s.prod = n_chains <= sms && 16 + ring + size_t(s.chain_bytes) <= kSmemLimit;
  s.cpb = s.prod ? 1
                 : std::min(kMaxChainsPerBlock, (n_chains + sms - 1) / sms);
  s.cpb = std::max(1, std::min<int>(s.cpb, (kSmemLimit - 16) /
                                               size_t(s.chain_bytes)));
  s.threads = s.prod ? 64 : 32 * s.cpb;
  s.blocks = (n_chains + s.cpb - 1) / s.cpb;
  const size_t base = 16 + (s.prod ? ring : 0) + size_t(s.cpb) * s.chain_bytes;
  const size_t staged = staged_bytes(table_layout(n, d, p), n, e);
  s.staged = base + staged <= kSmemLimit;
  s.smem = base + (s.staged ? staged : 0);
  return s;
}

template <bool kStaged, bool kProd, typename Cell>
int launch(const Args& a, const Shape& s, cudaStream_t stream) {
  auto kern = general_pair_kernel<kStaged, kProd, Cell>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(s.smem));
  if (err != cudaSuccess) return int(err);
  kern<<<s.blocks, s.threads, s.smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <bool kStaged, bool kProd, typename Cell>
int occupancy(const Shape& s) {
  auto kern = general_pair_kernel<kStaged, kProd, Cell>;
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(s.smem)) != cudaSuccess)
    return -1;
  int blocks = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, s.threads,
                                                    s.smem) != cudaSuccess)
    return -1;
  return blocks;
}

// the instantiation of a shape: f<kStaged, kProd, Cell>(args...)
template <template <bool, bool, typename> class Fn, typename... Ts>
int dispatch(const Shape& s, Ts&&... args) {
  if (s.cell == 1) {
    if (s.staged)
      return s.prod ? Fn<true, true, uint8_t>::run(args...)
                    : Fn<true, false, uint8_t>::run(args...);
    return s.prod ? Fn<false, true, uint8_t>::run(args...)
                  : Fn<false, false, uint8_t>::run(args...);
  }
  if (s.staged)
    return s.prod ? Fn<true, true, uint16_t>::run(args...)
                  : Fn<true, false, uint16_t>::run(args...);
  return s.prod ? Fn<false, true, uint16_t>::run(args...)
                : Fn<false, false, uint16_t>::run(args...);
}

template <bool kStaged, bool kProd, typename Cell>
struct Launch {
  static int run(const Args& a, const Shape& s, cudaStream_t st) {
    return launch<kStaged, kProd, Cell>(a, s, st);
  }
};

template <bool kStaged, bool kProd, typename Cell>
struct Occupancy {
  static int run(const Shape& s) { return occupancy<kStaged, kProd, Cell>(s); }
};

bool shape_ok(int n_chains, int n, int e, int d, int p, int k, int t_inner,
              const Shape& s) {
  return n_chains >= 1 && n >= 2 && n <= (1 << 16) && e >= 1 && d >= 1 &&
         d <= 32 && p >= 1 && p <= 32 && k >= 2 && k <= kMaxK &&
         t_inner >= 1 && s.smem <= kSmemLimit;
}

// the row fields are copied 16 bytes a lane from 16-byte boundaries, and
// the tables in one bulk copy
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// The launch shape of a chunk: out[0] the shared memory of a block in
// bytes, out[1] chains a block, out[2] resident blocks an SM
// (cudaOccupancy...), out[3] threads a block, out[4] the shared memory of
// a chain in bytes, out[5] 1 if the tables are staged in shared memory
// (0: read through L1), out[6] 1 with a draws warp a chain. unit_pop as
// the chunk's. Returns a cudaError_t.
int fce_general_pair_shape(int n_chains, int n, int e, int d, int p, int k,
                           int unit_pop, int* out) {
  const Shape s = launch_shape(n, e, d, p, k, unit_pop <= 0, n_chains);
  if (!shape_ok(n_chains, n, e, d, p, k, 1, s))
    return int(cudaErrorInvalidValue);
  out[0] = int(s.smem);
  out[1] = s.cpb;
  out[2] = dispatch<Occupancy>(s, s);
  out[3] = s.threads;
  out[4] = s.chain_bytes;
  out[5] = s.staged;
  out[6] = s.prod;
  return out[2] < 0 ? int(cudaErrorInvalidValue) : 0;
}

// One chunk for every chain; returns a cudaError_t (0 on success).
// recounts (null: none) receives each chain's full recounts of the valid
// pairs after an accepted move.
int fce_general_pair_chunk(
    const uint8_t* tables, const int32_t* edges, const int32_t* pop,
    const float* edge_len, const int32_t* labels, const int32_t* key_in,
    const int8_t* assign_in, const int8_t* cut_in, const int32_t* dist_pop_in,
    const int32_t* conn_in, const float* scal_in, const int32_t* ints_in,
    const int32_t* part_sum_in, const int32_t* last_flipped_in,
    const int32_t* num_flips_in, const int32_t* cut_times_in,
    int32_t* key_out, int8_t* assign_out, int8_t* cut_out,
    int8_t* cut_deg_out, int32_t* dist_pop_out, int32_t* conn_out,
    float* scal_out, int32_t* ints_out, int32_t* part_sum_out,
    int32_t* last_flipped_out, int32_t* num_flips_out,
    int32_t* cut_times_out, int32_t* h_cut, int32_t* h_b, float* h_wait,
    int32_t* h_acc, float* h_weight, int32_t* recounts, int n_chains, int n,
    int e, int d, int p, int k, int t_inner, int patch, int geom_waits,
    int lazy, int parity, int weighted, int fill_conn, int unit_pop,
    float denom, void* stream) {
  Args a;
  a.tables = tables; a.edges = edges; a.pop = pop; a.edge_len = edge_len;
  a.labels = labels;
  a.key_in = key_in; a.assign_in = assign_in; a.cut_in = cut_in;
  a.dist_pop_in = dist_pop_in; a.conn_in = conn_in; a.scal_in = scal_in;
  a.ints_in = ints_in; a.part_sum_in = part_sum_in;
  a.last_flipped_in = last_flipped_in; a.num_flips_in = num_flips_in;
  a.cut_times_in = cut_times_in;
  a.key_out = key_out; a.assign_out = assign_out; a.cut_out = cut_out;
  a.cut_deg_out = cut_deg_out; a.dist_pop_out = dist_pop_out;
  a.conn_out = conn_out; a.scal_out = scal_out; a.ints_out = ints_out;
  a.part_sum_out = part_sum_out; a.last_flipped_out = last_flipped_out;
  a.num_flips_out = num_flips_out; a.cut_times_out = cut_times_out;
  a.h_cut = h_cut; a.h_b = h_b; a.h_wait = h_wait; a.h_acc = h_acc;
  a.h_weight = h_weight; a.recounts = recounts;
  a.n_chains = n_chains; a.n = n; a.e = e; a.d = d; a.p = p; a.k = k;
  a.t_inner = t_inner; a.patch = patch; a.geom_waits = geom_waits;
  a.lazy = lazy; a.parity = parity; a.weighted = weighted;
  a.fill_conn = fill_conn; a.unit_pop = unit_pop; a.denom = denom;
  const Shape s = launch_shape(n, e, d, p, k, unit_pop <= 0, n_chains);
  if (!shape_ok(n_chains, n, e, d, p, k, t_inner, s) || !aligned16(tables) ||
      !aligned16(cut_in) || !aligned16(part_sum_in) ||
      !aligned16(last_flipped_in) || !aligned16(num_flips_in) ||
      !aligned16(cut_times_in) || !aligned16(part_sum_out) ||
      !aligned16(last_flipped_out) || !aligned16(num_flips_out) ||
      !aligned16(cut_times_out))
    return int(cudaErrorInvalidValue);
  a.cpb = s.cpb;
  return dispatch<Launch>(s, a, s, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
