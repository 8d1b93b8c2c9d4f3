// General pair chunk kernel: t_inner steps of the rejection-free k-district
// pair walk on an arbitrary sparse graph (the precinct dual graphs, and any
// graph whose radius-r patches fit 32 slots), one warp per chain, the chunk
// loop inside the kernel.
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
// Per chain in shared memory: the assignment A (a byte a node), each node's
// set of neighbouring districts NB (bit d: a neighbour lies in district d;
// k <= 8), the step's valid-move sets VM and the contiguity plane Cn (the
// state's conn_bits), and the k district tallies. Per step and chain:
//   1. the step's draws, 32 steps a batch (chain_common.cuh::draw_batch);
//   2. the valid moves of each node, NB & ~{own district} under the
//      population gates (f32, dense.py::_pop_planes) and its conn bit; they
//      change only at an accepted move, so a rejected step reuses them. The
//      m-th valid (node, district) pair in node-major order,
//      m = min(int(u * total), max(total - 1, 0)), by a warp prefix of the
//      nodes' counts 32 nodes a turn; with no valid pair node 0, district 0
//      and nothing committed (the JAX body's self-loop);
//   3. accept by the literal bound -beta * score * log_base against
//      log(max(u, 1e-12)), the score the cut change or, under weighted_cut,
//      the f32 sum of delta * edge_len over v's neighbour slots in slot
//      order (lane s holds slot s); on an accepted move A at v, NB of v's
//      neighbours, the pair count b_count by the change of the rows of v and
//      its neighbours, the tallies, the wait from b_count / (n**k - 1), and
//      the conn bits of v and its patch by the patch_connected check of
//      kernel/contiguity.py against the committed A;
//   4. the (T, C) rows cut_count, b_count, wait, accepts and weight (1 +
//      wait, under lazy_uniform).
// cut_times starts from cut_times + cut * T and each accepted flip adds
// delta * (T - t) to v's edges (the change at step t is seen by T - t
// yields). The parity quirk (step.py:538-551) runs at cur_flip_node on lane
// 0 in registers and reaches memory when that node changes. cut and
// cut_deg are written at the chunk's end from A.
//
// A simple kernel: each step at which the state changed rebuilds VM over
// all N nodes (O(N / 32) shared-memory reads a lane), and the tables are
// read through L1.
//
// Traps the code keeps:
//   - the wait denominator is N**k - 1 in f32 (double then rounded, as
//     Python computes it; the wrapper passes it);
//   - the population tests are f32 subtractions and additions of the
//     tallies and pop[i], compared with pop_lo / pop_hi;
//   - patch pad slots hold the node itself and are never members;
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
constexpr size_t kSmemLimit = 227 * 1024;

// The tables this kernel reads of kernel/cuda_dense.py::pack_tables
// (chain_common.cuh::table_layout): patch adjacency bitsets, patch slots,
// neighbour edges, neighbour slots and degrees.
struct Tables {
  const uint32_t* padj;
  const uint16_t* pn;
  const uint32_t* nedge;
  const uint16_t* nbr;
  const uint8_t* deg;
  int pp;
};

__host__ __device__ inline Tables table_view(const uint8_t* base, int n,
                                             int d, int p) {
  const TableLayout l = table_layout(n, d, p);
  Tables t;
  t.pp = l.pp;
  t.padj = reinterpret_cast<const uint32_t*>(base + l.padj);
  t.pn = reinterpret_cast<const uint16_t*>(base + l.pn);
  t.nedge = reinterpret_cast<const uint32_t*>(base + l.nedge);
  t.nbr = reinterpret_cast<const uint16_t*>(base + l.nbr);
  t.deg = base + l.deg;
  return t;
}

struct Args {
  const uint8_t* tables;        // pack_tables
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
  int n_chains, n, e, d, p, k, t_inner;
  int patch, geom_waits, lazy, parity, weighted, fill_conn;
  int unit_pop;                 // > 0: every node's population; 0: varies
  float denom;                  // n**k - 1 in f32
  int cpb, chain_bytes;         // the launch shape
};

// the districts among node x's neighbours, a bit each
__device__ __forceinline__ uint32_t nbr_set(const Tables& tab,
                                            const uint8_t* A, int x, int D) {
  const int dx = __ldg(tab.deg + x);
  const uint16_t* row = tab.nbr + size_t(x) * D;
  uint32_t s = 0u;
  for (int r = 0; r < dx; ++r) s |= 1u << A[__ldg(row + r)];
  return s;
}

// kernel/contiguity.py::patch_connected of node u against A: the
// same-district members of u's patch (pads and u left out), seeds = members
// among the first deg(u) slots (u's neighbours), reach grown from the
// lowest seed over the members' slot adjacency until every seed is reached
// (true) or nothing new is (false).
__device__ bool patch_connected(const Tables& tab, const uint8_t* A, int u,
                                int P) {
  const int du = __ldg(tab.deg + u);
  const uint8_t au = A[u];
  const uint16_t* pn = tab.pn + size_t(u) * tab.pp;
  uint32_t member = 0u;
  for (int s = 0; s < P; ++s) {
    const int x = __ldg(pn + s);
    member |= uint32_t(x != u && A[x] == au) << s;
  }
  const uint32_t first = du >= 32 ? kFull : ((1u << du) - 1u);
  const uint32_t seeds = member & first;
  if ((seeds & (seeds - 1u)) == 0u) return true;  // at most one seed
  const uint32_t* pa = tab.padj + size_t(u) * tab.pp;
  uint32_t reach = seeds & (0u - seeds), frontier = reach;
  while (frontier) {
    const int s = __ffs(frontier) - 1;
    frontier &= frontier - 1u;
    const uint32_t nb = __ldg(pa + s) & member & ~reach;
    reach |= nb;
    frontier |= nb;
    if ((seeds & ~reach) == 0u) return true;
  }
  return false;
}

// A chain's shared memory: Cn (W words), the K tallies (kMaxK ints), then
// A, NB and VM, N bytes each rounded up to 16.
__host__ __device__ inline size_t chain_bytes(int n) {
  const size_t nw = (size_t(n) + 31) >> 5, n16 = (size_t(n) + 15) & ~15;
  return (4 * nw + 4 * kMaxK + 3 * n16 + 15) & ~size_t(15);
}

__global__ void __launch_bounds__(32 * kMaxChainsPerBlock)
    general_pair_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, E = a.e, D = a.d, P = a.p, K = a.k, C = a.n_chains,
            T = a.t_inner;
  const int nw = (n + 31) >> 5, n16 = (n + 15) & ~15;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * a.cpb + warp;
  if (c >= C) return;  // no block barrier below
  const Tables tab = table_view(a.tables, n, D, P);
  unsigned char* base = smem + size_t(warp) * a.chain_bytes;
  uint32_t* Cn = reinterpret_cast<uint32_t*>(base);
  int* dp = reinterpret_cast<int*>(Cn + nw);
  uint8_t* A = reinterpret_cast<uint8_t*>(dp + kMaxK);
  uint8_t* NB = A + n16;
  uint8_t* VM = NB + n16;
  const size_t bn = size_t(c) * n, be = size_t(c) * E;

  // ---- the chain in --------------------------------------------------------
  for (int i = lane; i < n; i += 32) {
    A[i] = static_cast<uint8_t>(a.assign_in[bn + i]);
    a.part_sum_out[bn + i] = a.part_sum_in[bn + i];
    a.last_flipped_out[bn + i] = a.last_flipped_in[bn + i];
    a.num_flips_out[bn + i] = a.num_flips_in[bn + i];
  }
  for (int i = lane; i < E; i += 32)
    a.cut_times_out[be + i] =
        a.cut_times_in[be + i] + int(a.cut_in[be + i]) * T;
  if (lane < K) dp[lane] = a.dist_pop_in[lane * C + c];
  __syncwarp();
  for (int i = lane; i < n; i += 32)
    NB[i] = static_cast<uint8_t>(nbr_set(tab, A, i, D));
  if (!a.fill_conn) {
    for (int k = lane; k < nw; k += 32)
      Cn[k] = static_cast<uint32_t>(a.conn_in[size_t(c) * nw + k]);
  } else {  // dense.py::conn_plane: every node's check, or all of them
    for (int k = 0; k < nw; ++k) {
      const int i = 32 * k + lane;
      const uint32_t w = __ballot_sync(
          kFull, i < n && (!a.patch || patch_connected(tab, A, i, P)));
      if (lane == 0) Cn[k] = w;
    }
  }
  __syncwarp();

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
  const bool unit = a.unit_pop > 0;
  const float unitf = static_cast<float>(a.unit_pop);
  // lane 0's parity run at cur_flip: its node, last_flipped, and the
  // part_sum and num_flips it has added, not yet stored
  int rx = -1, run_lf = 0, run_ps = 0, run_nf = 0;
  auto flush_run = [&]() {
    if (rx < 0) return;
    a.part_sum_out[bn + rx] += run_ps;
    a.num_flips_out[bn + rx] += run_nf;
    a.last_flipped_out[bn + rx] = run_lf;
  };
  bool fresh = false;
  int total = 0;
  Draws draws{0u, 0u, 0u, 0.f, 0.f};  // lane i: step 32 * q + i's draws

  for (int t = 0; t < T; ++t) {
    // ---- 1. the step's uniforms, 32 steps at a time -------------------
    const int slot = t & 31;
    if (slot == 0) {
      draws = draw_batch(key0, key1, min(32, T - t));
      key0 = draws.key0;
      key1 = draws.key1;
    }
    const float u_prop = uniform_of(__shfl_sync(kFull, draws.prop, slot));
    const float log_acc = __shfl_sync(kFull, draws.log_acc, slot);
    const float log_wait = __shfl_sync(kFull, draws.log_wait, slot);

    // ---- 2. the valid pairs and the m-th of them ---------------------------
    if (!fresh) {
      // bit d of fmask: district d may lose a node; of tmask: gain one
      uint32_t fmask = 0u, tmask = 0u;
      if (unit)
        for (int d = 0; d < K; ++d) {
          const float pf = static_cast<float>(dp[d]);
          fmask |= uint32_t(pf - unitf >= pop_lo) << d;
          tmask |= uint32_t(pf + unitf <= pop_hi) << d;
        }
      int cnt = 0;
      for (int i = lane; i < n; i += 32) {
        const uint32_t ai = A[i];
        uint32_t cand = NB[i] & ~(1u << ai);
        if (!bit_at(Cn, i)) cand = 0u;
        uint32_t vm = 0u;
        if (unit) {
          if ((fmask >> ai) & 1u) vm = cand & tmask;
        } else if (cand) {
          const float pf = static_cast<float>(__ldg(a.pop + i));
          if (static_cast<float>(dp[ai]) - pf >= pop_lo) {
            uint32_t rest = cand;
            while (rest) {
              const int d = __ffs(rest) - 1;
              rest &= rest - 1u;
              if (static_cast<float>(dp[d]) + pf <= pop_hi) vm |= 1u << d;
            }
          }
        }
        VM[i] = static_cast<uint8_t>(vm);
        cnt += __popc(vm);
      }
      total = __reduce_add_sync(kFull, cnt);
      fresh = true;
      __syncwarp();
    }
    int m = static_cast<int>(u_prop * static_cast<float>(total));
    m = min(m, max(total - 1, 0));
    int v = 0, d_to = 0;
    if (total > 0) {
      int before = 0;
      for (int k0 = 0; k0 < n; k0 += 32) {
        const int i = k0 + lane;
        const uint32_t vm = i < n ? VM[i] : 0u;
        const int cw = __popc(vm);
        const int incl = incl_scan(cw, lane);
        const int round = __shfl_sync(kFull, incl, 31);
        if (m < before + round) {
          const int r = m - before;
          const int src = __ffs(__ballot_sync(kFull, incl > r)) - 1;
          const int below = __shfl_sync(kFull, incl - cw, src);
          const uint32_t ws = __shfl_sync(kFull, vm, src);
          v = k0 + src;
          d_to = nth_bit(ws, r - below);
          break;
        }
        before += round;
      }
    }

    // ---- 3. accept and commit; lane s < D holds v's slot s -------------
    const bool valid = total > 0;
    const uint32_t d_from = A[v];
    const int dv = __ldg(tab.deg + v);
    const bool msk = lane < dv;
    const int nb = lane < D ? int(__ldg(tab.nbr + size_t(v) * D + lane)) : v;
    const uint32_t na = A[nb];
    const bool oc = msk && na != d_from;
    const bool nc = msk && na != uint32_t(d_to);
    const int dcut = __popc(__ballot_sync(kFull, nc)) -
                     __popc(__ballot_sync(kFull, oc));
    const int eid = msk ? int(__ldg(tab.nedge + size_t(v) * D + lane)) : 0;
    float score;
    if (a.weighted) {  // the slots' terms added in slot order
      const float term =
          msk ? static_cast<float>(int(nc) - int(oc)) * __ldg(a.edge_len + eid)
              : 0.f;
      score = __shfl_sync(kFull, term, 0);
      for (int j = 1; j < D; ++j) score += __shfl_sync(kFull, term, j);
    } else {
      score = static_cast<float>(dcut);
    }
    const float log_bound = -beta * score * log_base;
    const bool accept = valid && (log_acc < log_bound);
    if (accept) {
      // cut_times: v's edges change state now, seen by T - t yields
      if (msk) a.cut_times_out[be + eid] += (int(nc) - int(oc)) * (T - t);
      // the pair rows of v and its neighbours, before and after the move
      int rows = 0;
      if (lane == 0) rows -= __popc(NB[v] & ~(1u << d_from));
      if (msk) rows -= __popc(NB[nb] & ~(1u << na));
      __syncwarp();
      if (lane == 0) A[v] = static_cast<uint8_t>(d_to);
      __syncwarp();
      const uint32_t nbs = msk ? nbr_set(tab, A, nb, D) : 0u;
      __syncwarp();
      if (msk) NB[nb] = static_cast<uint8_t>(nbs);
      if (lane == 0) rows += __popc(NB[v] & ~(1u << d_to));
      if (msk) rows += __popc(nbs & ~(1u << na));
      b_count += __reduce_add_sync(kFull, rows);
      const int popv = unit ? a.unit_pop : __ldg(a.pop + v);
      if (lane == 0) {
        dp[d_from] -= popv;
        dp[d_to] += popv;
      }
      cut_count += dcut;
      if (a.geom_waits) {
        const float pr = static_cast<float>(b_count) / a.denom;
        cur_wait = fmaxf(floorf(log_wait / log1pf(-pr)), 0.f);
      }
      __syncwarp();
      // the conn bits of v and its patch against the committed A
      if (a.patch) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = lane + 32 * h;
          if (i > P) continue;
          const int x =
              i == 0 ? v : int(__ldg(tab.pn + size_t(v) * tab.pp + i - 1));
          if (i > 0 && x == v) continue;
          put_bit(Cn, x, patch_connected(tab, A, x, P));
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
        run_lf = a.last_flipped_out[bn + rx];
        run_ps = 0;
        run_nf = 0;
      }
      const int te = t_yield + t;
      run_ps += -__ldg(a.labels + A[rx]) * (te - run_lf);
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

  // ---- chunk end: assignment, conn bits, cut and cut_deg from A -------------
  for (int i = lane; i < n; i += 32) {
    const uint8_t ai = A[i];
    const int di = __ldg(tab.deg + i);
    const uint16_t* row = tab.nbr + size_t(i) * D;
    int cd = 0;
    for (int r = 0; r < di; ++r) cd += A[__ldg(row + r)] != ai;
    a.assign_out[bn + i] = static_cast<int8_t>(ai);
    a.cut_deg_out[bn + i] = static_cast<int8_t>(cd);
  }
  for (int k = lane; k < nw; k += 32)
    a.conn_out[size_t(c) * nw + k] = static_cast<int32_t>(Cn[k]);
  for (int i = lane; i < E; i += 32) {
    const int2 ends = __ldg(reinterpret_cast<const int2*>(a.edges) + i);
    a.cut_out[be + i] = static_cast<int8_t>(A[ends.x] != A[ends.y]);
  }
  if (lane < K) a.dist_pop_out[lane * C + c] = dp[lane];
  if (lane == 0) {
    a.key_out[c] = static_cast<int32_t>(key0);
    a.key_out[C + c] = static_cast<int32_t>(key1);
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[8] = {cut_count, b_count,  cur_flip, t_yield + T,
                         move_clock, acc_cnt, tries,    exh_cnt};
#pragma unroll
    for (int j = 0; j < 8; ++j) a.ints_out[j * C + c] = ints[j];
  }
}

struct Shape {
  int cpb, threads, blocks, chain_bytes;
  size_t smem;
};

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// up to kMaxChainsPerBlock chains a block, as many as the SMs share out and
// the shared memory holds
Shape launch_shape(int n, int n_chains) {
  Shape s;
  s.chain_bytes = int(chain_bytes(n));
  const int sms = sm_count();
  s.cpb = std::min(kMaxChainsPerBlock, (n_chains + sms - 1) / sms);
  s.cpb = std::max(1, std::min<int>(s.cpb, kSmemLimit / size_t(s.chain_bytes)));
  s.threads = 32 * s.cpb;
  s.blocks = (n_chains + s.cpb - 1) / s.cpb;
  s.smem = size_t(s.cpb) * s.chain_bytes;
  return s;
}

bool shape_ok(int n_chains, int n, int e, int d, int p, int k, int t_inner,
              const Shape& s) {
  return n_chains >= 1 && n >= 2 && n <= (1 << 16) && e >= 1 && d >= 1 &&
         d <= 32 && p >= 1 && p <= 32 && k >= 2 && k <= kMaxK &&
         t_inner >= 1 && s.smem <= kSmemLimit;
}

int set_smem(const Shape& s) {
  return int(cudaFuncSetAttribute(general_pair_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  int(s.smem)));
}

}  // namespace

extern "C" {

// The launch shape of a chunk: out[0] the shared memory of a block in
// bytes, out[1] chains a block, out[2] resident blocks an SM
// (cudaOccupancy...), out[3] threads a block. Returns a cudaError_t.
int fce_general_pair_shape(int n_chains, int n, int* out) {
  const Shape s = launch_shape(n, n_chains);
  if (s.smem > kSmemLimit) return int(cudaErrorInvalidValue);
  int err = set_smem(s);
  if (err != 0) return err;
  int blocks = -1;
  err = int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, general_pair_kernel, s.threads, s.smem));
  out[0] = int(s.smem);
  out[1] = s.cpb;
  out[2] = blocks;
  out[3] = s.threads;
  return err;
}

// One chunk for every chain; returns a cudaError_t (0 on success).
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
    int32_t* h_acc, float* h_weight, int n_chains, int n, int e, int d,
    int p, int k, int t_inner, int patch, int geom_waits, int lazy,
    int parity, int weighted, int fill_conn, int unit_pop, float denom,
    void* stream) {
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
  a.h_weight = h_weight;
  a.n_chains = n_chains; a.n = n; a.e = e; a.d = d; a.p = p; a.k = k;
  a.t_inner = t_inner; a.patch = patch; a.geom_waits = geom_waits;
  a.lazy = lazy; a.parity = parity; a.weighted = weighted;
  a.fill_conn = fill_conn; a.unit_pop = unit_pop; a.denom = denom;
  const Shape s = launch_shape(n, n_chains);
  if (!shape_ok(n_chains, n, e, d, p, k, t_inner, s))
    return int(cudaErrorInvalidValue);
  a.cpb = s.cpb;
  a.chain_bytes = s.chain_bytes;
  int err = set_smem(s);
  if (err != 0) return err;
  general_pair_kernel<<<s.blocks, s.threads, s.smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
