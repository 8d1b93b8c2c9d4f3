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
// Per chain, in shared memory, five bit planes of ceil(N / 32) words: the
// assignment A (district 1), the boundary Bd (cut_deg > 0), the
// contiguity plane Cn (the state's conn_bits), the step's valid set V and
// the nodes flipped in this chunk F. A state that carries no conn_bits
// (a run's first chunk) has Cn filled at the start by one patch check a
// node, the JAX package's init_conn_bits (dense.py:137), which its runner
// runs on entry (ensure_conn_bits). Per step and chain:
//   1. the draws, 32 steps a batch (chain_common.cuh::draw_batch);
//   2. the valid words V = Bd & Cn & population gate (& not the excluded
//      last flip under nobacktrack), lane l owning words l, l + 32, ...;
//      the gate is one test per district for a uniform population and a
//      per-candidate test of pop[i] otherwise, in f32 as dense.py:210 does;
//      the total by a warp reduction;
//   3. the m-th valid node, m = min(int(u * total), max(total - 1, 0)): a
//      warp scan of word popcounts, round by round of 32 words, then the
//      bit inside the word; with no valid node the selection is node 0 and
//      nothing is committed (the JAX body's self-loop);
//   4. accept by the literal bound -beta * dcut * log_base against
//      log(max(u, 1e-12)), lanes s < D holding v's neighbour slot s; on an
//      accepted move: cut, cut_deg, the boundary plane and its count, the
//      population tallies, the wait from the new boundary count, then the
//      conn bits of v and its patch (1 + P lanes, each the patch check of
//      kernel/contiguity.py::patch_connected by a worklist over the
//      patch_adj bitsets; the JAX refresh recomputes them on a rejected
//      step too, where they do not change);
//   5. the record: lanes 0..4 write the (T, C) rows cut_count, b_count,
//      wait, accepts and weight (1 + wait, under lazy_uniform); the wait
//      sum; the parity quirk at cur_flip_node (its part_sum, last_flipped
//      and num_flips advance on every yield once a first move was accepted,
//      rejected steps included, step.py:538-551).
// The reference adds the cut plane to cut_times every yield, O(E) a step.
// Here an edge's cut state changes only when one of its ends flips, so an
// accepted flip at step t adds cut_old * (t - last) to each of v's edges
// (last: the later of its ends' last flip steps in this chunk, else 0)
// and the chunk's end adds cut_now * (T - last) to every edge, plus the
// incoming cut_times. A (C, N) int32 scratch holds the last flip steps,
// read only where F is set. b_count is kept up to date from the cut_deg
// changes of v and its neighbours, the reference's (cut_deg > 0).sum().
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

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace {

using namespace fce;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kChainsPerBlock = 4;
constexpr int kThreads = 32 * kChainsPerBlock;
constexpr int kPlanes = 5;  // A, Bd, Cn, V, F

struct Args {
  // the graph: (N, D) neighbour slots (pad = the node), their edges, the
  // degrees, populations, (N, P) patch slots (pad = the node) and their
  // uint32 adjacency bitsets, (E, 2) edge ends
  const int32_t* nbr;
  const int32_t* nbr_edge;
  const int32_t* deg;
  const int32_t* pop;
  const int32_t* patch_nodes;
  const int32_t* patch_adj;
  const int32_t* edges;
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
  int32_t* last_change;         // (C, N) scratch, read only where flipped
  int n_chains, n, e, d, p, t_inner;
  int patch, geom_waits, nobacktrack, lazy, parity, fill_conn;
  int unit_pop;                 // > 0: every node's population; 0: varies
  int label0, label1;
};

// kernel/contiguity.py::patch_connected of node u against the assignment
// bits A: the same-district members of u's patch (pads and u left out),
// seeds = members among the first deg(u) slots (u's neighbours), reach
// grown from the lowest seed over patch_adj until every seed is reached or
// nothing new is.
__device__ bool patch_connected(const Args& a, const uint32_t* A, int u) {
  const int P = a.p;
  const int du = __ldg(a.deg + u);
  const uint32_t au = bit_at(A, u);
  const int32_t* pn = a.patch_nodes + (size_t)u * P;
  const int32_t* padj = a.patch_adj + (size_t)u * P;
  uint32_t member = 0u;
  for (int s = 0; s < P; ++s) {
    const int x = __ldg(pn + s);
    if (x != u && bit_at(A, x) == au) member |= 1u << s;
  }
  const uint32_t first = du >= 32 ? kFull : ((1u << du) - 1u);
  const uint32_t seeds = member & first;
  if ((seeds & (seeds - 1u)) == 0u) return true;  // at most one seed
  uint32_t reach = seeds & (0u - seeds), frontier = reach;
  while (frontier) {
    const int s = __ffs(frontier) - 1;
    frontier &= frontier - 1u;
    const uint32_t nb =
        static_cast<uint32_t>(__ldg(padj + s)) & member & ~reach;
    reach |= nb;
    frontier |= nb;
    if ((seeds & ~reach) == 0u) return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
    general_dense_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = a.n, E = a.e, D = a.d, C = a.n_chains, T = a.t_inner;
  const int nw = (n + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * kChainsPerBlock + warp;
  if (c >= C) return;  // no block barrier below
  uint32_t* A = smem + (size_t)warp * kPlanes * nw;
  uint32_t* Bd = A + nw;
  uint32_t* Cn = Bd + nw;
  uint32_t* V = Cn + nw;
  uint32_t* F = V + nw;
  const size_t bn = (size_t)c * n, be = (size_t)c * E;

  // ---- the chain in: planes, and the fields updated in place ----------
  for (int k = 0; k < nw; ++k) {
    const int i = 32 * k + lane;
    const bool in = i < n;
    const int8_t av = in ? a.assign_in[bn + i] : int8_t(0);
    const int8_t cd = in ? a.cut_deg_in[bn + i] : int8_t(0);
    const uint32_t wa = __ballot_sync(kFull, in && av == 1);
    const uint32_t wb = __ballot_sync(kFull, in && cd > 0);
    if (lane == 0) {
      A[k] = wa;
      Bd[k] = wb;
    }
    if (in) {
      a.cut_deg_out[bn + i] = cd;
      a.part_sum_out[bn + i] = a.part_sum_in[bn + i];
      a.last_flipped_out[bn + i] = a.last_flipped_in[bn + i];
      a.num_flips_out[bn + i] = a.num_flips_in[bn + i];
    }
  }
  for (int k = lane; k < nw; k += 32) {
    if (!a.fill_conn)
      Cn[k] = static_cast<uint32_t>(a.conn_in[(size_t)c * nw + k]);
    F[k] = 0u;
  }
  for (int i = lane; i < E; i += 32) a.cut_out[be + i] = a.cut_in[be + i];
  __syncwarp();
  if (a.fill_conn) {  // the full plane, from the whole of A
    for (int k = 0; k < nw; ++k) {
      const int i = 32 * k + lane;
      const uint32_t w = __ballot_sync(
          kFull, i < n && (!a.patch || patch_connected(a, A, i)));
      if (lane == 0) Cn[k] = w;
    }
    __syncwarp();
  }

  uint32_t key0 = static_cast<uint32_t>(a.key_in[c]);
  uint32_t key1 = static_cast<uint32_t>(a.key_in[C + c]);
  const float log_base = a.scal_in[c], beta = a.scal_in[C + c];
  const float pop_lo = a.scal_in[2 * C + c], pop_hi = a.scal_in[3 * C + c];
  float cur_wait = a.scal_in[4 * C + c], waits_sum = a.scal_in[5 * C + c];
  int dp0 = a.dist_pop_in[c], dp1 = a.dist_pop_in[C + c];
  int cut_count = a.ints_in[c], b_count = a.ints_in[C + c],
      cur_flip = a.ints_in[2 * C + c], t_yield = a.ints_in[3 * C + c],
      move_clock = a.ints_in[4 * C + c], acc_cnt = a.ints_in[5 * C + c],
      tries = a.ints_in[6 * C + c], exh_cnt = a.ints_in[7 * C + c];
  const float denom =
      static_cast<float>(static_cast<double>(n) * n - 1.0);
  const float unitf = static_cast<float>(a.unit_pop);
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

    // ---- 2. the valid words and their count ----------------------------
    const float p0f = static_cast<float>(dp0), p1f = static_cast<float>(dp1);
    // a node of district 0 moves to 1: 0 loses it, 1 gains it
    const uint32_t gate0 =
        (p0f - unitf >= pop_lo) && (p1f + unitf <= pop_hi) ? kFull : 0u;
    const uint32_t gate1 =
        (p1f - unitf >= pop_lo) && (p0f + unitf <= pop_hi) ? kFull : 0u;
    const bool excl = a.nobacktrack && cur_flip >= 0 &&
                      bit_at(Bd, cur_flip) && b_count > 1;
    int cnt = 0;
    for (int k = lane; k < nw; k += 32) {
      uint32_t w = Bd[k] & Cn[k];
      if (excl && (cur_flip >> 5) == k) w &= ~(1u << (cur_flip & 31));
      const uint32_t av = A[k];
      if (a.unit_pop > 0) {
        w &= (av & gate1) | (~av & gate0);
      } else {
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
      }
      V[k] = w;
      cnt += __popc(w);
    }
    const int total = __reduce_add_sync(kFull, cnt);
    __syncwarp();

    // ---- 3. the m-th valid node ----------------------------------------
    const bool valid = total > 0;
    int m = static_cast<int>(u_prop * static_cast<float>(total));
    m = min(m, max(total - 1, 0));
    int v = 0;
    if (valid) {
      int before = 0;
      for (int k0 = 0; k0 < nw; k0 += 32) {
        const int k = k0 + lane;
        const uint32_t w = k < nw ? V[k] : 0u;
        const int cw = __popc(w);
        int incl = cw;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
          const int x = __shfl_up_sync(kFull, incl, dd);
          if (lane >= dd) incl += x;
        }
        const int round = __shfl_sync(kFull, incl, 31);
        if (m < before + round) {
          const int r = m - before;
          const unsigned hit = __ballot_sync(kFull, incl > r);
          const int src = __ffs(hit) - 1;
          const int below = __shfl_sync(kFull, incl - cw, src);
          const uint32_t ws = __shfl_sync(kFull, w, src);
          v = 32 * (k0 + src) + nth_bit(ws, r - below);
          break;
        }
        before += round;
      }
      v = min(v, n - 1);
    }

    // ---- 4. accept and commit; lane s < D holds v's slot s -------------
    const uint32_t d_from = bit_at(A, v);
    const int dv = __ldg(a.deg + v);
    const bool msk = lane < dv;
    const int nb = lane < D ? __ldg(a.nbr + (size_t)v * D + lane) : v;
    const int eid = lane < D ? __ldg(a.nbr_edge + (size_t)v * D + lane) : 0;
    const uint32_t na = bit_at(A, nb);
    const bool oc = msk && na != d_from;
    const bool nc = msk && na == d_from;  // na != d_to
    const int n_new = __popc(__ballot_sync(kFull, nc));
    const int dcut = n_new - __popc(__ballot_sync(kFull, oc));
    const float log_bound = -beta * static_cast<float>(dcut) * log_base;
    const bool accept = valid && (log_acc < log_bound);
    if (accept) {
      const bool fv = bit_at(F, v);
      int cd_old = 0, last_v = 0, last_n = 0, acc_old = 0;
      if (msk) {
        const bool fn = bit_at(F, nb);
        if (fv) last_v = a.last_change[bn + v];
        if (fn) last_n = a.last_change[bn + nb];
        if (fv || fn) acc_old = a.cut_times_out[be + eid];
        cd_old = a.cut_deg_out[bn + nb];
      }
      const int cdv_old = a.cut_deg_out[bn + v];
      __syncwarp();
      int b_delta = 0;
      if (msk) {
        const int delta = int(nc) - int(oc);
        const int last = last_v > last_n ? last_v : last_n;
        a.cut_times_out[be + eid] = acc_old + int(oc) * (t - last);
        a.cut_out[be + eid] = static_cast<int8_t>(a.cut_out[be + eid] + delta);
        const int cd_new = cd_old + delta;
        a.cut_deg_out[bn + nb] = static_cast<int8_t>(cd_new);
        b_delta = int(cd_new > 0) - int(cd_old > 0);
        if (b_delta) put_bit(Bd, nb, cd_new > 0);
      }
      if (lane == 0) {
        a.cut_deg_out[bn + v] = static_cast<int8_t>(n_new);
        b_delta += int(n_new > 0) - int(cdv_old > 0);
        put_bit(Bd, v, n_new > 0);
        A[v >> 5] ^= 1u << (v & 31);
        F[v >> 5] |= 1u << (v & 31);
        a.last_change[bn + v] = t;
      }
      b_count += __reduce_add_sync(kFull, b_delta);
      __syncwarp();
      const int popv = __ldg(a.pop + v);
      dp0 += d_from == 0u ? -popv : popv;
      dp1 += d_from == 0u ? popv : -popv;
      cut_count += dcut;
      if (a.geom_waits) {
        const float pr = static_cast<float>(b_count) / denom;
        cur_wait = fmaxf(floorf(log_wait / log1pf(-pr)), 0.f);
      }
      cur_flip = v;
      if (a.patch) {
        for (int i = lane; i <= a.p; i += 32) {
          const int u =
              i == 0 ? v : __ldg(a.patch_nodes + (size_t)v * a.p + i - 1);
          if (i == 0 || u != v) put_bit(Cn, u, patch_connected(a, A, u));
        }
      }
      __syncwarp();
    }
    move_clock += accept;
    acc_cnt += accept;
    tries += 1;
    exh_cnt += !valid;

    // ---- 5. the record ---------------------------------------------------
    const size_t row = (size_t)t * C + c;
    if (lane == 0) a.h_cut[row] = cut_count;
    if (lane == 1) a.h_b[row] = b_count;
    if (lane == 2) a.h_wait[row] = cur_wait;
    if (lane == 3) a.h_acc[row] = acc_cnt;
    if (lane == 4 && a.lazy) a.h_weight[row] = 1.0f + cur_wait;
    waits_sum += cur_wait;
    if (a.parity && cur_flip >= 0 && lane == 0) {
      const int sign = bit_at(A, cur_flip) ? a.label1 : a.label0;
      const int ty = t_yield + t;
      const size_t at = bn + cur_flip;
      a.part_sum_out[at] += -sign * (ty - a.last_flipped_out[at]);
      a.last_flipped_out[at] = ty;
      a.num_flips_out[at] += 1;
    }
    __syncwarp();
  }

  // ---- chunk end: assignment, conn bits, cut_times closed at T ----------
  for (int i = lane; i < n; i += 32)
    a.assign_out[bn + i] = static_cast<int8_t>(bit_at(A, i));
  for (int k = lane; k < nw; k += 32)
    a.conn_out[(size_t)c * nw + k] = static_cast<int32_t>(Cn[k]);
  for (int i = lane; i < E; i += 32) {
    const int u = __ldg(a.edges + 2 * i), w = __ldg(a.edges + 2 * i + 1);
    const bool fu = bit_at(F, u), fw = bit_at(F, w);
    const int lu = fu ? a.last_change[bn + u] : 0;
    const int lw = fw ? a.last_change[bn + w] : 0;
    const int last = lu > lw ? lu : lw;
    const int cur = int(bit_at(A, u) != bit_at(A, w));
    a.cut_times_out[be + i] = a.cut_times_in[be + i] +
                              ((fu || fw) ? a.cut_times_out[be + i] : 0) +
                              cur * (T - last);
  }
  if (lane == 0) {
    a.key_out[c] = static_cast<int32_t>(key0);
    a.key_out[C + c] = static_cast<int32_t>(key1);
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

size_t smem_bytes(int n) {
  return 4 * size_t(kPlanes) * size_t((n + 31) >> 5) * kChainsPerBlock;
}

}  // namespace

extern "C" {

// One chunk for every chain; returns a cudaError_t (0 on success).
int fce_general_dense_chunk(
    const int32_t* nbr, const int32_t* nbr_edge, const int32_t* deg,
    const int32_t* pop, const int32_t* patch_nodes, const int32_t* patch_adj,
    const int32_t* edges, const int32_t* key_in, const int8_t* assign_in,
    const int8_t* cut_in, const int8_t* cut_deg_in,
    const int32_t* dist_pop_in, const int32_t* conn_in, const float* scal_in,
    const int32_t* ints_in, const int32_t* part_sum_in,
    const int32_t* last_flipped_in, const int32_t* num_flips_in,
    const int32_t* cut_times_in, int32_t* key_out, int8_t* assign_out,
    int8_t* cut_out, int8_t* cut_deg_out, int32_t* dist_pop_out,
    int32_t* conn_out, float* scal_out, int32_t* ints_out,
    int32_t* part_sum_out, int32_t* last_flipped_out, int32_t* num_flips_out,
    int32_t* cut_times_out, int32_t* h_cut, int32_t* h_b, float* h_wait,
    int32_t* h_acc, float* h_weight, int32_t* last_change, int n_chains,
    int n, int e, int d, int p, int t_inner, int patch, int geom_waits,
    int nobacktrack, int lazy, int parity, int fill_conn, int unit_pop,
    int label0, int label1, void* stream) {
  Args a;
  a.nbr = nbr; a.nbr_edge = nbr_edge; a.deg = deg; a.pop = pop;
  a.patch_nodes = patch_nodes; a.patch_adj = patch_adj; a.edges = edges;
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
  a.h_weight = h_weight; a.last_change = last_change;
  a.n_chains = n_chains; a.n = n; a.e = e; a.d = d; a.p = p;
  a.t_inner = t_inner; a.patch = patch; a.geom_waits = geom_waits;
  a.nobacktrack = nobacktrack; a.lazy = lazy; a.parity = parity;
  a.fill_conn = fill_conn;
  a.unit_pop = unit_pop; a.label0 = label0; a.label1 = label1;
  const size_t smem = smem_bytes(n);
  if (n_chains < 1 || n < 2 || e < 1 || d < 1 || d > 32 || p < 1 ||
      p > 32 || t_inner < 1 || smem > 227 * 1024)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      general_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const int blocks = (n_chains + kChainsPerBlock - 1) / kChainsPerBlock;
  general_dense_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // extern "C"
