// ReCom chunk kernel: t_inner moves of the spanning-tree recombination
// chain, each followed by its record, one thread block a chain, the chunk
// loop inside the block.
//
// Replaces the JAX package's ReCom bodies, which run as XLA code under
// jit + vmap + lax.scan on the TPU (flipcomplexityempirical_tpu/sampling/
// recom.py:55-338): spanning_forest (:55), tree_structure (:100),
// subtree_populations (:132), mark_subtree (:154), recom_move (:177, with
// state/chain_state.py::derive and kernel/step.py::sample_geom_minus1) and
// _run_recom_chunk (:317, with kernel/step.py::record). Its plain version is
// sampling/recom.py::recom_chunk_reference; the two are bit-equal on every
// output, and both draw the JAX package's threefry stream.
//
// A move, per chain:
//   1. split(key, 4) -> (key, k_edge, k_draw, k_wait);
//   2. the cut edge e*: the first maximum of uniform(k_edge, (E,)) over the
//      cut edges (a block argmax); the districts d1, d2 of its ends merge
//      into `member`, rooted at edges[e*, 0];
//   3. up to tree_retries attempts (k_draw's key chain, as recom.py:236-250):
//      - the edge ranks w = permutation(k_tree, E): one or two rounds, each
//        32 random bits a position and a stable LSD radix sort of (bits,
//        items) in shared memory, 4-bit digits, 8 passes; a pass counts
//        each thread's contiguous slice by digit into a digit-major table,
//        scans it and scatters, so equal digits keep their order;
//      - the minimum spanning forest of the member subgraph under w: the
//        ranks are distinct, so it is unique, and Boruvka rounds (shared
//        atomicMin of each component's lightest edge, hooks from the larger
//        component id to the smaller, pointer jumping) give the edges of
//        the JAX package's rounds exactly;
//      - a level-synchronous BFS from the root over the forest's edges into
//        a queue in BFS order, level by level (a node's tree neighbour one
//        level up is its unique parent);
//      - the subtree populations, int32 shared atomics level by level from
//        the deepest (exact; the JAX package's f32 sums are exact too while
//        the graph's population is below 2**24, which the wrapper checks);
//      - the balanced child edges (lo, hi = target * f32(1 -+ eps) in f32
//        as recom.py:227-231 forms them) and the Gumbel argmax over them,
//        -log(-log u) of uniform(k_cut, (N,), minval=tiny), the first
//        index on a tie;
//   4. on a balanced edge: the subtree under the cut child (a level sweep)
//      goes to d1, the rest of member to d2; the parity settlement of the
//      relabelled nodes (recom.py:267-277); cut, cut_count, b_count
//      recounted, dist_pop of d1 and d2 from the subtree's sum; the wait
//      redrawn from k_wait with the new b_count; cur_flip_node = -1;
//   5. the record (kernel/step.py::record): the (T, C) rows cut_count,
//      b_count, wait, accepts (and weight = 1 + wait under lazy_uniform),
//      waits_sum, the parity quirk at cur_flip_node, t_yield.
// cut_times starts from cut_times + cut * T; a committed move at step t
// adds the change of each edge's cut times (T - t), the yields that see it.
// The derived fields (cut, cut_deg, dist_pop, cut_count, b_count) are
// recounted from the assignment at the chunk's start.
//
// What bounds it on the H100. Neither bytes nor operations: a chunk reads
// and writes each chain's state once (~0.2 MB a chain at 64x64), and a
// move's arithmetic (2 x 8064 threefry blocks, 16 radix passes, a few
// Boruvka rounds) is microseconds of the SM's issue rate. A move is a
// chain of dependent block-wide phases, each ended by a barrier: 64
// barriers for the sort, ~4 a Boruvka round, and two for every BFS level
// and one for every level of the roll-up and the subtree sweep, where a
// random spanning tree of a 2048-node district pair is some 100-300 levels
// deep. So the serial levels and the barrier latency bound it. The design
// keeps every phase in shared memory (no global traffic inside a move but
// the changed nodes' and edges' accumulators), runs one 512-thread block a
// chain so that each level's work is a single pass, and lets the blocks of
// other chains fill the SM where the shared memory leaves room (one block
// an SM at 64x64, ~121 KB; more on smaller graphs).
//
// Traps the code keeps:
//   - partitionable threefry: split key j and the j-th word of an array
//     draw are the block at counter (0, j); an array draw's word is the
//     XOR of the block's two words;
//   - uniform(minval=tiny) is floats * (1 - tiny) + tiny, then the max with
//     tiny, in f32 (JAX's _uniform), built with -fmad=false;
//   - the wait is floor(log(max(u, 1e-12)) / log1p(-b / denom)), floored at
//     0, denom = n**k - 1 in f32 (the wrapper passes it);
//   - the argmaxes take the first index on a tie; a chain with no cut edge
//     draws no tree.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
//        -shared -Xcompiler -fPIC (kernel/_build.py).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "chain_common.cuh"

namespace {

using namespace fce;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 16;       // 4-bit radix digits
constexpr int kMaxK = 32;
constexpr float kTiny = 1.17549435e-38f;   // f32 tiny, uniform's minval

__host__ __device__ inline size_t r16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Per-block scratch for the reductions and the chain's small tallies.
struct Small {
  float rv[kWarps];
  int ri[kWarps];
  int rs[kWarps];
  int dp[kMaxK];
  int qtail;
  int pad[3];
};

// Shared memory of a block, byte offsets. The scratch region S holds, one
// phase at a time: the sort's two key buffers; Boruvka's best, hook and
// comp (int32); the BFS's subtree sums (int32), parent, depth, queue
// (int16) and level starts (int32).
struct Layout {
  size_t keys1, hook, comp, parent, depth, order, lstart;
  size_t vals0, vals1, cnt, a, tag, cutb, tree, small, bytes;
};

__host__ __device__ inline Layout layout(int n, int e) {
  Layout l;
  const size_t n4 = r16(4 * size_t(n)), n2 = r16(2 * size_t(n));
  const size_t e4 = r16(4 * size_t(e)), e2 = r16(2 * size_t(e));
  const size_t words = r16(4 * size_t((e + 31) / 32));
  l.keys1 = e4;
  l.hook = n4;
  l.comp = 2 * n4;
  l.parent = n4;
  l.depth = l.parent + n2;
  l.order = l.depth + n2;
  l.lstart = l.order + n2;
  size_t s = 2 * e4;
  if (3 * n4 > s) s = 3 * n4;
  if (l.lstart + r16(4 * size_t(n + 2)) > s) s = l.lstart + r16(4 * size_t(n + 2));
  l.vals0 = s;
  l.vals1 = l.vals0 + e2;
  l.cnt = l.vals1 + e2;
  l.a = l.cnt + r16(2 * size_t(kDigits) * kThreads);
  l.tag = l.a + r16(size_t(n));
  l.cutb = l.tag + r16(size_t(n));
  l.tree = l.cutb + words;
  l.small = l.tree + words;
  l.bytes = l.small + r16(sizeof(Small));
  return l;
}

struct Args {
  const int32_t* edges;         // (E, 2)
  const int32_t* pop;           // (N,)
  const int32_t* nbr;           // (N, D)
  const int32_t* nbr_edge;      // (N, D)
  const int8_t* nbr_mask;       // (N, D)
  const int32_t* labels;        // (K,)
  const int32_t* key_in;        // (2, C)
  const int8_t* a_in;           // (C, N)
  const float* scal_in;         // (2, C): cur_wait, waits_sum
  const int32_t* ints_in;       // (8, C)
  const int32_t* part_sum_in;   // (C, N)
  const int32_t* last_flipped_in;
  const int32_t* num_flips_in;
  const int32_t* cut_times_in;  // (C, E)
  int32_t* key_out;
  int8_t* a_out;
  int8_t* cut_out;              // (C, E)
  int8_t* cut_deg_out;          // (C, N)
  int32_t* dist_pop_out;        // (K, C)
  float* scal_out;
  int32_t* ints_out;
  int32_t* part_sum_out;
  int32_t* last_flipped_out;
  int32_t* num_flips_out;
  int32_t* cut_times_out;
  int32_t* row_cut;             // (T, C) rows
  int32_t* row_b;
  float* row_wait;
  int32_t* row_acc;
  float* row_weight;            // or null
  int C, N, E, D, K, T;
  int pair, parity, geom, retries, rounds, has_target;
  float target, lo_f, hi_f, denom;
};

struct Key {
  uint32_t k0, k1;
};

// split key j: the block at counter (0, j)
__device__ __forceinline__ Key split_at(Key k, uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k.k0, k.k1, x0, x1);
  return Key{x0, x1};
}

// word i of an array draw: the XOR of the block at counter (0, i)
__device__ __forceinline__ uint32_t bits_at(Key k, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(k.k0, k.k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// the block's first maximum of (v, i), in every thread
__device__ void block_argmax(float& v, int& i, Small* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    better(v, i, __shfl_xor_sync(0xFFFFFFFFu, v, off),
           __shfl_xor_sync(0xFFFFFFFFu, i, off));
  if (lane == 0) {
    sm->rv[warp] = v;
    sm->ri[warp] = i;
  }
  __syncthreads();
  v = sm->rv[0];
  i = sm->ri[0];
  for (int w = 1; w < kWarps; ++w) better(v, i, sm->rv[w], sm->ri[w]);
  __syncthreads();
}

// the block's sum, in every thread
__device__ int block_sum(int x, Small* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xFFFFFFFFu, x, off);
  if (lane == 0) sm->rs[warp] = x;
  __syncthreads();
  int tot = 0;
  for (int w = 0; w < kWarps; ++w) tot += sm->rs[w];
  __syncthreads();
  return tot;
}

// the exclusive prefix of x over the block's threads in thread order
__device__ int block_excl_scan(int x, Small* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = incl_scan(x, lane);
  if (lane == 31) sm->rs[warp] = incl;
  __syncthreads();
  int pre = 0;
  for (int w = 0; w < warp; ++w) pre += sm->rs[w];
  __syncthreads();
  return pre + incl - x;
}

// One round of jax.random.permutation's _shuffle: items (vals) stably
// sorted by the 32-bit keys, 8 passes of 4 bits from k0/v0 through k1/v1
// and back.
__device__ void radix_round(uint32_t* k0, uint32_t* k1, uint16_t* v0,
                            uint16_t* v1, uint16_t* cnt, int E, Small* sm) {
  const int t = threadIdx.x;
  const int per = (E + kThreads - 1) / kThreads;
  const int beg = min(E, t * per), end = min(E, beg + per);
  for (int pass = 0; pass < 8; ++pass) {
    const int sh = 4 * pass;
    const uint32_t* kin = (pass & 1) ? k1 : k0;
    uint32_t* kout = (pass & 1) ? k0 : k1;
    const uint16_t* vin = (pass & 1) ? v1 : v0;
    uint16_t* vout = (pass & 1) ? v0 : v1;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) cnt[d * kThreads + t] = 0;
    for (int i = beg; i < end; ++i) ++cnt[((kin[i] >> sh) & 15u) * kThreads + t];
    __syncthreads();
    uint16_t* mine = cnt + kDigits * t;
    int loc[kDigits];
    int run = 0;
#pragma unroll
    for (int j = 0; j < kDigits; ++j) {
      loc[j] = mine[j];
      run += loc[j];
    }
    int pre = block_excl_scan(run, sm);
#pragma unroll
    for (int j = 0; j < kDigits; ++j) {
      mine[j] = static_cast<uint16_t>(pre);
      pre += loc[j];
    }
    __syncthreads();
    for (int i = beg; i < end; ++i) {
      const uint32_t key = kin[i];
      const int at = cnt[((key >> sh) & 15u) * kThreads + t]++;
      kout[at] = key;
      vout[at] = vin[i];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ bool bit(const uint32_t* w, int i) {
  return (w[i >> 5] >> (i & 31)) & 1u;
}

// One tree attempt with key ka. Leaves the BFS arrays in S; returns the cut
// child, or -1 where no tree edge balances.
__device__ int attempt(const Args& a, Key ka, char* smem, const Layout& L,
                       int root, Small* sm) {
  const int t = threadIdx.x, N = a.N, E = a.E, D = a.D;
  uint32_t* keys0 = reinterpret_cast<uint32_t*>(smem);
  uint32_t* keys1 = reinterpret_cast<uint32_t*>(smem + L.keys1);
  uint16_t* vals0 = reinterpret_cast<uint16_t*>(smem + L.vals0);
  uint16_t* vals1 = reinterpret_cast<uint16_t*>(smem + L.vals1);
  uint16_t* cnt = reinterpret_cast<uint16_t*>(smem + L.cnt);
  const uint8_t* tag = reinterpret_cast<uint8_t*>(smem + L.tag);
  uint32_t* tree = reinterpret_cast<uint32_t*>(smem + L.tree);
  const Key k_tree = split_at(ka, 0), k_cut = split_at(ka, 1);

  // ---- the ranks: w[e] = vals0[e] ------------------------------------
  for (int i = t; i < E; i += kThreads) vals0[i] = static_cast<uint16_t>(i);
  Key kr = k_tree;
  for (int r = 0; r < a.rounds; ++r) {
    const Key sub = split_at(kr, 1);
    kr = split_at(kr, 0);
    for (int i = t; i < E; i += kThreads) keys0[i] = bits_at(sub, i);
    __syncthreads();
    radix_round(keys0, keys1, vals0, vals1, cnt, E, sm);
  }
  __syncthreads();

  // ---- Boruvka over the member subgraph ------------------------------
  int* best = reinterpret_cast<int*>(smem);
  int* hook = reinterpret_cast<int*>(smem + L.hook);
  int* comp = reinterpret_cast<int*>(smem + L.comp);
  for (int v = t; v < N; v += kThreads) comp[v] = v;
  for (int i = t; i < (E + 31) / 32; i += kThreads) tree[i] = 0u;
  __syncthreads();
  while (true) {
    for (int v = t; v < N; v += kThreads) {
      best[v] = E;
      hook[v] = v;
    }
    __syncthreads();
    bool alive = false;
    for (int e = t; e < E; e += kThreads) {
      const int u = __ldg(a.edges + 2 * e), v = __ldg(a.edges + 2 * e + 1);
      if ((tag[u] & tag[v] & 1) == 0) continue;
      const int cu = comp[u], cv = comp[v];
      if (cu == cv) continue;
      alive = true;
      const int we = vals0[e];
      atomicMin(best + cu, we);
      atomicMin(best + cv, we);
    }
    if (!__syncthreads_or(alive)) break;
    for (int e = t; e < E; e += kThreads) {
      const int u = __ldg(a.edges + 2 * e), v = __ldg(a.edges + 2 * e + 1);
      if ((tag[u] & tag[v] & 1) == 0) continue;
      const int cu = comp[u], cv = comp[v];
      if (cu == cv) continue;
      const int we = vals0[e];
      if (we == best[cu] || we == best[cv]) {
        atomicOr(tree + (e >> 5), 1u << (e & 31));
        atomicMin(hook + max(cu, cv), min(cu, cv));
      }
    }
    __syncthreads();
    bool changed;
    do {
      changed = false;
      for (int v = t; v < N; v += kThreads) {
        const int h = hook[v], hh = hook[h];
        if (hh != h) {
          hook[v] = hh;
          changed = true;
        }
      }
    } while (__syncthreads_or(changed));
    for (int v = t; v < N; v += kThreads) comp[v] = hook[comp[v]];
    __syncthreads();
  }

  // ---- BFS from the root over the forest's edges ---------------------
  int* sub = reinterpret_cast<int*>(smem);
  int16_t* parent = reinterpret_cast<int16_t*>(smem + L.parent);
  int16_t* depth = reinterpret_cast<int16_t*>(smem + L.depth);
  int16_t* order = reinterpret_cast<int16_t*>(smem + L.order);
  int* lstart = reinterpret_cast<int*>(smem + L.lstart);
  for (int v = t; v < N; v += kThreads) {
    depth[v] = -1;
    parent[v] = static_cast<int16_t>(v);
  }
  __syncthreads();
  if (t == 0) {
    depth[root] = 0;
    order[0] = static_cast<int16_t>(root);
    lstart[0] = 0;
    lstart[1] = 1;
    sm->qtail = 1;
  }
  __syncthreads();
  int nlev = 0;
  while (true) {
    const int s = lstart[nlev], f = lstart[nlev + 1];
    if (s == f) break;
    for (int i = s + t; i < f; i += kThreads) {
      const int v = order[i];
      for (int j = 0; j < D; ++j) {
        const int slot = v * D + j;
        if (!__ldg(a.nbr_mask + slot) || !bit(tree, __ldg(a.nbr_edge + slot)))
          continue;
        const int w = __ldg(a.nbr + slot);
        if (depth[w] < 0) {
          depth[w] = static_cast<int16_t>(nlev + 1);
          parent[w] = static_cast<int16_t>(v);
          order[atomicAdd(&sm->qtail, 1)] = static_cast<int16_t>(w);
        }
      }
    }
    __syncthreads();
    if (t == 0) lstart[nlev + 2] = sm->qtail;
    __syncthreads();
    ++nlev;
  }

  // ---- subtree populations, deepest level first ----------------------
  for (int v = t; v < N; v += kThreads)
    sub[v] = depth[v] >= 0 ? __ldg(a.pop + v) : 0;
  __syncthreads();
  for (int lv = nlev - 1; lv > 0; --lv) {
    for (int i = lstart[lv] + t; i < lstart[lv + 1]; i += kThreads) {
      const int v = order[i];
      atomicAdd(sub + parent[v], sub[v]);
    }
    __syncthreads();
  }

  // ---- the balanced child edges' Gumbel argmax -----------------------
  const float total = static_cast<float>(sub[root]);
  const float target = a.has_target ? a.target : total / 2.0f;
  const float lo = target * a.lo_f, hi = target * a.hi_f;
  float bv = -INFINITY;
  int bi = N;
  for (int v = t; v < N; v += kThreads) {
    if (depth[v] <= 0) continue;
    const float s = static_cast<float>(sub[v]);
    const float rest = total - s;
    if (!(s >= lo && s <= hi && rest >= lo && rest <= hi)) continue;
    const float f = uniform_of(bits_at(k_cut, v));
    const float u = fmaxf(kTiny, f * (1.0f - kTiny) + kTiny);
    better(bv, bi, -logf(-logf(u)), v);
  }
  block_argmax(bv, bi, sm);
  // nlev rides in lstart[N + 1] for the caller's subtree sweep
  if (t == 0) lstart[N + 1] = nlev;
  __syncthreads();
  return bi < N ? bi : -1;
}

// the derived b_count: boundary nodes ('bi') or distinct (node, other
// neighbouring district) pairs ('pair')
__device__ int count_b(const Args& a, const int8_t* A, Small* sm) {
  int b = 0;
  for (int v = threadIdx.x; v < a.N; v += kThreads) {
    uint32_t m = 0u;
    for (int j = 0; j < a.D; ++j) {
      const int slot = v * a.D + j;
      if (__ldg(a.nbr_mask + slot)) m |= 1u << A[__ldg(a.nbr + slot)];
    }
    m &= ~(1u << A[v]);
    b += a.pair ? __popc(m) : (m != 0u);
  }
  return block_sum(b, sm);
}

__global__ void __launch_bounds__(kThreads)
    recom_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const int c = blockIdx.x, t = threadIdx.x;
  const int N = a.N, E = a.E, C = a.C, T = a.T;
  const Layout L = layout(N, E);
  int8_t* A = reinterpret_cast<int8_t*>(smem + L.a);
  uint8_t* tag = reinterpret_cast<uint8_t*>(smem + L.tag);
  uint32_t* cutb = reinterpret_cast<uint32_t*>(smem + L.cutb);
  Small* sm = reinterpret_cast<Small*>(smem + L.small);
  const size_t rn = size_t(c) * N, re = size_t(c) * E;

  // ---- chunk start ----------------------------------------------------
  for (int v = t; v < N; v += kThreads) {
    A[v] = a.a_in[rn + v];
    a.part_sum_out[rn + v] = a.part_sum_in[rn + v];
    a.last_flipped_out[rn + v] = a.last_flipped_in[rn + v];
    a.num_flips_out[rn + v] = a.num_flips_in[rn + v];
  }
  for (int i = t; i < (E + 31) / 32; i += kThreads) cutb[i] = 0u;
  if (t < kMaxK) sm->dp[t] = 0;
  __syncthreads();
  int cnt = 0;
  for (int e = t; e < E; e += kThreads) {
    const int cut = A[__ldg(a.edges + 2 * e)] != A[__ldg(a.edges + 2 * e + 1)];
    a.cut_times_out[re + e] = a.cut_times_in[re + e] + cut * T;
    if (cut) atomicOr(cutb + (e >> 5), 1u << (e & 31));
    cnt += cut;
  }
  for (int v = t; v < N; v += kThreads) atomicAdd(sm->dp + A[v], __ldg(a.pop + v));
  int cut_count = block_sum(cnt, sm);
  int b_count = count_b(a, A, sm);

  Key key{static_cast<uint32_t>(a.key_in[c]), static_cast<uint32_t>(a.key_in[C + c])};
  float cur_wait = a.scal_in[c], waits_sum = a.scal_in[C + c];
  int cur_flip = a.ints_in[2 * C + c], t_yield = a.ints_in[3 * C + c];
  int move_clock = a.ints_in[4 * C + c], accepts = a.ints_in[5 * C + c];
  int tries = a.ints_in[6 * C + c], exhausted = a.ints_in[7 * C + c];
  const int attempts = a.retries > 1 ? a.retries : 1;

  for (int step = 0; step < T; ++step) {
    const Key k_edge = split_at(key, 1), k_draw = split_at(key, 2),
              k_wait = split_at(key, 3);
    key = split_at(key, 0);

    // ---- the cut edge -------------------------------------------------
    float bv = -INFINITY;
    int es = E;
    for (int e = t; e < E; e += kThreads)
      if (bit(cutb, e)) better(bv, es, uniform_of(bits_at(k_edge, e)), e);
    block_argmax(bv, es, sm);
    int cc = -1, d1 = 0, d2 = 0;
    if (es < E) {
      const int root = __ldg(a.edges + 2 * es);
      d1 = A[root];
      d2 = A[__ldg(a.edges + 2 * es + 1)];
      for (int v = t; v < N; v += kThreads)
        tag[v] = (A[v] == d1 || A[v] == d2) ? 1 : 0;
      __syncthreads();
      Key kn = split_at(k_draw, 0), ka = split_at(k_draw, 1);
      for (int at = 0; at < attempts && cc < 0; ++at) {
        if (at > 0) {
          ka = split_at(kn, 1);
          kn = split_at(kn, 0);
        }
        cc = attempt(a, ka, smem, L, root, sm);
      }
    }
    const bool found = cc >= 0;

    if (found) {
      // ---- the subtree under cc -> d1, the rest of member -> d2 --------
      int* sub = reinterpret_cast<int*>(smem);
      const int16_t* parent = reinterpret_cast<int16_t*>(smem + L.parent);
      const int16_t* depth = reinterpret_cast<int16_t*>(smem + L.depth);
      const int16_t* order = reinterpret_cast<int16_t*>(smem + L.order);
      const int* lstart = reinterpret_cast<int*>(smem + L.lstart);
      const int nlev = lstart[N + 1];
      if (t == 0) tag[cc] |= 2;
      __syncthreads();
      for (int lv = depth[cc] + 1; lv < nlev; ++lv) {
        for (int i = lstart[lv] + t; i < lstart[lv + 1]; i += kThreads) {
          const int v = order[i];
          if (tag[parent[v]] & 2) tag[v] |= 2;
        }
        __syncthreads();
      }
      for (int v = t; v < N; v += kThreads) {
        if (!(tag[v] & 1)) continue;
        const int old = A[v];
        const int nd = (tag[v] & 2) ? d1 : d2;
        if (nd == old) continue;
        A[v] = static_cast<int8_t>(nd);
        if (a.parity) {
          const size_t at = rn + v;
          a.part_sum_out[at] +=
              a.labels[old] * (t_yield - a.last_flipped_out[at]);
          a.last_flipped_out[at] = t_yield;
          a.num_flips_out[at] += 1;
        }
      }
      const int sub_cc = sub[cc];
      __syncthreads();
      if (t == 0) {
        const int pair_pop = sm->dp[d1] + sm->dp[d2];
        sm->dp[d1] = sub_cc;
        sm->dp[d2] = pair_pop - sub_cc;
      }
      // ---- the derived fields ------------------------------------------
      cnt = 0;
      for (int e = t; e < E; e += kThreads) {
        const bool now = A[__ldg(a.edges + 2 * e)] != A[__ldg(a.edges + 2 * e + 1)];
        if (now != bit(cutb, e)) {
          a.cut_times_out[re + e] += (now ? 1 : -1) * (T - step);
          put_bit(cutb, e, now);
        }
        cnt += now;
      }
      cut_count = block_sum(cnt, sm);
      b_count = count_b(a, A, sm);
      if (a.geom) {
        const float u = uniform_of(bits_at(k_wait, 0));
        const float p = static_cast<float>(b_count) / a.denom;
        cur_wait = fmaxf(floorf(logf(fmaxf(u, 1e-12f)) / log1pf(-p)), 0.f);
      }
      cur_flip = -1;
      ++move_clock;
      ++accepts;
    } else {
      ++exhausted;
    }
    ++tries;
    if (es < E) {
      for (int v = t; v < N; v += kThreads) tag[v] = 0;
    }

    // ---- the record ----------------------------------------------------
    if (t == 0) {
      const size_t r = size_t(step) * C + c;
      a.row_cut[r] = cut_count;
      a.row_b[r] = b_count;
      a.row_wait[r] = cur_wait;
      a.row_acc[r] = accepts;
      if (a.row_weight) a.row_weight[r] = 1.0f + cur_wait;
      if (a.parity && cur_flip >= 0) {
        const size_t at = rn + cur_flip;
        const int sign = a.labels[A[cur_flip]];
        const int lf = a.last_flipped_out[at];
        a.part_sum_out[at] += -sign * (t_yield - lf);
        a.last_flipped_out[at] = t_yield;
        a.num_flips_out[at] += 1;
      }
    }
    waits_sum = waits_sum + cur_wait;
    ++t_yield;
    __syncthreads();
  }

  // ---- chunk end --------------------------------------------------------
  for (int v = t; v < N; v += kThreads) {
    a.a_out[rn + v] = A[v];
    int deg = 0;
    for (int j = 0; j < a.D; ++j) {
      const int slot = v * a.D + j;
      deg += __ldg(a.nbr_mask + slot) && A[__ldg(a.nbr + slot)] != A[v];
    }
    a.cut_deg_out[rn + v] = static_cast<int8_t>(deg);
  }
  for (int e = t; e < E; e += kThreads) a.cut_out[re + e] = bit(cutb, e);
  if (t < a.K) a.dist_pop_out[size_t(t) * C + c] = sm->dp[t];
  if (t == 0) {
    a.key_out[c] = static_cast<int32_t>(key.k0);
    a.key_out[C + c] = static_cast<int32_t>(key.k1);
    a.scal_out[c] = cur_wait;
    a.scal_out[C + c] = waits_sum;
    const int ints[8] = {cut_count, b_count, cur_flip, t_yield,
                         move_clock, accepts, tries, exhausted};
    for (int i = 0; i < 8; ++i) a.ints_out[i * C + c] = ints[i];
  }
}

}  // namespace

// The launch shape for a graph of n nodes and e edges: out[0] shared
// memory a block, out[1] blocks resident an SM, out[2] threads a block,
// out[3] registers a thread, out[4] the card's SM count.
extern "C" int fce_recom_shape(int n, int e, int* out) {
  const size_t bytes = layout(n, e).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      recom_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, recom_chunk_kernel, kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, recom_chunk_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = static_cast<int>(bytes);
  out[1] = blocks;
  out[2] = kThreads;
  out[3] = attr.numRegs;
  out[4] = sms;
  return 0;
}

extern "C" int fce_recom_chunk(
    const int32_t* edges, const int32_t* pop, const int32_t* nbr,
    const int32_t* nbr_edge, const int8_t* nbr_mask, const int32_t* labels,
    const int32_t* key_in, const int8_t* a_in, const float* scal_in,
    const int32_t* ints_in, const int32_t* part_sum_in,
    const int32_t* last_flipped_in, const int32_t* num_flips_in,
    const int32_t* cut_times_in, int32_t* key_out, int8_t* a_out,
    int8_t* cut_out, int8_t* cut_deg_out, int32_t* dist_pop_out,
    float* scal_out, int32_t* ints_out, int32_t* part_sum_out,
    int32_t* last_flipped_out, int32_t* num_flips_out,
    int32_t* cut_times_out, int32_t* row_cut, int32_t* row_b,
    float* row_wait, int32_t* row_acc, float* row_weight, int C, int N,
    int E, int D, int K, int T, int pair, int parity, int geom, int retries,
    int rounds, int has_target, float target, float lo_f, float hi_f,
    float denom, void* stream) {
  Args a{edges, pop, nbr, nbr_edge, nbr_mask, labels, key_in, a_in,
         scal_in, ints_in, part_sum_in, last_flipped_in, num_flips_in,
         cut_times_in, key_out, a_out, cut_out, cut_deg_out, dist_pop_out,
         scal_out, ints_out, part_sum_out, last_flipped_out, num_flips_out,
         cut_times_out, row_cut, row_b, row_wait, row_acc, row_weight,
         C, N, E, D, K, T, pair, parity, geom, retries, rounds, has_target,
         target, lo_f, hi_f, denom};
  const size_t bytes = layout(N, E).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      recom_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  recom_chunk_kernel<<<C, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
