// Epsilon-bounded graph search on the device: the search tree's descent and
// the beam's seeding (search_seed_kernel), then the beam's steps
// (beam_search_kernel). One block a query, in both.
//
// Replaces no TPU kernel: the JAX package runs the search as an XLA
// while_loop (pynndescent_tpu/models/search.py::search_block) and its tree
// descent as a loop of gathers (rp_trees.py). The port's torch loop
// (pynndescent_torch/models/search.py) launched some 130 kernels and waited
// on one host sync a beam step, and some 27 launches a tree level: at one
// query a call the device idled 93% of the call. These kernels run the same
// algorithm with no launch and no sync between the queries' ingest and their
// rerank.
//
// What bounds them on the H100: at one query, the latency of dependent
// gathers. A beam step reads its expanded ids' adjacency rows, then the data
// rows they name, each a round trip to device memory, and a tree level its
// two anchor rows: some 19 steps and 18 levels a query, well under 2 MB in
// all. At large batches, bytes: a step reads E * deg rows of d values a
// query, the seed a leaf's rows. The design keeps everything else on chip:
// the query row, the beam and a step's candidates stay in shared memory, a
// warp takes a candidate row whole (its lanes read 16 bytes each along d
// where rows are 16-byte aligned) and sums <q, x> and |x|^2 in one pass, and
// a query that stops early leaves its block, with no lockstep. Measured
// (PERF.md), a step's own merge, three passes over shared memory between
// barriers, takes more of its time than its two gathers.
//
// Semantics, those of the torch loop (the card tests hold the two to equal
// ids, distances and step counts on rows whose sums are exact):
// * the margin of a tree level is (<q, xa> - |xa|^2 / 2) - (<q, xb> -
//   |xb|^2 / 2) in fp32 (angular trees: <q, x> / max(|x|, 1e-8), norms given;
//   materialized trees: <q, hyper> - offset); an exact zero takes the coin
//   bit (coins >> (level % 32)) & 1; the walk stops at a node whose two
//   children are itself.
// * the seed merges every member of the query's leaf and the given random
//   ids into an empty beam, kSeedChunk candidates a merge; the result is the
//   beam_width smallest distinct ids whatever the chunks, as the torch
//   loop's passes give it.
// * a step takes the E smallest flagged entries under the bound
//   d_k + epsilon (d_k - min_distance) (lowest position first on ties),
//   clears their flags, gathers their adjacency rows (ids < 0 skipped),
//   computes gram_distance (csrc/gram_metrics.cuh) and merges them as
//   ops/neighbors.py::merge_candidates does: order by (distance, id), an id
//   kept once with its smallest distance, the incumbent winning an exact tie,
//   inserted entries flagged, incumbents keeping their flags; -0.0 ranks
//   before +0.0 where the torch merge takes its top-k path (signed_zero,
//   the seed's merges only: a step's merge is never on that path).
// * after a step's merge the beam keeps its entries under the new bound,
//   at least the seed's width W and at most cap (the torch loop's
//   _keep_admitted): the beam's length grows with what the bound admits,
//   in shared memory laid out for cap entries.
//   A query stops when no flagged entry is under its bound, leaving the
//   state the lockstep loop leaves it in.
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_metrics.cuh"

namespace {

constexpr int kSearchThreads = 256;
constexpr int kSearchWarps = kSearchThreads / 32;
// blocks an SM holds at once: the registers this leaves (40 a thread) keep a
// batch's blocks resident; at 2 blocks an SM a batch's beam took 2.5x longer
constexpr int kSearchBlocksPerSm = 6;
constexpr int kRowUnroll = 4;  // 16-byte loads in flight a lane, a row
constexpr int kSeedChunk = 256;  // candidates of one seeding merge
constexpr int kMaxBeam = 1024;  // a warp's 32 lanes x 32 bits of selection marks
constexpr int kMaxCand = 1024;
constexpr int kMaxExpand = 64;
constexpr int kMaxDynamicSmem = 160 * 1024;
constexpr unsigned long long kNoKey = ~0ull;

// one element of a row as fp32 (bfloat16: its bits are the high half)
template <bool kBf16>
__device__ __forceinline__ float row_elem(const void* row, int i) {
  if (kBf16) {
    return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(row)[i]) << 16);
  }
  return static_cast<const float*>(row)[i];
}

// adds 16 bytes of a row (4 fp32 or 8 bf16 values) against the query's fp32
// values at q to the dot product g and the squared norm s
template <bool kBf16>
__device__ __forceinline__ void accumulate16(const uint4& v, const float* q, float& g, float& s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if (kBf16) {
    const float4 qa = reinterpret_cast<const float4*>(q)[0];
    const float4 qb = reinterpret_cast<const float4*>(q)[1];
    const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float lo = __uint_as_float(w[t] << 16);
      const float hi = __uint_as_float(w[t] & 0xffff0000u);
      g = fmaf(lo, qv[2 * t], g);
      s = fmaf(lo, lo, s);
      g = fmaf(hi, qv[2 * t + 1], g);
      s = fmaf(hi, hi, s);
    }
  } else {
    const float4 qa = *reinterpret_cast<const float4*>(q);
    const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float x = __uint_as_float(w[t]);
      g = fmaf(x, qv[t], g);
      s = fmaf(x, x, s);
    }
  }
}

// (<q, x>, |x|^2) of one row x, summed over the calling warp; every lane gets
// the sums. vec: the row is 16-byte aligned and d * sizeof(T) a multiple of
// 16, so each lane reads 16 bytes at a time; otherwise one value a lane.
template <bool kBf16>
__device__ float2 row_dot(const void* row, const float* q, int d, bool vec, int lane) {
  float g = 0.0f, s = 0.0f;
  if (vec) {
    constexpr int kPer = kBf16 ? 8 : 4;
    const int chunks = d / kPer;
    const uint4* src = static_cast<const uint4*>(row);
    for (int c0 = 0; c0 < chunks; c0 += 32 * kRowUnroll) {
      uint4 buf[kRowUnroll];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int c = c0 + u * 32 + lane;
        buf[u] = c < chunks ? __ldg(src + c) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const int c = c0 + u * 32 + lane;
        if (c < chunks) accumulate16<kBf16>(buf[u], q + c * kPer, g, s);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float x = row_elem<kBf16>(row, i);
      g = fmaf(x, q[i], g);
      s = fmaf(x, x, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    g += __shfl_xor_sync(0xffffffffu, g, off);
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return make_float2(g, s);
}

template <bool kBf16>
__device__ __forceinline__ const void* row_ptr(const void* X, long long id, int d) {
  return static_cast<const char*>(X) + id * d * (kBf16 ? 2 : 4);
}

// float order as an unsigned key (ops/neighbors.py::float_order_key):
// signed_zero keeps -0.0 below +0.0 (top-k order), else the two are one
__device__ __forceinline__ uint32_t order_key(float d, bool signed_zero) {
  if (!signed_zero && d == 0.0f) d = 0.0f;
  const uint32_t b = __float_as_uint(d);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long entry_key(float d, int id, bool signed_zero) {
  return (static_cast<unsigned long long>(order_key(d, signed_zero)) << 32) |
         static_cast<uint32_t>(id);
}

// The block's shared memory: the query row, two beam buffers (one read, one
// written by a merge), a merge's candidates and its keys. Laid out as
// search_smem_bytes counts it. Buffer b of a pair is an offset from the
// pair's base, not an element of a pointer array: an array indexed at run
// time would live in local memory, and every access would load from it.
struct SearchSmem {
  float* q;
  unsigned long long* keys;  // [W + C]
  float* bd0;  // [2][W] distances
  int* bi0;  // [2][W] ids
  float* cd;  // [C]
  int* ci;
  unsigned char* bf0;  // [2][W] flags
  unsigned char* removed;  // [W]: an incumbent beaten by a candidate of its id
  int W;
  __device__ __forceinline__ float* bd(int b) const { return bd0 + b * W; }
  __device__ __forceinline__ int* bi(int b) const { return bi0 + b * W; }
  __device__ __forceinline__ unsigned char* bf(int b) const { return bf0 + b * W; }
};

__host__ __device__ constexpr int search_smem_bytes(int d, int W, int C) {
  return (16 * ((d + 3) / 4) + 8 * (W + C) + 16 * W + 8 * C + 3 * W + 15) / 16 * 16;
}

__device__ __forceinline__ SearchSmem carve(unsigned char* base, int d, int W, int C) {
  SearchSmem s;
  unsigned char* p = base;
  s.W = W;
  s.q = reinterpret_cast<float*>(p);
  p += 16 * ((d + 3) / 4);
  s.keys = reinterpret_cast<unsigned long long*>(p);
  p += 8 * (W + C);
  s.bd0 = reinterpret_cast<float*>(p);
  p += 8 * W;
  s.bi0 = reinterpret_cast<int*>(p);
  p += 8 * W;
  s.cd = reinterpret_cast<float*>(p);
  p += 4 * C;
  s.ci = reinterpret_cast<int*>(p);
  p += 4 * C;
  s.bf0 = p;
  s.removed = p + 2 * W;
  return s;
}

// Empty beam buffers of W entries (before the block's first barrier).
__device__ __forceinline__ void clear_state(const SearchSmem& s, int W) {
  for (int i = threadIdx.x; i < W; i += kSearchThreads) {
    for (int b = 0; b < 2; ++b) {
      s.bd(b)[i] = INFINITY;
      s.bi(b)[i] = -1;
      s.bf(b)[i] = 0;
    }
    s.removed[i] = 0;
  }
}

// Loads query qi into shared memory and returns |q|^2 (every thread).
__device__ __forceinline__ float load_query(const SearchSmem& s, const float* Q, int qi, int d) {
  __shared__ float part[kSearchWarps];
  const float* src = Q + static_cast<long long>(qi) * d;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < d; i += kSearchThreads) {
    const float v = src[i];
    s.q[i] = v;
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kSearchWarps; ++w) total += part[w];
  return total;
}

// Distances of the candidates ci[0, m) (+inf for an id < 0 and for NaN),
// a warp a row, into cd.
template <bool kBf16>
__device__ __forceinline__ void candidate_distances(const SearchSmem& s, const void* X, int d,
                                                    bool vec, int metric, float qsq, int m) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < m; j += kSearchWarps) {
    const int id = s.ci[j];
    float dist = INFINITY;
    if (id >= 0) {
      const float2 gs = row_dot<kBf16>(row_ptr<kBf16>(X, id, d), s.q, d, vec, lane);
      dist = pynnd::gram_distance(metric, gs.x, qsq, gs.y);
      if (isnan(dist)) dist = INFINITY;
    }
    if (lane == 0) s.cd[j] = dist;
  }
}

// d_k + epsilon (d_k - min_distance), each operation rounded as torch does
__device__ __forceinline__ float search_bound(float dk, float epsilon, float min_distance) {
  return __fadd_rn(dk, __fmul_rn(epsilon, __fsub_rn(dk, min_distance)));
}

// What a step's merge needs to keep the entries its bound admits.
struct Grow {
  int base;  // the least length, the seed's width
  int cap;  // the most
  int k;
  float epsilon, min_distance;
};

// Merges the candidates (cd, ci)[0, m) into beam buffer cur, whose first
// len entries are the beam, and returns the buffer that holds the result
// (ops/neighbors.py::merge_candidates). Three passes, each ended by a
// barrier: the candidates (dropped when invalid, beaten by an incumbent or
// an earlier candidate of their id, or worse than the last entry of a full
// beam and, kGrow, not under the bound; an incumbent they beat is marked
// removed), the incumbents, then every kept entry's rank among the kept
// entries by (distance, id), which is its place if under the result's room:
// len without kGrow; with it min(g.cap, len + m), and a fourth pass cuts
// the result to its entries under the new bound, at least g.base of them
// (models/search.py::_keep_admitted). The result is sorted; len is set to
// its length.
template <bool kGrow>
__device__ __forceinline__ int merge_beam(const SearchSmem& s, int cur, int& len, int m,
                                          bool signed_zero, const Grow& g) {
  const int nxt = cur ^ 1;
  const float* bd = s.bd(cur);
  const int* bi = s.bi(cur);
  const unsigned char* bf = s.bf(cur);
  const int W = len;
  const int room = kGrow ? min(g.cap, W + m) : W;
  const bool full = bi[W - 1] >= 0;
  const float worst = bd[W - 1];
  const float bound = kGrow ? search_bound(bd[g.k - 1], g.epsilon, g.min_distance) : 0.0f;
  for (int j = threadIdx.x; j < m; j += kSearchThreads) {
    const int id = s.ci[j];
    const float dj = s.cd[j];
    bool keep = id >= 0 && dj != INFINITY && !(full && dj > worst && !(kGrow && dj < bound));
    if (keep) {
      bool beaten = false;
#pragma unroll 4
      for (int i = 0; i < W; ++i) {
        if (bi[i] == id) {
          if (bd[i] <= dj) beaten = true;
          else s.removed[i] = 1;
        }
      }
#pragma unroll 4
      for (int j2 = 0; j2 < m; ++j2) {
        const float d2 = s.cd[j2];
        beaten |= j2 != j && s.ci[j2] == id && (d2 < dj || (d2 == dj && j2 < j));
      }
      keep = !beaten;
    }
    s.keys[W + j] = keep ? entry_key(dj, id, signed_zero) : kNoKey;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < room; i += kSearchThreads) {
    if (i < W) {
      s.keys[i] = bi[i] >= 0 && !s.removed[i] ? entry_key(bd[i], bi[i], signed_zero) : kNoKey;
      s.removed[i] = 0;
    }
    s.bd(nxt)[i] = INFINITY;
    s.bi(nxt)[i] = -1;
    s.bf(nxt)[i] = 0;
  }
  __syncthreads();
  const int total = W + m;
  for (int x = threadIdx.x; x < total; x += kSearchThreads) {
    const unsigned long long kx = s.keys[x];
    if (kx == kNoKey) continue;
    int rank = 0;
#pragma unroll 8
    for (int y = 0; y < total; ++y) rank += s.keys[y] < kx;
    if (rank >= room) continue;
    float d = x < W ? bd[x] : s.cd[x - W];
    int id = x < W ? bi[x] : s.ci[x - W];
    if (isinf(d)) id = -1;  // as merge_candidates leaves a -inf distance
    s.bd(nxt)[rank] = d;
    s.bi(nxt)[rank] = id;
    s.bf(nxt)[rank] = (x < W ? bf[x] : 1) && id >= 0;
  }
  __syncthreads();
  if (kGrow) {
    // the sorted result's entries under its bound, counted a stride at a time
    const float* nd = s.bd(nxt);
    const float nb = search_bound(nd[g.k - 1], g.epsilon, g.min_distance);
    int under = 0;
    for (int i0 = 0; i0 < room; i0 += kSearchThreads) {
      const int i = i0 + threadIdx.x;
      under += __syncthreads_count(i < room && nd[i] < nb);
    }
    len = max(g.base, under);
    // entries past the new length are gone; the next merge clears them as
    // it writes this buffer again
  }
  return nxt;
}

template <bool kBf16>
__global__ void __launch_bounds__(kSearchThreads, kSearchBlocksPerSm)
search_seed_kernel(const void* __restrict__ X, int d, int vec, const float* __restrict__ Q,
                   const long long* __restrict__ a_pt, const long long* __restrict__ b_pt,
                   const long long* __restrict__ child, const long long* __restrict__ leaf_lo,
                   const long long* __restrict__ leaf_hi,
                   const long long* __restrict__ tree_order, const float* __restrict__ norms,
                   const float* __restrict__ hyper, const float* __restrict__ offset,
                   int hyper_vec, const long long* __restrict__ coins, int depth,
                   const int* __restrict__ rand_ids, int n_rand, int W, int metric,
                   int signed_zero, int* __restrict__ out_idx, float* __restrict__ out_dist,
                   unsigned char* __restrict__ out_flag) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float score[2];
  const SearchSmem s = carve(smem_raw, d, W, kSeedChunk);
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  clear_state(s, W);
  const float qsq = load_query(s, Q, qi, d);  // ends in a barrier

  long long lo = 0, hi = 0;
  if (child != nullptr) {
    long long node = 0;
    const long long coin_bits = coins[qi];
    for (int level = 0; level < depth; ++level) {
      const long long c0 = child[2 * node], c1 = child[2 * node + 1];
      if (c0 == node && c1 == node) break;
      if (hyper != nullptr) {
        if (warp == 0) {
          const float2 gs = row_dot<false>(hyper + node * d, s.q, d, hyper_vec, lane);
          if (lane == 0) score[0] = gs.x - offset[node];
        }
      } else if (warp < 2) {
        const long long a = warp == 0 ? a_pt[node] : b_pt[node];
        const float2 gs = row_dot<kBf16>(row_ptr<kBf16>(X, a, d), s.q, d, vec, lane);
        if (lane == 0) score[warp] = norms != nullptr ? gs.x / fmaxf(norms[a], 1e-8f)
                                                      : gs.x - 0.5f * gs.y;
      }
      __syncthreads();
      const float margin = hyper != nullptr ? score[0] : score[0] - score[1];
      __syncthreads();
      const int coin = static_cast<int>((coin_bits >> (level % 32)) & 1);
      const int side = margin > 0.0f ? 1 : (margin < 0.0f ? 0 : coin);
      node = side ? c1 : c0;
    }
    lo = leaf_lo[node];
    hi = leaf_hi[node];
  }

  const long long n_leaf = hi > lo ? hi - lo : 0;
  const long long total = n_leaf + n_rand;
  int cur = 0;
  for (long long base = 0; base < total; base += kSeedChunk) {
    const int m = static_cast<int>(total - base < kSeedChunk ? total - base : kSeedChunk);
    for (int j = threadIdx.x; j < m; j += kSearchThreads) {
      const long long p = base + j;
      s.ci[j] = p < n_leaf ? static_cast<int>(tree_order[lo + p])
                           : rand_ids[static_cast<long long>(qi) * n_rand + (p - n_leaf)];
    }
    __syncthreads();
    candidate_distances<kBf16>(s, X, d, vec, metric, qsq, m);
    __syncthreads();
    int len = W;
    cur = merge_beam<false>(s, cur, len, m, signed_zero, Grow{});
  }
  const long long o = static_cast<long long>(qi) * W;
  for (int i = threadIdx.x; i < W; i += kSearchThreads) {
    out_idx[o + i] = s.bi(cur)[i];
    out_dist[o + i] = s.bd(cur)[i];
    out_flag[o + i] = s.bf(cur)[i];
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kSearchThreads, kSearchBlocksPerSm)
beam_search_kernel(const void* __restrict__ X, int d, int vec, const float* __restrict__ Q,
                   const int* __restrict__ adj, int deg, const int* __restrict__ seed_idx,
                   const float* __restrict__ seed_dist,
                   const unsigned char* __restrict__ seed_flag, int W, int cap, int k,
                   float epsilon, float min_distance, int max_steps, int E, int metric,
                   int* __restrict__ out_idx, float* __restrict__ out_dist,
                   int* __restrict__ out_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sel_id[kMaxExpand], sel_pos[kMaxExpand];
  const int m = E * deg;
  const SearchSmem s = carve(smem_raw, d, cap, m);
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long o = static_cast<long long>(qi) * W;
  const Grow grow{W, cap, k, epsilon, min_distance};
  clear_state(s, cap);
  for (int i = threadIdx.x; i < W; i += kSearchThreads) {
    s.bd(0)[i] = seed_dist[o + i];
    s.bi(0)[i] = seed_idx[o + i];
    s.bf(0)[i] = seed_flag[o + i];
  }
  const float qsq = load_query(s, Q, qi, d);  // ends in a barrier

  int cur = 0, steps = 0, len = W;
  while (steps < max_steps) {
    const float* bd = s.bd(cur);
    const float bound = search_bound(bd[k - 1], epsilon, min_distance);
    int active = 0;
    for (int i = threadIdx.x; i < len; i += kSearchThreads) {
      active |= s.bf(cur)[i] && bd[i] < bound;
    }
    if (!__syncthreads_or(active)) break;
    if (warp == 0) {
      // the E smallest of (flag ? distance : +inf) by (value, position):
      // take_smallest's order for E > 1, argmin's (-0.0 == +0.0) for E == 1.
      // A lane holds positions lane + 32 t; a round takes the warp's least
      // key, then the least position holding it.
      uint32_t taken = 0;
      for (int e = 0; e < E; ++e) {
        uint32_t key = 0xffffffffu, at = 0xffffffffu;
        for (int t = 0, i = lane; i < len; ++t, i += 32) {
          if ((taken >> t) & 1u) continue;
          const uint32_t ki = order_key(s.bf(cur)[i] ? bd[i] : INFINITY, E > 1);
          if (ki < key) {
            key = ki;
            at = static_cast<uint32_t>(i);
          }
        }
        const uint32_t least = __reduce_min_sync(0xffffffffu, key);
        const int p = static_cast<int>(
            __reduce_min_sync(0xffffffffu, key == least ? at : 0xffffffffu));
        if ((p & 31) == lane) taken |= 1u << (p >> 5);
        if (lane == 0) sel_pos[e] = p;
      }
      __syncwarp();
      for (int e = lane; e < E; e += 32) {
        const int p = sel_pos[e];
        const bool expand = s.bf(cur)[p] && bd[p] < bound;
        sel_id[e] = expand ? s.bi(cur)[p] : -1;
        if (expand) s.bf(cur)[p] = 0;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += kSearchThreads) {
      const int v = sel_id[j / deg];
      s.ci[j] = v >= 0 ? adj[static_cast<long long>(v) * deg + j % deg] : -1;
    }
    __syncthreads();
    candidate_distances<kBf16>(s, X, d, vec, metric, qsq, m);
    __syncthreads();
    cur = merge_beam<true>(s, cur, len, m, false, grow);
    ++steps;
  }
  const long long ok = static_cast<long long>(qi) * k;
  for (int i = threadIdx.x; i < k; i += kSearchThreads) {
    out_idx[ok + i] = s.bi(cur)[i];
    out_dist[ok + i] = s.bd(cur)[i];
  }
  if (threadIdx.x == 0) out_steps[qi] = steps;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// dynamic shared memory above 48 KB has to be allowed, once per device
cudaError_t allow_smem(int* done_device, const void* k_f32, const void* k_bf16) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == *done_device) return err;
  err = cudaFuncSetAttribute(k_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
  if (err == cudaSuccess) *done_device = device;
  return err;
}

}  // namespace

extern "C" int pynnd_search_seed(const void* X, int is_bf16, int n, int d, const void* Q, int q,
                                 const void* a_pt, const void* b_pt, const void* child,
                                 const void* leaf_lo, const void* leaf_hi, const void* tree_order,
                                 const void* norms, const void* hyper, const void* offset,
                                 const void* coins, int depth, const void* rand_ids, int n_rand,
                                 int W, int metric, int signed_zero, void* out_idx,
                                 void* out_dist, void* out_flag, void* stream) {
  using namespace pynnd;
  const int smem = search_smem_bytes(d, W, kSeedChunk);
  if (metric < 0 || metric >= kNumMetrics || d < 1 || n < 1 || q < 0 || n_rand < 0 || W < 1 ||
      W > kMaxBeam || smem > kMaxDynamicSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int done_device = -1;
  cudaError_t err =
      allow_smem(&done_device, reinterpret_cast<const void*>(search_seed_kernel<false>),
                 reinterpret_cast<const void*>(search_seed_kernel<true>));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q == 0) return static_cast<int>(cudaGetLastError());
  const int vec = d % (is_bf16 ? 8 : 4) == 0 && aligned16(X);
  const int hyper_vec = d % 4 == 0 && aligned16(hyper);
  auto launch = [&](auto kernel) {
    kernel<<<q, kSearchThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        X, d, vec, static_cast<const float*>(Q), static_cast<const long long*>(a_pt),
        static_cast<const long long*>(b_pt), static_cast<const long long*>(child),
        static_cast<const long long*>(leaf_lo), static_cast<const long long*>(leaf_hi),
        static_cast<const long long*>(tree_order), static_cast<const float*>(norms),
        static_cast<const float*>(hyper), static_cast<const float*>(offset), hyper_vec,
        static_cast<const long long*>(coins), depth, static_cast<const int*>(rand_ids), n_rand,
        W, metric, signed_zero, static_cast<int*>(out_idx), static_cast<float*>(out_dist),
        static_cast<unsigned char*>(out_flag));
  };
  if (is_bf16) launch(search_seed_kernel<true>);
  else launch(search_seed_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pynnd_beam_search(const void* X, int is_bf16, int n, int d, const void* Q, int q,
                                 const void* adj, int deg, const void* seed_idx,
                                 const void* seed_dist, const void* seed_flag, int W, int cap,
                                 int k, float epsilon, float min_distance, int max_steps, int E,
                                 int metric, void* out_idx, void* out_dist, void* out_steps,
                                 void* stream) {
  using namespace pynnd;
  const int smem = search_smem_bytes(d, cap, E * deg);
  if (metric < 0 || metric >= kNumMetrics || d < 1 || n < 1 || q < 0 || W < 1 || cap < W ||
      cap > kMaxBeam ||
      k < 1 || k > W || E < 1 || E > kMaxExpand || E > W || deg < 1 || E * deg > kMaxCand ||
      smem > kMaxDynamicSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int done_device = -1;
  cudaError_t err =
      allow_smem(&done_device, reinterpret_cast<const void*>(beam_search_kernel<false>),
                 reinterpret_cast<const void*>(beam_search_kernel<true>));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (q == 0) return static_cast<int>(cudaGetLastError());
  const int vec = d % (is_bf16 ? 8 : 4) == 0 && aligned16(X);
  auto launch = [&](auto kernel) {
    kernel<<<q, kSearchThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        X, d, vec, static_cast<const float*>(Q), static_cast<const int*>(adj), deg,
        static_cast<const int*>(seed_idx), static_cast<const float*>(seed_dist),
        static_cast<const unsigned char*>(seed_flag), W, cap, k, epsilon, min_distance,
        max_steps, E, metric, static_cast<int*>(out_idx), static_cast<float*>(out_dist),
        static_cast<int*>(out_steps));
  };
  if (is_bf16) launch(beam_search_kernel<true>);
  else launch(beam_search_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}
