// Exact per-row top-m inside contiguous win-row windows of tree-ordered data
// (the locality sweep of NN-descent).
//
// Replaces the TPU kernel pynndescent_tpu/ops/pallas_init.py::window_topm
// (_window_topm_kernel). Input X_t [n, d] fp32 or bf16 in one tree's leaf
// order. `offset` zero-pad rows are conceptually prepended, so window w
// covers padded positions [w*win, (w+1)*win) and padded position P is data
// row P - offset. Output ids [n, m] (int32 data rows, -1 when missing) and
// dists [n, m] fp32 (+inf when missing), ascending, ties to the lowest
// column; self pairs and pad rows are masked. bf16 input is read as bf16 and
// computed in fp32. Masks are index arithmetic: no padded copy of X.
//
// What bounds it on the H100: the fp32 FMA pipes, not device memory. Every
// gram metric is symmetric, so a window needs win (win - 1) / 2 dot products
// of d FMAs on win * d inputs. One sweep of 1M x 128 rows at win 1024 is
// then 1.31e11 FLOP: 1.95 ms at the 67 TFLOP/s of the fp32 pipes, against
// 0.23 ms for X_t read once and both [n, m] outputs written once at
// 3.35 TB/s. This design does not use the symmetry: each block computes the
// full width of its rows, every pair from both sides, 2.62e11 FLOP or 3.9 ms
// of the pipes. (The product has to stay fp32: the gram form
// |x|^2 + |y|^2 - 2<x, y> cancels. Split-fp32 tensor-core tiles would do
// three TF32 products of the full squares, 1.6 ms at 495 TFLOP/s; this file
// does not use tensor cores.)
//
// Two kernels serve the wrapper, which states the dispatch rule:
//
// window_topm_tiled_kernel: m <= 32 and win a multiple of 128 (the NN-descent
// sweep: win 256..1024, m 32). A block of 256 threads takes one window and
// 128 of its rows against the window's column tiles of 128.
// * Squared norms come from row_sqnorm_kernel, a pre-pass of one warp a row
//   (16-byte loads, fp32 sums); the main kernel reads them and sums none.
// * The product is register-tiled: a thread owns an 8 x 8 accumulator tile.
//   Both operands lie in shared memory feature-major ([k][row], transposed
//   while staging; the row stride of 132 floats keeps the transposing stores
//   and the 16-byte reads free of bank conflicts), so one feature costs a
//   thread four 16-byte shared loads for 64 FMAs.
// * Staging is double-buffered: the next 8-feature chunk of both operands
//   is fetched from global memory into registers (16-byte __ldg; scalar loads
//   when d is not a multiple of 4 or the base is not aligned, so any d
//   works) before the FMAs of the current chunk and stored transposed after
//   them; one __syncthreads() a chunk. The query rows are re-read from L2
//   for each column tile: at 8 tiles a window that is 1 MB of L2 reads a
//   block and keeps one code path for every d.
// * A warp owns 16 whole rows of the tile (lanes 0-15 hold one row's 128
//   columns, lanes 16-31 another's), so selection needs no block barrier and
//   the distance tile never goes through shared memory. Each row's sorted
//   list of 32 lives in shared memory, one entry a lane. A thread turns its
//   accumulators into distances in place and tests them against the row's
//   m-th best; rows with no survivor cost one ballot. Survivors are merged
//   by the warp: a few by ballot-and-shift insertion, many by a bitonic sort
//   of the batch of 32 and a bitonic merge with the list. The first tile
//   finds the lists empty: its 128 candidates a row go through four bitonic
//   sorts side by side (four independent chains of shuffles) and three
//   merges, with no test.
// * Everything is ordered by the key (distance, column), so the result does
//   not depend on the order of arrival: ties keep the lowest column, two
//   launches give the same bits, and a block may visit its own column tile
//   first, where tree-ordered data has most of a row's neighbours, and the
//   others by their distance from it, so that the thresholds are tight early.
// * 51,200 bytes of shared memory and 128 registers a thread put two blocks
//   (16 warps) on an SM.
// * What is left above the bound: a thread loads 64 bytes from shared memory
//   for the 64 FMAs of a feature, which is all the 128 bytes a clock an SM's
//   shared memory returns at the FMA pipes' full rate, and on this card the
//   two add up instead of overlapping (scripts/probe_window_topm.py: each of
//   the four loads costs as much time as a quarter of the FMAs). Only a
//   larger accumulator tile, or the tensor cores, load less for each FMA.
//
// window_topm_general_kernel: every other legal shape (m up to win - 1, win a
// multiple of 64). One window and 64 rows a block, 64 columns at a time,
// 4 x 8 accumulators a thread, squared norms summed from the staged chunks,
// one thread a row inserting into a sorted list in shared memory with a
// strict-less test while columns arrive ascending.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "gram_metrics.cuh"

namespace pynnd {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four consecutive features from an address aligned to the four of them
__device__ __forceinline__ float4 load4_aligned(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4_aligned(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
bool vector_loads_ok(const void* X, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(X) % (4 * sizeof(T)) == 0;
}

// ---------------------------------------------------------------------------
// squared row norms (pre-pass of the tiled kernel)
// ---------------------------------------------------------------------------

constexpr int kNormThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
row_sqnorm_kernel(const T* __restrict__ X, int n, int d, int vec, float* __restrict__ sq) {
  const long long row = (long long)blockIdx.x * (kNormThreads / 32) + threadIdx.x / 32;
  if (row >= n) return;  // the whole warp
  const int lane = threadIdx.x % 32;
  const T* x = X + row * d;
  float s = 0.0f;
  if (vec) {
    for (int k = 4 * lane; k < d; k += 128) {
      const float4 v = load4_aligned(x + k);
      s = fmaf(v.x, v.x, s);
      s = fmaf(v.y, v.y, s);
      s = fmaf(v.z, v.z, s);
      s = fmaf(v.w, v.w, s);
    }
  } else {
    for (int k = lane; k < d; k += 32) {
      const float v = to_f32(x[k]);
      s = fmaf(v, v, s);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  if (lane == 0) sq[row] = s;
}

template <typename T>
int launch_sqnorms(const void* X, int n, int d, void* sq, cudaStream_t stream) {
  const int rows_per_block = kNormThreads / 32;
  const unsigned blocks = (unsigned)(((long long)n + rows_per_block - 1) / rows_per_block);
  row_sqnorm_kernel<T><<<blocks, kNormThreads, 0, stream>>>(
      (const T*)X, n, d, (int)vector_loads_ok<T>(X, d), (float*)sq);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tiled kernel: m <= 32, win a multiple of 128
// ---------------------------------------------------------------------------

// Timing probes of scripts/probe_window_topm.py. Probe 1 leaves out the
// selection and probe 2 the distances as well; PROBE_LDS 1 and 2 leave out
// one of the four shared loads of a feature (wrong results, for timing the
// parts alone).
#ifndef PYNND_WINDOW_PROBE
#define PYNND_WINDOW_PROBE 0
#endif
#ifndef PYNND_WINDOW_PROBE_LDS
#define PYNND_WINDOW_PROBE_LDS 0
#endif
#ifdef PYNND_WINDOW_STATS  // counts what the selection meets after a block's first tile (slow)
__device__ unsigned long long g_window_stats[7];
#define PYNND_STAT(i, v) \
  do { if (lane == 0) atomicAdd(&g_window_stats[i], (unsigned long long)(v)); } while (0)
#else
#define PYNND_STAT(i, v)
#endif

constexpr int kTile = 128;            // rows of a block, and columns of a column tile
constexpr int kBK = 8;                // features of a staged chunk: one 16-byte load a thread
constexpr int kLd = kTile + 4;        // row stride of a staged chunk, in floats
constexpr int kTiledThreads = 256;
constexpr int kList = 32;             // entries of a row's list, one a lane
// survivors of a batch up to which they are inserted one at a time
constexpr int kInsertMax = 8;

__device__ __forceinline__ bool key_less(float da, int ca, float db, int cb) {
  return da < db || (da == db && ca < cb);
}

// One compare-exchange stage of a bitonic network over the 32 lanes: every
// lane meets lane ^ j and keeps the smaller key of the two, or the larger.
__device__ __forceinline__ void warp_compare_exchange(float& d, int& c, int j, bool keep_min) {
  const float od = __shfl_xor_sync(kFullMask, d, j);
  const int oc = __shfl_xor_sync(kFullMask, c, j);
  if (key_less(od, oc, d, c) == keep_min) {
    d = od;
    c = oc;
  }
}

// Merge a batch of one candidate a lane (absent: +inf, INT_MAX) into the
// ascending list (ld, lc): sort the batch descending, take the lane-wise
// minimum with the list (a bitonic sequence that holds the 32 smallest of
// both), and sort that ascending.
__device__ __forceinline__ void warp_merge_batch(float& ld, int& lc, float cd, int cc, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      warp_compare_exchange(cd, cc, j, ((lane & j) == 0) != ((lane & k) == 0));
    }
  }
  if (key_less(cd, cc, ld, lc)) {
    ld = cd;
    lc = cc;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) warp_compare_exchange(ld, lc, j, (lane & j) == 0);
}

// The 32 smallest of four batches of one candidate a lane, ascending, when
// the list is still empty: four bitonic sorts side by side (independent
// chains of shuffles that hide each other's latency), then three merges.
__device__ __forceinline__ void warp_top_of_four(float& ld, int& lc, float (&cd)[4], int (&cc)[4],
                                                 int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool up = ((lane & j) == 0) == ((lane & k) == 0);  // batches 0, 2 ascending
#pragma unroll
      for (int b = 0; b < 4; ++b) warp_compare_exchange(cd[b], cc[b], j, up != ((b & 1) != 0));
    }
  }
#pragma unroll
  for (int b = 0; b < 4; b += 2) {
    if (key_less(cd[b + 1], cc[b + 1], cd[b], cc[b])) {
      cd[b] = cd[b + 1];
      cc[b] = cc[b + 1];
    }
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {  // batch 0 ascending, batch 2 descending
    warp_compare_exchange(cd[0], cc[0], j, (lane & j) == 0);
    warp_compare_exchange(cd[2], cc[2], j, (lane & j) != 0);
  }
  const bool second = key_less(cd[2], cc[2], cd[0], cc[0]);
  ld = second ? cd[2] : cd[0];
  lc = second ? cc[2] : cc[0];
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) warp_compare_exchange(ld, lc, j, (lane & j) == 0);
}

// Insert the candidates of the lanes in `mask` one at a time: the position is
// the count of list entries below the new key, later entries shift up a lane.
__device__ __forceinline__ void warp_insert_each(float& ld, int& lc, float cd, int cc,
                                                 unsigned mask, int lane) {
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float nd = __shfl_sync(kFullMask, cd, src);
    const int nc = __shfl_sync(kFullMask, cc, src);
    const int pos = __popc(__ballot_sync(kFullMask, key_less(ld, lc, nd, nc)));
    const float ud = __shfl_up_sync(kFullMask, ld, 1);
    const int uc = __shfl_up_sync(kFullMask, lc, 1);
    if (lane == pos) {
      ld = nd;
      lc = nc;
    } else if (lane > pos) {
      ld = ud;
      lc = uc;
    }
  }
}

// The geometry of a thread's 8 x 8 accumulator tile. Rows: two groups of
// four, 64 apart; a warp owns rows [8 warp, 8 warp + 8) of each group, its
// lower half-warp (hx = 0) the first four of them. Columns: two groups of
// four, 64 apart, four a lane of the half-warp (tx).
__device__ __forceinline__ int tile_row(int i, int warp, int hx) {
  return (i >> 2) * 64 + warp * 8 + hx * 4 + (i & 3);
}
__device__ __forceinline__ int tile_col(int j, int tx) { return (j >> 2) * 64 + tx * 4 + (j & 3); }

// Accumulators -> masked distances, in place. rsq and csq hold the squared
// norms of the block's rows and of the tile's columns, +inf for a row or a
// column outside the data (the padded front, rows past n).
template <bool kSqeuclid>
__device__ __forceinline__ void tile_distances(float (&acc)[8][8], const float* rsq_s,
                                               const float* csq_s, int metric, bool own_tile,
                                               int warp, int hx, int tx) {
  const float4 r0 = *reinterpret_cast<const float4*>(rsq_s + warp * 8 + hx * 4);
  const float4 r1 = *reinterpret_cast<const float4*>(rsq_s + 64 + warp * 8 + hx * 4);
  const float4 q0 = *reinterpret_cast<const float4*>(csq_s + tx * 4);
  const float4 q1 = *reinterpret_cast<const float4*>(csq_s + 64 + tx * 4);
  const float rsq[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  const float csq[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kSqeuclid) {  // +inf norms give +inf
        acc[i][j] = fmaxf(rsq[i] + csq[j] - 2.0f * acc[i][j], 0.0f);
      } else {
        const bool outside = rsq[i] == INFINITY || csq[j] == INFINITY;
        acc[i][j] = outside ? INFINITY : gram_distance(metric, acc[i][j], rsq[i], csq[j]);
      }
    }
  }
  if (own_tile) {  // self pairs
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (tile_row(i, warp, hx) == tile_col(j, tx)) acc[i][j] = INFINITY;
  }
}

// Selection for one accumulator row of every thread (its eight distances
// e0..e7), i.e. two rows of the warp, one a half-warp: the whole warp serves
// one row after the other. row0 is the tile row of the lower half-warp, the
// upper one's is four further. `first`: the lists are still empty (the whole
// block), so the row's 128 candidates are sorted and nothing is tested.
__device__ __forceinline__ void select_rows(float e0, float e1, float e2, float e3, float e4,
                                            float e5, float e6, float e7, float* topd, int* topi,
                                            int m, int c0, int row0, int lane, bool first) {
  const int hx = lane >> 4;
  const int tx = lane & 15;
  if (first) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int src = 16 * h + tx;
      const float v[8] = {__shfl_sync(kFullMask, e0, src), __shfl_sync(kFullMask, e1, src),
                          __shfl_sync(kFullMask, e2, src), __shfl_sync(kFullMask, e3, src),
                          __shfl_sync(kFullMask, e4, src), __shfl_sync(kFullMask, e5, src),
                          __shfl_sync(kFullMask, e6, src), __shfl_sync(kFullMask, e7, src)};
      float cd[4];
      int cc[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        cd[b] = hx ? v[2 * b + 1] : v[2 * b];
        cc[b] = cd[b] < INFINITY ? c0 + tile_col(2 * b + hx, tx) : INT_MAX;
      }
      float ld;
      int lc;
      warp_top_of_four(ld, lc, cd, cc, lane);
      const int row = row0 + 4 * h;
      topd[row * kList + lane] = ld;
      topi[row * kList + lane] = lc;
    }
    __syncwarp();
    return;
  }
  const float worst = topd[(row0 + 4 * hx) * kList + m - 1];
  const bool any = fminf(fminf(fminf(e0, e1), fminf(e2, e3)), fminf(fminf(e4, e5), fminf(e6, e7))) <=
                   worst;
  const unsigned halves = __ballot_sync(kFullMask, any);
  PYNND_STAT(0, 1);
  PYNND_STAT(1, halves == 0);
  if (halves == 0) return;  // the whole warp; nothing was written
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    if (((halves >> (16 * h)) & 0xffffu) == 0) continue;  // the whole warp
    const int row = row0 + 4 * h;
    PYNND_STAT(2, 1);
    float ld = topd[row * kList + lane];
    int lc = topi[row * kList + lane];
    float td = __shfl_sync(kFullMask, ld, m - 1);
    int tc = __shfl_sync(kFullMask, lc, m - 1);
    const int src = 16 * h + tx;
    // the row's 128 columns in four batches of 32: lanes 0-15 take column
    // slot 2b of the owning half-warp's lanes, lanes 16-31 slot 2b + 1
#pragma unroll 1
    for (int b = 0; b < 4; ++b) {
      const float s0 = b == 0 ? e0 : b == 1 ? e2 : b == 2 ? e4 : e6;
      const float s1 = b == 0 ? e1 : b == 1 ? e3 : b == 2 ? e5 : e7;
      const float v0 = __shfl_sync(kFullMask, s0, src);
      const float v1 = __shfl_sync(kFullMask, s1, src);
      float cd = hx ? v1 : v0;
      int cc = c0 + tile_col(2 * b + hx, tx);
      const bool survives = cd < INFINITY && key_less(cd, cc, td, tc);
      const unsigned mask = __ballot_sync(kFullMask, survives);
      PYNND_STAT(3, 1);
      PYNND_STAT(4, mask == 0);
      PYNND_STAT(5, __popc(mask));
      PYNND_STAT(6, __popc(mask) > kInsertMax);
      if (mask == 0) continue;
      if (__popc(mask) <= kInsertMax) {
        warp_insert_each(ld, lc, cd, cc, mask, lane);
      } else {
        if (!survives) {
          cd = INFINITY;
          cc = INT_MAX;
        }
        warp_merge_batch(ld, lc, cd, cc, lane);
      }
      td = __shfl_sync(kFullMask, ld, m - 1);
      tc = __shfl_sync(kFullMask, lc, m - 1);
    }
    topd[row * kList + lane] = ld;
    topi[row * kList + lane] = lc;
  }
  __syncwarp();
}

// The order in which a block visits the window's column tiles: its own tile
// first, where tree-ordered data has most of a row's neighbours, then the
// others by their distance from it, so that the lists' thresholds are tight
// early. The result does not depend on the order.
struct TileWalk {
  int own, lo, hi, n_tiles;
  __device__ TileWalk(int own_tile, int tiles)
      : own(own_tile), lo(own_tile - 1), hi(own_tile + 1), n_tiles(tiles) {}
  __device__ int next() {
    if (hi < n_tiles && (lo < 0 || hi - own <= own - lo)) return hi++;
    return lo--;
  }
};

// features [k, k + 4) of a data row, zeros outside the row or the data
template <typename T>
__device__ __forceinline__ float4 fetch4(const T* __restrict__ X, long long row, int n, int d,
                                         int k, int vec) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row < 0 || row >= n || k >= d) return v;
  const T* p = X + row * d + k;
  if (vec) return load4_aligned(p);
  v.x = to_f32(p[0]);
  if (k + 1 < d) v.y = to_f32(p[1]);
  if (k + 2 < d) v.z = to_f32(p[2]);
  if (k + 3 < d) v.w = to_f32(p[3]);
  return v;
}

// transposing store of four features of one row into a [k][row] chunk
__device__ __forceinline__ void stage4(float* chunk, int k, int row, float4 v) {
  chunk[(k + 0) * kLd + row] = v.x;
  chunk[(k + 1) * kLd + row] = v.y;
  chunk[(k + 2) * kLd + row] = v.z;
  chunk[(k + 3) * kLd + row] = v.w;
}

__device__ __forceinline__ float norm_or_inf(const float* __restrict__ sq, long long row, int n) {
  return row >= 0 && row < n ? __ldg(sq + row) : INFINITY;
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads, 2)
window_topm_tiled_kernel(const T* __restrict__ X, const float* __restrict__ sq, int n, int d,
                         int win, int m, int off, int metric, int vec, int* __restrict__ ids,
                         float* __restrict__ dists) {
  extern __shared__ float4 tiled_smem[];
  float* As = reinterpret_cast<float*>(tiled_smem);  // [2][kBK][kLd] query rows, feature-major
  float* Bs = As + 2 * kBK * kLd;                    // [2][kBK][kLd] column rows, feature-major
  float* topd = Bs + 2 * kBK * kLd;                  // [kTile][kList]
  int* topi = reinterpret_cast<int*>(topd + kTile * kList);    // [kTile][kList], window columns
  float* rsq_s = reinterpret_cast<float*>(topi + kTile * kList);  // [kTile] norms of the rows
  float* csq_s = rsq_s + kTile;                      // [2][kTile] norms of a tile's columns

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hx = lane >> 4;
  const int tx = lane & 15;
  const long long ws = (long long)blockIdx.x * win;  // padded start of the window
  const int r0 = blockIdx.y * kTile;                 // first row within the window
  {
    const long long first = ws + r0 - off;  // data row of the block's first row
    if (first >= n || first + kTile <= 0) return;  // no row to write: the whole block
  }
  const int n_tiles = win / kTile;
  const int n_chunks = (d + kBK - 1) / kBK;

#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int row = (q >> 3) * 64 + warp * 8 + (q & 7);
    topd[row * kList + lane] = INFINITY;
    topi[row * kList + lane] = INT_MAX;
  }
  if (tid < kTile) rsq_s[tid] = norm_or_inf(sq, ws + r0 + tid - off, n);

  TileWalk walk(blockIdx.y, n_tiles);
  int tile = walk.own;
  int next_tile = n_tiles > 1 ? walk.next() : tile;

  // staging: a warp fills 16 rows x 8 features of a chunk with one 16-byte
  // load a thread
  const int srow = warp * 16 + tx;
  const int sk = hx * 4;
  const long long arow = ws + r0 + srow - off;
  long long brow = ws + tile * kTile + srow - off;
  float4 pa = fetch4(X, arow, n, d, sk, vec);
  float4 pb = fetch4(X, brow, n, d, sk, vec);
  stage4(As, sk, srow, pa);
  stage4(Bs, sk, srow, pb);
  __syncthreads();

  int buf = 0;
  for (int t = 0; t < n_tiles; ++t) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    // the tile's column norms travel with its first chunk
    float csq = 0.0f;
    if (tid < kTile) csq = norm_or_inf(sq, ws + tile * kTile + tid - off, n);

    for (int kc = 0; kc < n_chunks; ++kc) {
      const bool last_chunk = kc + 1 == n_chunks;
      const bool has_next = !last_chunk || t + 1 < n_tiles;  // the whole block
      if (has_next) {
        const int nkc = last_chunk ? 0 : kc + 1;
        if (last_chunk) brow = ws + next_tile * kTile + srow - off;
        pa = fetch4(X, arow, n, d, nkc * kBK + sk, vec);
        pb = fetch4(X, brow, n, d, nkc * kBK + sk, vec);
      }
      const float* a_s = As + buf * kBK * kLd + warp * 8 + hx * 4;
      const float* b_s = Bs + buf * kBK * kLd + tx * 4;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * kLd);
#if PYNND_WINDOW_PROBE_LDS == 1
        const float4 a1 = a0;
#else
        const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * kLd + 64);
#endif
        const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * kLd);
#if PYNND_WINDOW_PROBE_LDS == 2
        const float4 b1 = b0;
#else
        const float4 b1 = *reinterpret_cast<const float4*>(b_s + kk * kLd + 64);
#endif
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      if (has_next) {
        stage4(As + (buf ^ 1) * kBK * kLd, sk, srow, pa);
        stage4(Bs + (buf ^ 1) * kBK * kLd, sk, srow, pb);
      }
      if (kc == 0 && tid < kTile) csq_s[(t & 1) * kTile + tid] = csq;
      __syncthreads();
      buf ^= 1;
    }

    const int c0 = tile * kTile;
#if PYNND_WINDOW_PROBE < 2
    if (metric == kSqeuclidean) {
      tile_distances<true>(acc, rsq_s, csq_s + (t & 1) * kTile, metric, tile == (int)blockIdx.y, warp,
                           hx, tx);
    } else {
      tile_distances<false>(acc, rsq_s, csq_s + (t & 1) * kTile, metric, tile == (int)blockIdx.y, warp,
                            hx, tx);
    }
#endif
#if PYNND_WINDOW_PROBE == 0
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      select_rows(acc[i][0], acc[i][1], acc[i][2], acc[i][3], acc[i][4], acc[i][5], acc[i][6],
                  acc[i][7], topd, topi, m, c0, tile_row(i, warp, 0), lane, t == 0);
    }
#else
    {  // keep the product alive
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s += acc[i][j];
      if (s == 12345.678f) topd[lane] = s + (float)c0;
    }
#endif
    tile = next_tile;
    if (t + 2 < n_tiles) next_tile = walk.next();
  }

  if (lane < m) {
    for (int q = 0; q < 16; ++q) {
      const int row = (q >> 3) * 64 + warp * 8 + (q & 7);
      const long long g = ws + r0 + row - off;
      if (g < 0 || g >= n) continue;
      const float v = topd[row * kList + lane];
      dists[g * m + lane] = v;
      ids[g * m + lane] = v < INFINITY ? (int)(ws + topi[row * kList + lane] - off) : -1;
    }
  }
}

constexpr size_t kTiledSmemBytes = sizeof(float) * (4 * kBK * kLd + kTile * kList + 3 * kTile) +
                                   sizeof(int) * kTile * kList;

template <typename T>
int launch_tiled(const void* X, const void* sq, int n, int d, int win, int m, int off, int metric,
                 void* ids, void* dists, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(window_topm_tiled_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kTiledSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = ((long long)n + off + win - 1) / win;
  dim3 grid((unsigned)n_windows, (unsigned)(win / kTile));
  window_topm_tiled_kernel<T><<<grid, kTiledThreads, kTiledSmemBytes, stream>>>(
      (const T*)X, (const float*)sq, n, d, win, m, off, metric, (int)vector_loads_ok<T>(X, d),
      (int*)ids, (float*)dists);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// general kernel: any m < win, win a multiple of 64
// ---------------------------------------------------------------------------

constexpr int kRows = 64;
constexpr int kCols = 64;
constexpr int kWinDk = 32;
constexpr int kWinThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kWinThreads)
window_topm_general_kernel(const T* __restrict__ X, int n, int d, int win, int m, int off,
                           int metric, int* __restrict__ ids, float* __restrict__ dists) {
  extern __shared__ float smem[];
  float* qs = smem;                               // [kRows][kWinDk + 1]
  float* cs = qs + kRows * (kWinDk + 1);          // [kCols][kWinDk + 1]
  float* dt = cs + kCols * (kWinDk + 1);          // [kRows][kCols + 1]
  float* qsq = dt + kRows * (kCols + 1);          // [kRows]
  float* csq = qsq + kRows;                       // [kCols]
  float* topd = csq + kCols;                      // [kRows][m + 1]
  int* topi = (int*)(topd + kRows * (m + 1));     // [kRows][m + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const long long ws = (long long)blockIdx.x * win;  // padded start of the window
  const int r0 = blockIdx.y * kRows;                 // first row within the window
  const int ld = m + 1;

  if (tid < kRows) {
    for (int j = 0; j < m; ++j) {
      topd[tid * ld + j] = INFINITY;
      topi[tid * ld + j] = -1;
    }
  }

  for (int c0 = 0; c0 < win; c0 += kCols) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    float my_sq = 0.0f;  // tid < 64: column tid; else row tid - 64

    for (int k0 = 0; k0 < d; k0 += kWinDk) {
      for (int e = tid; e < kRows * kWinDk; e += kWinThreads) {
        const int r = e / kWinDk;
        const int c = e % kWinDk;
        const int gc = k0 + c;
        const long long qrow = ws + r0 + r - off;
        const long long crow = ws + c0 + r - off;
        qs[r * (kWinDk + 1) + c] =
            (qrow >= 0 && qrow < n && gc < d) ? to_f32(X[qrow * d + gc]) : 0.0f;
        cs[r * (kWinDk + 1) + c] =
            (crow >= 0 && crow < n && gc < d) ? to_f32(X[crow * d + gc]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kWinDk; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (kWinDk + 1) + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = cs[(tx + 8 * j) * (kWinDk + 1) + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      const float* own = tid < kCols ? cs + tid * (kWinDk + 1) : qs + (tid - kCols) * (kWinDk + 1);
      for (int kk = 0; kk < kWinDk; ++kk) my_sq = fmaf(own[kk], own[kk], my_sq);
      __syncthreads();
    }
    if (tid < kCols) {
      csq[tid] = my_sq;
    } else {
      qsq[tid - kCols] = my_sq;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const long long col_row = ws + c0 + c - off;  // data row of this column
        const bool masked = (r0 + r == c0 + c) || col_row < 0 || col_row >= n;
        dt[r * (kCols + 1) + c] =
            masked ? INFINITY : gram_distance(metric, acc[i][j], qsq[r], csq[c]);
      }
    }
    __syncthreads();

    if (tid < kRows) {
      float* td = topd + tid * ld;
      int* ti = topi + tid * ld;
      float worst = td[m - 1];
      for (int c = 0; c < kCols; ++c) {
        const float v = dt[tid * (kCols + 1) + c];
        if (v < worst) {
          int j = m - 1;
          while (j > 0 && td[j - 1] > v) {
            td[j] = td[j - 1];
            ti[j] = ti[j - 1];
            --j;
          }
          td[j] = v;
          ti[j] = c0 + c;
          worst = td[m - 1];
        }
      }
    }
    __syncthreads();
  }

  if (tid < kRows) {
    const long long row = ws + r0 + tid - off;
    if (row >= 0 && row < n) {
      for (int j = 0; j < m; ++j) {
        const float v = topd[tid * ld + j];
        const bool ok = v < INFINITY;
        dists[row * m + j] = v;
        ids[row * m + j] = ok ? (int)(ws + topi[tid * ld + j] - off) : -1;
      }
    }
  }
}

size_t general_smem_bytes(int m) {
  return sizeof(float) * ((kRows + kCols) * (kWinDk + 1) + kRows * (kCols + 1) + kRows + kCols) +
         (sizeof(float) + sizeof(int)) * kRows * (m + 1);
}

template <typename T>
int launch_general(const void* X, int n, int d, int win, int m, int off, int metric, void* ids,
                   void* dists, cudaStream_t stream) {
  const size_t smem = general_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(window_topm_general_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = ((long long)n + off + win - 1) / win;
  dim3 grid((unsigned)n_windows, (unsigned)(win / kRows));
  window_topm_general_kernel<T><<<grid, kWinThreads, smem, stream>>>(
      (const T*)X, n, d, win, m, off, metric, (int*)ids, (float*)dists);
  return (int)cudaGetLastError();
}

}  // namespace pynnd

// Squared norms of the rows of X [n, d] into sq [n] fp32.
extern "C" int pynnd_row_sqnorms(const void* X, int is_bf16, int n, int d, void* sq,
                                 void* stream) {
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pynnd::launch_sqnorms<__nv_bfloat16>(X, n, d, sq, s)
                 : pynnd::launch_sqnorms<float>(X, n, d, sq, s);
}

#ifdef PYNND_WINDOW_STATS
// the selection's counts since the last call, which sets them to zero
extern "C" int pynnd_window_stats(unsigned long long* out) {
  const unsigned long long zeros[7] = {0};
  cudaError_t err = cudaMemcpyFromSymbol(out, pynnd::g_window_stats, sizeof(zeros));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(pynnd::g_window_stats, zeros, sizeof(zeros));
  return (int)err;
}
#endif

// sq: the rows' squared norms (pynnd_row_sqnorms) selects the tiled kernel,
// which needs m <= 32 and win a multiple of 128; a null sq the general one.
extern "C" int pynnd_window_topm(const void* X, int is_bf16, int n, int d, int win, int m,
                                 int offset, int metric, const void* sq, void* ids, void* dists,
                                 void* stream) {
  if (win <= 0 || win % pynnd::kRows != 0 || m < 1 || m >= win || offset < 0 || offset >= win ||
      metric < 0 || metric >= pynnd::kNumMetrics) {
    return (int)cudaErrorInvalidValue;
  }
  if (sq != nullptr && (win % pynnd::kTile != 0 || m > pynnd::kList)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (sq != nullptr) {
    return is_bf16 ? pynnd::launch_tiled<__nv_bfloat16>(X, sq, n, d, win, m, offset, metric, ids,
                                                        dists, s)
                   : pynnd::launch_tiled<float>(X, sq, n, d, win, m, offset, metric, ids, dists, s);
  }
  return is_bf16
             ? pynnd::launch_general<__nv_bfloat16>(X, n, d, win, m, offset, metric, ids, dists, s)
             : pynnd::launch_general<float>(X, n, d, win, m, offset, metric, ids, dists, s);
}
