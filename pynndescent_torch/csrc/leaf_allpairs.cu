// Leaf all-pairs distances for the forest init of NN-descent.
//
// Replaces the TPU kernel pynndescent_tpu/ops/pallas_init.py::leaf_allpairs
// (_leaf_pairs_kernel, tile math _tile_distances). Input: data rows X_t
// [n, d] fp32 in one tree's leaf order, and the tree's compact leaf table
// (starts, sizes)[L], ascending, padded with (n, 0); every tree position
// lies in exactly one leaf. Output [n, 64] fp32: row p of a leaf gets its
// gram-form distances to the leaf's first 64 members, +inf past the leaf
// size, and a row past start + 64 of an oversized leaf is +inf throughout.
// The kernel writes every element of the output, once.
//
// What bounds it on the H100: the work that is needed is bound by bytes. A
// leaf of `size` rows needs size (size - 1) / 2 dot products (the distances
// are symmetric), d size (size - 1) FLOP, against size * d * 4 bytes read
// and size * 256 bytes written: at the forest's leaves of some 40 rows and
// d = 128 the FMAs are a third of the memory time. The full padded 64 x 64
// square, computed from both sides, would instead be bound by the fp32 pipes
// and the shared loads that feed them. So the design moves the bytes once,
// asynchronously, and computes only what the leaf has. What it reaches, and
// what the probe (scripts/probe_leaf_allpairs.py) shows in its way, is in
// PERF.md: with the bytes moving at the card's copy rate, the time that is
// left is the warps' own, spent on FMAs and 16-byte shared loads for few
// leaves at a time, since a block's two slabs leave room for three blocks an
// SM.
//
// Design:
// * persistent blocks, as many as are resident at once (three an SM at
//   d = 128), each walking over leaves l = blockIdx.x, + gridDim.x, ...: the
//   result of a leaf does not depend on which block takes it. A leaf's rows
//   are consecutive in X_t, so its slab is one contiguous run; it is copied
//   into shared memory with cp.async, only the rows the leaf has, 16 bytes a
//   copy where d is a multiple of 4 and X_t is 16-byte aligned, 4 bytes a
//   copy for any other shape. Two buffers: the next slab is in flight while
//   this leaf's FMAs and stores run. The warps that hold no micro tile of
//   the current leaf start the copies, so no FMA queues behind them.
// * up to 128 features a slab is resident whole; a wider d streams through
//   the same two buffers in chunks of 128 features, the accumulators staying
//   in registers (two buffers of 64 x 132 floats keep three blocks an SM).
// * a thread owns one 4 x 4 micro tile of the gram: rows {ti + T r} against
//   rows {tj + T c}, T = ceil(rows / 4), and only the T (T + 1) / 2 tiles
//   with ti <= tj exist. Rows are rounded up to 4, not to 64; the up to three
//   rows past the leaf's own are zero-filled. Each row is read as 16-byte
//   shared loads along the features; the row stride is 4 modulo 8 floats, so
//   threads on neighbouring rows hit distinct banks.
// * exact fp32 FMAs (no TF32: the cancellation form |x|^2 + |y|^2 - 2<x, y>
//   needs full fp32), one accumulator an entry, features ascending: two
//   launches give the same bits. Squared norms are the gram's diagonal, as on
//   the TPU.
// * gram_distance is symmetric bit for bit in its two norms (sums and
//   products of two floats commute), so each distance is computed once and
//   written to (i, j) and (j, i) of a 64 x 65 tile in shared memory (the
//   buffer whose slab was just consumed). The tile then leaves as whole
//   256-byte rows, 16 bytes a thread, with +inf past the leaf size; an
//   oversized leaf's rows past the 64th are written +inf as well.
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_metrics.cuh"

namespace pynnd {

constexpr int kCap = 64;             // rows of a leaf tile and width of the output
constexpr int kLeafThreads = 160;    // one micro tile a thread: 136 of them at 64 rows
constexpr int kLeafWarps = kLeafThreads / 32;
constexpr int kLeafChunk = 128;      // most features of a slab in shared memory
constexpr int kTileStride = kCap + 1;  // of the distance tile: odd, so (i, j) and (j, i) stores spread

__host__ __device__ constexpr int leaf_row_stride(int chunk4) {
  return chunk4 + ((chunk4 / 4) % 2 == 0 ? 4 : 0);  // a multiple of 4 that is 4 modulo 8
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(__cvta_generic_to_global(src))
               : "memory");
}

// One leaf of the table as the kernel sees it.
struct Leaf {
  int start;  // first tree position
  int rows;   // rows of the tile: min(size, 64), 0 for a padding entry
  int all;    // rows of the output the leaf owns: its size
};

__device__ __forceinline__ Leaf read_leaf(const int* __restrict__ starts,
                                          const int* __restrict__ sizes, int leaf, int n_leaves,
                                          int n) {
  Leaf f = {0, 0, 0};
  if (leaf < n_leaves) {
    f.start = starts[leaf];
    const int sz = sizes[leaf];
    if (sz > 0 && f.start >= 0 && f.start < n) {
      f.all = min(sz, n - f.start);
      f.rows = min(f.all, kCap);
    }
  }
  return f;
}

// Start the copies of features [k0, k0 + kw) of a leaf's rows into buf and
// zero what the register tiles read beyond them: the features up to the next
// multiple of 4 and the rows up to the next multiple of 4. The warps from
// first_warp on share the rows. One commit group a thread.
__device__ __forceinline__ void fetch_chunk(float* buf, const float* __restrict__ X, int d,
                                            int stride, Leaf f, int k0, int kw, bool vec,
                                            int first_warp) {
  const int warp = (int)(threadIdx.x >> 5) - first_warp;
  const int team = kLeafWarps - first_warp;
  const int lane = threadIdx.x & 31;
  const int kw4 = (kw + 3) & ~3;
  for (int r = warp; r < f.rows; r += team) {
    const float* src = X + (size_t)(f.start + r) * d + k0;
    float* dst = buf + r * stride;
    if (vec) {
      for (int c = 4 * lane; c < kw; c += 128) cp_async_16(dst + c, src + c);
    } else {
      for (int c = lane; c < kw; c += 32) cp_async_4(dst + c, src + c);
      if (lane < kw4 - kw) dst[kw + lane] = 0.0f;
    }
  }
  const int rows4 = (f.rows + 3) & ~3;
  for (int r = f.rows + warp; r < rows4; r += team)
    for (int c = lane; c < kw4; c += 32) buf[r * stride + c] = 0.0f;
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Write a finished leaf's rows of the output from its distance tile, whole
// 256-byte rows, 16 bytes a thread: +inf past the leaf size, and +inf
// throughout the rows past the 64th of an oversized leaf.
__device__ __forceinline__ void store_leaf(const float* tile, Leaf f, float* __restrict__ out) {
  float4* const orow = reinterpret_cast<float4*>(out + (size_t)f.start * kCap);
  for (int e = threadIdx.x; e < f.rows * (kCap / 4); e += kLeafThreads) {
    const int c = 4 * (e % (kCap / 4));
    const float* v = tile + (e / (kCap / 4)) * kTileStride + c;
    orow[e] = make_float4(c + 0 < f.rows ? v[0] : INFINITY, c + 1 < f.rows ? v[1] : INFINITY,
                          c + 2 < f.rows ? v[2] : INFINITY, c + 3 < f.rows ? v[3] : INFINITY);
  }
  const float4 inf4 = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
  for (int e = kCap * (kCap / 4) + threadIdx.x; e < f.all * (kCap / 4); e += kLeafThreads)
    orow[e] = inf4;
}

// A thread's 16 distances from its micro tile of the gram and the squared
// norms: each once, to (p, q) and (q, p) of the distance tile, which takes the
// place of the slab.
template <int kMetric>
__device__ __forceinline__ void write_distances(float* tile, const float* sq,
                                                const float (&acc)[4][4], int ti, int tj,
                                                int tiles) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = ti + i * tiles;
      const int q = tj + j * tiles;
      const float v = gram_distance(kMetric, acc[i][j], sq[p], sq[q]);
      tile[p * kTileStride + q] = v;
      tile[q * kTileStride + p] = v;
    }
}

__global__ void __launch_bounds__(kLeafThreads, 3)
leaf_allpairs_kernel(const float* __restrict__ X, const int* __restrict__ starts,
                     const int* __restrict__ sizes, int n_leaves, int n, int d, int metric,
                     int vec, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = min((d + 3) & ~3, kLeafChunk);
  const int stride = leaf_row_stride(chunk);
  const int buf_floats = max(kCap * stride, kCap * kTileStride);
  float* const sq = smem + 2 * buf_floats;  // [64] squared norms of the leaf's rows
  const int n_chunks = (d + chunk - 1) / chunk;
  const int tid = threadIdx.x;

  int leaf = blockIdx.x;
  int leaf_nxt = leaf + gridDim.x;
  Leaf cur = read_leaf(starts, sizes, leaf, n_leaves, n);
  Leaf nxt = read_leaf(starts, sizes, leaf_nxt, n_leaves, n);
  Leaf nxt2 = {0, 0, 0};
  int k_chunk = 0;
  int which = 0;
  fetch_chunk(smem, X, d, stride, cur, 0, min(chunk, d), vec, 0);

  float acc[4][4];
  int ti = 0, tj = 0, tiles = 0;
  bool active = false;

  // One stage a turn: a chunk of the current leaf's slab in the buffer `which`.
  while (leaf < n_leaves) {
    // the slab of this stage has landed; every thread is done with the other buffer
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    const bool last_chunk = k_chunk + 1 == n_chunks;
    if (k_chunk == 0) tiles = (cur.rows + 3) >> 2;
    // Start the next stage's copy: this leaf's next chunk, or the next leaf's
    // first. The warps that hold no micro tile of this leaf start it, so that
    // the others start their FMAs without queueing behind the copies; a leaf
    // that fills every warp leaves it to all of them.
    const int busy = (tiles * (tiles + 1) / 2 + 31) >> 5;
    const int first_warp = busy < kLeafWarps ? busy : 0;
    if ((tid >> 5) >= first_warp) {
      float* const other = smem + (which ^ 1) * buf_floats;
      if (!last_chunk) {
        const int k0 = (k_chunk + 1) * chunk;
        fetch_chunk(other, X, d, stride, cur, k0, min(chunk, d - k0), vec, first_warp);
      } else if (leaf_nxt < n_leaves) {
        fetch_chunk(other, X, d, stride, nxt, 0, min(chunk, d), vec, first_warp);
      }
    }

    if (k_chunk == 0) {
      // the leaf after the next: its table entry is needed one leaf from now
      nxt2 = read_leaf(starts, sizes, leaf_nxt + gridDim.x, n_leaves, n);
      // this thread's micro tile: the tid-th of the upper triangle, row by row
      active = tid < tiles * (tiles + 1) / 2;
      ti = 0;
      int rem = tid, len = tiles;
      while (active && rem >= len) {
        rem -= len;
        --len;
        ++ti;
      }
      tj = ti + rem;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }

    float* const buf = smem + which * buf_floats;
    if (active) {
      const int kw4 = (min(chunk, d - k_chunk * chunk) + 3) & ~3;
      const float* pa = buf + ti * stride;
      const float* pb = buf + tj * stride;
      const int step = tiles * stride;
#pragma unroll 2
      for (int k = 0; k < kw4; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = *reinterpret_cast<const float4*>(pa + r * step + k);
          b[r] = *reinterpret_cast<const float4*>(pb + r * step + k);
        }
        // each entry sums its features in ascending order, one accumulator
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float s = acc[i][j];
            s = fmaf(a[i].x, b[j].x, s);
            s = fmaf(a[i].y, b[j].y, s);
            s = fmaf(a[i].z, b[j].z, s);
            s = fmaf(a[i].w, b[j].w, s);
            acc[i][j] = s;
          }
      }
    }

    if (last_chunk) {
      if (active && ti == tj) {
#pragma unroll
        for (int r = 0; r < 4; ++r) sq[ti + r * tiles] = acc[r][r];
      }
      __syncthreads();  // norms visible; nobody reads this leaf's slab any more
      if (active) {
        // the metric is fixed inside each case, so its branches and the roots
        // of the eight norms a thread uses are resolved once, not per entry
        switch (metric) {
          case kSqeuclidean: write_distances<kSqeuclidean>(buf, sq, acc, ti, tj, tiles); break;
          case kEuclidean: write_distances<kEuclidean>(buf, sq, acc, ti, tj, tiles); break;
          case kL2: write_distances<kL2>(buf, sq, acc, ti, tj, tiles); break;
          case kCosine: write_distances<kCosine>(buf, sq, acc, ti, tj, tiles); break;
          case kAlternativeCosine:
            write_distances<kAlternativeCosine>(buf, sq, acc, ti, tj, tiles);
            break;
          case kDot: write_distances<kDot>(buf, sq, acc, ti, tj, tiles); break;
          case kAlternativeDot: write_distances<kAlternativeDot>(buf, sq, acc, ti, tj, tiles); break;
          case kInnerProduct: write_distances<kInnerProduct>(buf, sq, acc, ti, tj, tiles); break;
          case kAlternativeInnerProduct:
            write_distances<kAlternativeInnerProduct>(buf, sq, acc, ti, tj, tiles);
            break;
        }
      }
      __syncthreads();
      store_leaf(buf, cur, out);
      leaf = leaf_nxt;
      leaf_nxt += gridDim.x;
      cur = nxt;
      nxt = nxt2;
      k_chunk = 0;
    } else {
      ++k_chunk;
    }
    which ^= 1;
  }
}

}  // namespace pynnd

extern "C" int pynnd_leaf_allpairs(const void* X, const void* starts, const void* sizes,
                                   int n_leaves, int n, int d, int metric, void* out,
                                   void* stream) {
  using namespace pynnd;
  if (metric < 0 || metric >= kNumMetrics || d < 1 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_leaves <= 0 || n == 0) return (int)cudaGetLastError();
  const int chunk = ((d + 3) & ~3) < kLeafChunk ? ((d + 3) & ~3) : kLeafChunk;
  const int stride = leaf_row_stride(chunk);
  const int buf_floats = kCap * (stride > kTileStride ? stride : kTileStride);
  const int smem = (2 * buf_floats + kCap) * (int)sizeof(float);

  // what the card allows, asked once per device and shared-memory size
  static int plan_device = -1, plan_smem = -1, plan_grid = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != plan_device || smem != plan_smem) {
    constexpr int kWidest = leaf_row_stride(kLeafChunk) > kTileStride ? leaf_row_stride(kLeafChunk)
                                                                      : kTileStride;
    // above 48 KB a block's dynamic shared memory has to be allowed first
    err = cudaFuncSetAttribute(leaf_allpairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (2 * kCap * kWidest + kCap) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, leaf_allpairs_kernel,
                                                        kLeafThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    plan_grid = sms * per_sm;  // persistent blocks: as many as are resident at once
    plan_device = device;
    plan_smem = smem;
  }
  const int grid = n_leaves < plan_grid ? n_leaves : plan_grid;
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  leaf_allpairs_kernel<<<grid, kLeafThreads, smem, (cudaStream_t)stream>>>(
      (const float*)X, (const int*)starts, (const int*)sizes, n_leaves, n, d, metric, vec,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* pynnd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
