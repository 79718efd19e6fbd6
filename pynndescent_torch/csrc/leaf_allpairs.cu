// Leaf all-pairs distances for the forest init of NN-descent.
//
// Replaces the TPU kernel pynndescent_tpu/ops/pallas_init.py::leaf_allpairs
// (_leaf_pairs_kernel, tile math _tile_distances). Input: data rows X_t
// [n, d] fp32 in one tree's leaf order, and the tree's compact leaf table
// (starts, sizes)[L], ascending, padded with (n, 0). Output [n, CAP] fp32:
// row p of a leaf gets its gram-form distances to the leaf's first CAP
// members, +inf past the leaf size.
//
// What bounds it on the H100: per leaf the block reads a CAP x d slab
// (contiguous rows) and does CAP^2 * d FMAs. At CAP = 64, d = 128 that is
// 128 FMAs per byte read, so the kernel is bound by the fp32 FMA pipes and
// shared-memory bandwidth of its inner loop, not by device memory; the
// whole pass moves X_t once plus the [n, CAP] output.
//
// Design:
// * one thread block per leaf; the grid needs no order. The TPU kernel ran
//   its grid in sequence and let a later leaf overwrite the rows a larger
//   tile spilled past its own leaf; here each block writes only its own
//   rows [start, start + min(size, CAP)), and the wrapper fills the output
//   with +inf first, so rows no leaf covers are defined.
// * the slab streams through shared memory in chunks of DK features, so
//   any d works (the TPU kernel compiled only up to d = 128).
// * 256 threads each accumulate a 4 x 4 block of the CAP x CAP gram in
//   registers with fp32 FMAs (no TF32: the cancellation form
//   |x|^2 + |y|^2 - 2<x, y> needs full fp32). Squared norms are the gram's
//   diagonal, as on the TPU.
// * the leaf table is read from device memory and sized by the true leaf
//   count (no SMEM cap as in the TPU version).
#include <cuda_runtime.h>

#include "gram_metrics.cuh"

namespace pynnd {

constexpr int kCap = 64;
constexpr int kDk = 32;
constexpr int kLeafThreads = 256;

__global__ void __launch_bounds__(kLeafThreads)
leaf_allpairs_kernel(const float* __restrict__ X, const int* __restrict__ starts,
                     const int* __restrict__ sizes, int n, int d, int metric,
                     float* __restrict__ out) {
  __shared__ float tile[kCap][kDk + 1];
  __shared__ float sq[kCap];
  const int s = starts[blockIdx.x];
  const int sz = sizes[blockIdx.x];
  if (sz <= 0 || s >= n) return;  // padding entries of the leaf table
  const int rows = min(sz, kCap);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kDk) {
    for (int e = tid; e < kCap * kDk; e += kLeafThreads) {
      const int r = e / kDk;
      const int c = e % kDk;
      const int gr = s + r;
      const int gc = k0 + c;
      tile[r][c] = (gr < n && gc < d) ? X[(size_t)gr * d + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kDk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = tile[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = tile[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ty + 16 * i == tx + 16 * j) sq[ty + 16 * i] = acc[i][j];
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    float* orow = out + (size_t)(s + r) * kCap;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      orow[c] = c < sz ? gram_distance(metric, acc[i][j], sq[r], sq[c]) : INFINITY;
    }
  }
}

}  // namespace pynnd

extern "C" int pynnd_leaf_allpairs(const void* X, const void* starts, const void* sizes,
                                   int n_leaves, int n, int d, int metric, void* out,
                                   void* stream) {
  if (metric < 0 || metric >= pynnd::kNumMetrics) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_leaves > 0) {
    pynnd::leaf_allpairs_kernel<<<n_leaves, pynnd::kLeafThreads, 0, (cudaStream_t)stream>>>(
        (const float*)X, (const int*)starts, (const int*)sizes, n, d, metric, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pynnd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
