// Exact per-row top-m inside contiguous win-row windows of tree-ordered data
// (the locality sweep of NN-descent).
//
// Replaces the TPU kernel pynndescent_tpu/ops/pallas_init.py::window_topm
// (_window_topm_kernel). Input X_t [n, d] fp32 or bf16 in one tree's leaf
// order. `offset` zero-pad rows are conceptually prepended, so window w
// covers padded positions [w*win, (w+1)*win) and padded position P is data
// row P - offset. Output ids [n, m] (int32 data rows, -1 when missing) and
// dists [n, m] fp32 (+inf when missing), ascending, ties to the lowest
// column; self pairs and pad rows are masked.
//
// What bounds it on the H100: a window does win^2 * d FMAs on win * d
// inputs (1024 FMAs per input element at win = 1024), so it is bound by the
// fp32 FMA pipes and the shared-memory traffic of the tile product; device
// memory carries X_t about win / 64 times (mostly from L2) and the [n, m]
// outputs once.
//
// Design: the TPU kernel keeps a whole win x win tile in VMEM (4 MB at
// win = 1024); a block here has at most 227 KB of shared memory, so the
// layout is not carried over. Each block takes one window and 64 of its rows
// and streams the window's columns in ascending order, 64 at a time:
// * 128 threads compute the 64 x 64 distance tile (4 x 8 per thread, fp32
//   FMAs, features streamed in chunks of 32 through shared memory, so any d
//   works); squared norms are summed from the same shared chunks;
// * self pairs, the zero-padded front and rows past n are masked by index
//   arithmetic, so the wrapper pads nothing;
// * 64 threads, one per row, keep a sorted top-m list in shared memory and
//   insert each candidate with a strict-less test; since columns arrive in
//   ascending order, ties keep the lowest column, as on the TPU;
// * bf16 input is read as bf16 and computed in fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gram_metrics.cuh"

namespace pynnd {

constexpr int kRows = 64;
constexpr int kCols = 64;
constexpr int kWinDk = 32;
constexpr int kWinThreads = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kWinThreads)
window_topm_kernel(const T* __restrict__ X, int n, int d, int win, int m, int off, int metric,
                   int* __restrict__ ids, float* __restrict__ dists) {
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

size_t window_smem_bytes(int m) {
  return sizeof(float) * ((kRows + kCols) * (kWinDk + 1) + kRows * (kCols + 1) + kRows + kCols) +
         (sizeof(float) + sizeof(int)) * kRows * (m + 1);
}

template <typename T>
int launch_window(const void* X, int n, int d, int win, int m, int off, int metric, void* ids,
                  void* dists, cudaStream_t stream) {
  const size_t smem = window_smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(window_topm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_windows = ((long long)n + off + win - 1) / win;
  dim3 grid((unsigned)n_windows, (unsigned)(win / kRows));
  window_topm_kernel<T><<<grid, kWinThreads, smem, stream>>>(
      (const T*)X, n, d, win, m, off, metric, (int*)ids, (float*)dists);
  return (int)cudaGetLastError();
}

}  // namespace pynnd

extern "C" int pynnd_window_topm(const void* X, int is_bf16, int n, int d, int win, int m,
                                 int offset, int metric, void* ids, void* dists, void* stream) {
  if (win <= 0 || win % pynnd::kRows != 0 || m < 1 || m >= win || offset < 0 || offset >= win ||
      metric < 0 || metric >= pynnd::kNumMetrics) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? pynnd::launch_window<__nv_bfloat16>(X, n, d, win, m, offset, metric, ids, dists, s)
                 : pynnd::launch_window<float>(X, n, d, win, m, offset, metric, ids, dists, s);
}
