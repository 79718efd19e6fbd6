// Candidate distances of the NN-descent join and of its gather inits
// (join_dists_kernel): for each row r of a block, the distances from the
// data row of query id q_ids[r] to the data rows of its pool ids
// pool[r, 0..P), read by id from the rows X, with no candidate row copied
// anywhere. One block a query row.
//
// Replaces no TPU kernel: the JAX package gathers the candidate rows into a
// [b, P, d] tile and measures it with one batched product
// (pynndescent_tpu/ops/nndescent.py::_join_block, init_random,
// init_from_forest), and so did the port's plain version
// (ops/join_kernels.py::join_dists_plain). On the H100 that tile is written
// once and read about four times (a widening copy of bf16 rows, the squares,
// their sum, the batched product), which made the join most of a build.
//
// What bounds it on the H100: bytes. Each candidate row is read once,
// d * 4 (fp32) or d * 2 (bf16) bytes for 4 d operations: far below the
// card's ratio of operations to bytes. Tensor cores buy nothing: every query
// row has its own candidates, so there is no operand that two products share.
// Rows that recur in a block's pools may come from L2, so the time can beat
// the bound that counts every candidate byte from device memory. The design:
// * the query row is read once a block, widened to fp32 in shared memory
//   (read from L1 where it is wider than 12,288 values);
// * a warp measures kInFlight candidate rows at once, each lane reading 16
//   bytes of each row (rows 16-byte aligned and d * element size a multiple
//   of 16), else one value a lane, which takes any d (d = 25 included);
// * <q, x> and |x|^2 come from the same loaded values, two FMAs each, so no
//   norm table is read and none can be stale;
// * the warp's eight sums are reduced by one reduce-scatter butterfly
//   (11 shuffles for 4 candidates, against 40 for four full reductions),
//   which adds the lanes' partial sums in the same tree as a full butterfly;
// * the distance is gram_distance (csrc/gram_metrics.cuh).
//
// Arithmetic: fp32 sums of fp32 products (bf16 values widened exactly, no
// TF32, no rounding of fp32 rows), as the plain version, in another order.
// A pair's distance depends only on its two rows, d and the load path, not
// on the block, the row's slot or the pool width; the query's squared norm
// is summed in the candidates' order, so a row against itself reads exactly
// 0 under the euclidean family. An id < 0 or outside [win_start,
// win_start + W) gives +inf and is not read.
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_metrics.cuh"

namespace {

constexpr int kJoinThreads = 256;
constexpr int kJoinWarps = kJoinThreads / 32;
constexpr int kInFlight = 4;  // candidate rows a warp measures at once
// the widest query row held in shared memory (48 KB of fp32, the most a
// block takes without opting in); wider rows are read through L1
constexpr int kSmemQueryMax = 48 * 1024 / 4;
constexpr unsigned kFull = 0xffffffffu;

// a pool id names a row of X: not -1, and inside the window
__device__ __forceinline__ bool readable(int id, long long loc, int W) {
  return id >= 0 && loc >= 0 && loc < W;
}

template <bool kBf16>
__device__ __forceinline__ float elem(const void* row, int i) {
  if (kBf16) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(static_cast<const uint16_t*>(row) + i))
                           << 16);
  }
  return __ldg(static_cast<const float*>(row) + i);
}

// the 16 bytes of chunk c of a row as fp32 values (8 bf16 or 4 fp32)
template <bool kBf16>
__device__ __forceinline__ void widen16(const uint4& v, float* x) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (kBf16) {
      x[2 * t] = __uint_as_float(w[t] << 16);
      x[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    } else {
      x[t] = __uint_as_float(w[t]);
    }
  }
}

// Where element i of the query row sits in shared memory. On the 16-byte
// path of bf16 rows a lane takes 8 query values a chunk: the first four of
// every chunk form one plane and the last four another, so that the warp's
// two float4 reads are each contiguous across lanes (no bank conflict).
template <bool kBf16, bool kVec>
__device__ __forceinline__ int q_slot(int i, int d) {
  if (kBf16 && kVec) return ((i >> 2) & 1) * (d >> 1) + (i >> 3) * 4 + (i & 3);
  return i;
}

// the query's values of chunk c (16-byte path)
template <bool kBf16, bool kSmemQ>
__device__ __forceinline__ void query16(const float* qs, const void* qrow, int c, int d, float* q) {
  if (!kSmemQ) {
    widen16<kBf16>(__ldg(static_cast<const uint4*>(qrow) + c), q);
    return;
  }
  const float4 a = reinterpret_cast<const float4*>(qs)[c];
  q[0] = a.x; q[1] = a.y; q[2] = a.z; q[3] = a.w;
  if (kBf16) {
    const float4 b = reinterpret_cast<const float4*>(qs + (d >> 1))[c];
    q[4] = b.x; q[5] = b.y; q[6] = b.z; q[7] = b.w;
  }
}

// The lane's partial sums of kInFlight rows: acc[k] = <q, x_k>,
// acc[kInFlight + k] = |x_k|^2. A row with ok[k] false is not read.
template <bool kBf16, bool kVec, bool kSmemQ>
__device__ __forceinline__ void partial_sums(const void* const* row, const bool* ok,
                                             const float* qs, const void* qrow, int d, int lane,
                                             float* acc) {
#pragma unroll
  for (int k = 0; k < 2 * kInFlight; ++k) acc[k] = 0.0f;
  if (kVec) {
    constexpr int kPer = kBf16 ? 8 : 4;
    const int chunks = d / kPer;
    for (int c = lane; c < chunks; c += 32) {
      uint4 v[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        v[k] = ok[k] ? __ldg(static_cast<const uint4*>(row[k]) + c) : make_uint4(0u, 0u, 0u, 0u);
      }
      float q[kPer];
      query16<kBf16, kSmemQ>(qs, qrow, c, d, q);
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        float x[kPer];
        widen16<kBf16>(v[k], x);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          acc[k] = fmaf(x[j], q[j], acc[k]);
          acc[kInFlight + k] = fmaf(x[j], x[j], acc[kInFlight + k]);
        }
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float x[kInFlight];
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) x[k] = ok[k] ? elem<kBf16>(row[k], i) : 0.0f;
      const float q = kSmemQ ? qs[i] : elem<kBf16>(qrow, i);
#pragma unroll
      for (int k = 0; k < kInFlight; ++k) {
        acc[k] = fmaf(x[k], q, acc[k]);
        acc[kInFlight + k] = fmaf(x[k], x[k], acc[kInFlight + k]);
      }
    }
  }
}

// Sums the warp's eight values acc[0..8) over its lanes; lane l returns the
// total of value l >> 2. Each step keeps half the values and adds the
// partner lane's copy of them, pairing lanes as the full butterfly does
// (xor 16, 8, 4, 2, 1), so every total is the full butterfly's, bit for bit.
__device__ __forceinline__ float reduce_scatter8(const float* acc, int lane) {
  static_assert(kInFlight == 4, "the reduce-scatter takes eight values");
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = h4 ? acc[i] : acc[i + 4];
    w[i] = (h4 ? acc[i + 4] : acc[i]) + __shfl_xor_sync(kFull, send, 16);
  }
  float u[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = h3 ? w[i] : w[i + 2];
    u[i] = (h3 ? w[i + 2] : w[i]) + __shfl_xor_sync(kFull, send, 8);
  }
  float t = (h2 ? u[1] : u[0]) + __shfl_xor_sync(kFull, h2 ? u[0] : u[1], 4);
  t += __shfl_xor_sync(kFull, t, 2);
  t += __shfl_xor_sync(kFull, t, 1);
  return t;
}

template <bool kBf16, bool kVec, bool kSmemQ>
__global__ void __launch_bounds__(kJoinThreads, 4)
    join_dists_kernel(const void* __restrict__ X, int W, int d, const int* __restrict__ q_ids,
                      const int* __restrict__ pool, int P, int win_start, int metric,
                      float* __restrict__ out) {
  extern __shared__ float4 q_smem[];  // the query row, fp32 (kSmemQ); float4 for its alignment
  float* qs = reinterpret_cast<float*>(q_smem);
  __shared__ float q_sqnorm;
  constexpr int kElem = kBf16 ? 2 : 4;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long qloc = static_cast<long long>(q_ids[r]) - win_start;
  qloc = qloc < 0 ? 0 : (qloc >= W ? W - 1 : qloc);  // the plain version's clamp
  const char* qrow = static_cast<const char*>(X) + qloc * d * kElem;
  if (kSmemQ) {
    for (int i = threadIdx.x; i < d; i += kJoinThreads) {
      qs[q_slot<kBf16, kVec>(i, d)] = elem<kBf16>(qrow, i);
    }
    __syncthreads();
  }
  if (warp == 0) {
    // |q|^2 in the order of a candidate's |x|^2
    const void* row[kInFlight] = {qrow, qrow, qrow, qrow};
    const bool ok[kInFlight] = {true, false, false, false};
    float acc[2 * kInFlight];
    partial_sums<kBf16, kVec, kSmemQ>(row, ok, qs, qrow, d, lane, acc);
    const float total = reduce_scatter8(acc, lane);
    if (lane == 4 * kInFlight) q_sqnorm = total;  // value kInFlight: |x_0|^2
  }
  __syncthreads();
  const float qsq = q_sqnorm;

  const int* prow = pool + static_cast<long long>(r) * P;
  float* orow = out + static_cast<long long>(r) * P;
  for (int p0 = warp * kInFlight; p0 < P; p0 += kJoinWarps * kInFlight) {
    const int mine = lane < kInFlight && p0 + lane < P ? __ldg(prow + p0 + lane) : -1;
    const void* row[kInFlight];
    bool ok[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const int id = __shfl_sync(kFull, mine, k);
      const long long loc = static_cast<long long>(id) - win_start;
      ok[k] = readable(id, loc, W);
      row[k] = static_cast<const char*>(X) + (ok[k] ? loc : 0) * d * kElem;
    }
    float acc[2 * kInFlight];
    partial_sums<kBf16, kVec, kSmemQ>(row, ok, qs, qrow, d, lane, acc);
    const float total = reduce_scatter8(acc, lane);
    // lane 4k holds <q, x_k>, lane 16 + 4k holds |x_k|^2
    const float g = __shfl_sync(kFull, total, 4 * (lane & (kInFlight - 1)));
    const float s = __shfl_sync(kFull, total, 16 + 4 * (lane & (kInFlight - 1)));
    if (lane < kInFlight && p0 + lane < P) {
      const long long loc = static_cast<long long>(mine) - win_start;
      orow[p0 + lane] = readable(mine, loc, W) ? pynnd::gram_distance(metric, g, qsq, s) : INFINITY;
    }
  }
}

}  // namespace

extern "C" int pynnd_join_dists(const void* X, int is_bf16, int W, int d, const void* q_ids, int b,
                                const void* pool, int P, int win_start, int metric, void* out,
                                void* stream) {
  using namespace pynnd;
  if (metric < 0 || metric >= kNumMetrics || d < 1 || W < 1 || b < 0 || P < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = d % (is_bf16 ? 8 : 4) == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool smem_q = d <= kSmemQueryMax;
  const int smem = smem_q ? d * static_cast<int>(sizeof(float)) : 0;
  auto launch = [&](auto kernel) {
    kernel<<<b, kJoinThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        X, W, d, static_cast<const int*>(q_ids), static_cast<const int*>(pool), P, win_start,
        metric, static_cast<float*>(out));
  };
  // (bf16, 16-byte loads, query in shared memory)
  if (is_bf16) {
    if (vec) smem_q ? launch(join_dists_kernel<true, true, true>)
                    : launch(join_dists_kernel<true, true, false>);
    else smem_q ? launch(join_dists_kernel<true, false, true>)
                : launch(join_dists_kernel<true, false, false>);
  } else {
    if (vec) smem_q ? launch(join_dists_kernel<false, true, true>)
                    : launch(join_dists_kernel<false, true, false>);
    else smem_q ? launch(join_dists_kernel<false, false, true>)
                : launch(join_dists_kernel<false, false, false>);
  }
  return static_cast<int>(cudaGetLastError());
}
