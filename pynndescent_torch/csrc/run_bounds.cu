// Run bounds of a sorted 1-D int64 key (run_bounds_kernel): for each
// position i of key[0..m), the first position of its run of equal keys and,
// when asked, the last, both int64.
//
// Replaces no TPU kernel: the JAX package takes the run starts with
// lax.cummax over the run heads' positions (pynndescent_tpu/ops/
// nndescent.py:189, prune.py:161, parallel/mesh.py:230), and so did the
// port's plain version (ops/run_kernels.py::run_bounds_plain), with a
// flipped cummin for the run ends. On the H100 PyTorch runs the scan of a
// 1-D tensor in one thread block: some 40 ms for the init forest's 12M keys,
// a thousand times its byte bound, at every split level.
//
// What bounds it on the H100: bytes (8 read and 8 or 16 written a key; no
// arithmetic to speak of). The design has no serial part and no
// dependence between blocks:
// * a block takes a tile of 4,096 keys, read with 16-byte loads, neighbouring
//   threads on neighbouring addresses, into shared memory; each thread then
//   scans 16 consecutive keys (padded by 16 bytes a thread, so a 16-byte
//   access phase meets no bank twice);
// * a key heads a run where it differs from its predecessor, and ends one
//   where it differs from its successor; a warp-shuffle max-scan and a
//   shared-memory max-scan of the heads' positions give each run's first
//   position inside the tile, a reverse min-scan of the ends' its last;
// * only the tile's first run can begin before the tile, and only its last
//   run can end after it: while the tile's loads are in flight, warp 0
//   finds the first with one lower bound of key[start] below the tile and
//   warp 1 the last with one upper bound of key[end - 1] above it, each a
//   32-way search (5 rounds over 2^24 keys), and only where the run does
//   cross the tile's edge;
// * results go back through shared memory with 16-byte stores.
//
// Output equals the plain scan's bit for bit on a key sorted ascending (the
// searches need the order; every caller sorts first).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                   // consecutive keys a thread scans
constexpr int kTile = kThreads * kItems;     // keys a block
constexpr int kVecs = kTile / 2 / kThreads;  // 16-byte loads a thread
constexpr int kBuf = kTile + 2 * kThreads;   // two keys of padding after each thread's 16
constexpr unsigned kFull = 0xffffffffu;

// the shared-memory slot of the tile's key e: a thread's 16 keys start 144
// bytes after the previous thread's, so the 8 threads of a 16-byte access
// phase touch 8 distinct groups of 4 banks
__device__ __forceinline__ int slot(int e) { return e + 2 * (e / kItems); }

// The smallest p in [lo, hi] with key[p] > v (strict) or key[p] >= v, on a
// key sorted ascending, given that it holds at hi, which is never read (it
// may be m). All 32 lanes of a warp call it together: each round probes 32
// points and keeps the stretch between the last that fails and the first
// that holds.
__device__ long long warp_first_true(const long long* __restrict__ key, long long lo,
                                     long long hi, long long v, bool strict) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const long long count = hi - lo;
    const long long kq = key[lo + count * lane / 32];
    const unsigned hold = __ballot_sync(kFull, strict ? kq > v : kq >= v);
    if (hold == 0) {
      lo += count * 31 / 32 + 1;
      continue;
    }
    const int j = __ffs(hold) - 1;
    if (j == 0) return lo;
    hi = lo + count * j / 32;
    lo += count * (j - 1) / 32 + 1;
  }
  return lo;
}

__device__ __forceinline__ void store_tile(const long long* buf, long long* out, int n,
                                           bool full) {
  if (full) {
    longlong2* dst = reinterpret_cast<longlong2*>(out);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int g = threadIdx.x + k * kThreads;
      dst[g] = *reinterpret_cast<const longlong2*>(&buf[slot(2 * g)]);
    }
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) out[e] = buf[slot(e)];
  }
}

// One block a tile of kTile keys. vec: key, first and last are 16-byte
// aligned (a tile starts at a multiple of 32 KB from them).
template <bool kLast>
__global__ void __launch_bounds__(kThreads)
    run_bounds_kernel(const long long* __restrict__ key, long long m, bool vec,
                      long long* __restrict__ first, long long* __restrict__ last) {
  __shared__ __align__(16) long long buf[kBuf];
  __shared__ int warp_max[kWarps], warp_min[kWarps];
  // where the tile's first run begins and its last run ends
  __shared__ long long outside[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long start = static_cast<long long>(blockIdx.x) * kTile;
  const int n = static_cast<int>(min(static_cast<long long>(kTile), m - start));
  const bool full = vec && n == kTile;

  longlong2 held[kVecs];
  if (full) {
    const longlong2* src = reinterpret_cast<const longlong2*>(key + start);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) held[k] = src[t + k * kThreads];
  }
  // while those loads are in flight; every lane of a warp takes the same branch
  if (warp == 0) {
    long long lb = start;
    if (start > 0) {
      const long long v = key[start];
      if (key[start - 1] == v) lb = warp_first_true(key, 0, start - 1, v, false);
    }
    if (lane == 0) outside[0] = lb;
  } else if (kLast && warp == 1) {
    const long long end = start + n;
    long long ub = end;
    if (end < m) {
      const long long v = key[end - 1];
      if (key[end] == v) ub = warp_first_true(key, end, m, v, true);
    }
    if (lane == 0) outside[1] = ub - 1;
  }
  if (full) {
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int g = t + k * kThreads;
      *reinterpret_cast<longlong2*>(&buf[slot(2 * g)]) = held[k];
    }
  } else {
    for (int e = t; e < n; e += kThreads) buf[slot(e)] = key[start + e];
  }
  __syncthreads();

  // this thread's keys e0 .. e0 + 15 of the tile: which head a run, which end one
  const int e0 = t * kItems;
  const bool head0 = outside[0] == start;
  const bool tail_n = kLast && outside[1] == start + n - 1;
  unsigned heads = 0, tails = 0;
  if (e0 < n) {
    long long prev = e0 > 0 ? buf[slot(e0 - 1)] : 0;
    long long cur = buf[slot(e0)];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = e0 + j;
      if (e < n) {
        const long long next = e + 1 < n ? buf[slot(e + 1)] : 0;
        if (e == 0 ? head0 : cur != prev) heads |= 1u << j;
        if (kLast && (e + 1 == n ? tail_n : cur != next)) tails |= 1u << j;
        prev = cur;
        cur = next;
      }
    }
  }

  // the last head before this thread's keys and the first end after them
  // (tile positions; -1 and kTile for none)
  int inc = heads ? e0 + 31 - __clz(heads) : -1;
  int sinc = tails ? e0 + __ffs(tails) - 1 : kTile;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(kFull, inc, o);
    const int down = __shfl_down_sync(kFull, sinc, o);
    if (lane >= o) inc = max(inc, up);
    if (lane + o < 32) sinc = min(sinc, down);
  }
  if (lane == 31) warp_max[warp] = inc;
  if (lane == 0) warp_min[warp] = sinc;
  int before = __shfl_up_sync(kFull, inc, 1);
  int after = __shfl_down_sync(kFull, sinc, 1);
  if (lane == 0) before = -1;
  if (lane == 31) after = kTile;
  __syncthreads();  // also: every key read before the slots are overwritten
  for (int w = 0; w < warp; ++w) before = max(before, warp_max[w]);
  for (int w = warp + 1; w < kWarps; ++w) after = min(after, warp_min[w]);

  int run = before;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int e = e0 + j;
    if (e < n) {
      if (heads >> j & 1u) run = e;
      buf[slot(e)] = run < 0 ? outside[0] : start + run;
    }
  }
  __syncthreads();
  store_tile(buf, first + start, n, full);
  if (!kLast) return;
  __syncthreads();
  run = after;
#pragma unroll
  for (int j = kItems - 1; j >= 0; --j) {
    const int e = e0 + j;
    if (e < n) {
      if (tails >> j & 1u) run = e;
      buf[slot(e)] = run == kTile ? outside[1] : start + run;
    }
  }
  __syncthreads();
  store_tile(buf, last + start, n, full);
}

}  // namespace

extern "C" int pynnd_run_bounds(const void* key, long long m, void* first, void* last,
                                void* stream) {
  if (m < 0 || (m + kTile - 1) / kTile > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaGetLastError());
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = aligned(key) && aligned(first) && (last == nullptr || aligned(last));
  const unsigned blocks = static_cast<unsigned>((m + kTile - 1) / kTile);
  const auto* k = static_cast<const long long*>(key);
  auto* f = static_cast<long long*>(first);
  auto* l = static_cast<long long*>(last);
  const auto s = static_cast<cudaStream_t>(stream);
  if (l != nullptr) {
    run_bounds_kernel<true><<<blocks, kThreads, 0, s>>>(k, m, vec, f, l);
  } else {
    run_bounds_kernel<false><<<blocks, kThreads, 0, s>>>(k, m, vec, f, l);
  }
  return static_cast<int>(cudaGetLastError());
}
