// Gram-form distance epilogue shared by the leaf all-pairs and the window
// top-m kernels: one distance from the dot product g = <x_i, x_j> and the
// squared norms of both rows. Same formulas, same zero-vector and
// non-positive-product conventions as the TPU kernels' tile math
// (pynndescent_tpu/ops/pallas_init.py::_tile_distances); the metric ids are
// the positions in pynndescent_torch.ops.distances.GRAM_METRICS.
#pragma once

#include <cfloat>
#include <cmath>

namespace pynnd {

enum GramMetric : int {
  kSqeuclidean = 0,
  kEuclidean = 1,
  kL2 = 2,
  kCosine = 3,
  kAlternativeCosine = 4,
  kDot = 5,
  kAlternativeDot = 6,
  kInnerProduct = 7,
  kAlternativeInnerProduct = 8,
  kNumMetrics = 9,
};

__device__ __forceinline__ float gram_distance(int metric, float g, float sq_i, float sq_j) {
  switch (metric) {
    case kSqeuclidean:
    case kEuclidean:
    case kL2: {
      const float d2 = fmaxf(sq_i + sq_j - 2.0f * g, 0.0f);
      return metric == kSqeuclidean ? d2 : sqrtf(d2);
    }
    case kCosine:
    case kAlternativeCosine: {
      const float nx = sqrtf(fmaxf(sq_i, 0.0f));
      const float ny = sqrtf(fmaxf(sq_j, 0.0f));
      const float nn = fmaxf(nx * ny, FLT_EPSILON);
      const bool both_zero = (nx == 0.0f) && (ny == 0.0f);
      if (both_zero) return 0.0f;
      const bool one_zero = (nx == 0.0f) || (ny == 0.0f);
      if (metric == kCosine) return one_zero ? 1.0f : 1.0f - g / nn;
      if (one_zero || g <= 0.0f) return FLT_MAX;
      return log2f(nn / g);
    }
    case kDot:
      return g <= 0.0f ? 1.0f : 1.0f - g;
    case kAlternativeDot:
      return g <= 0.0f ? FLT_MAX : -log2f(g);
    case kInnerProduct:
      return -g;
    case kAlternativeInnerProduct:
      return g <= 0.0f ? FLT_MAX : 1.0f / g;
  }
  return INFINITY;
}

}  // namespace pynnd
