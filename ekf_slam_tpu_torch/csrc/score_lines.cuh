// The RANSAC scoring test, shared by the scoring kernel (score_lines.cu)
// and the batched wall search (wall_search.cu), so the two count the same
// points to the bit.
//
// A point (x, y) is an inlier of the line y = m·x + b when
//   |m·x − y + b| · rsqrt(m² + 1) < thresh,
// with rsqrtf as the TPU kernel uses lax.rsqrt (ekf_slam_tpu/ops/pallas/
// kernels.py _score_kernel) and every product and sum rounded on its own
// (__fmul_rn/__fadd_rn, no FMA contraction, whatever the build flags).
// The plain PyTorch version divides by sqrt instead; the two can disagree
// only for a point within an ulp of thresh.

#pragma once

#include <cuda_runtime.h>

// rsqrt(m² + 1) of a line, computed once per line
__device__ __forceinline__ float score_inv_norm(float m) {
  return rsqrtf(__fadd_rn(__fmul_rn(m, m), 1.0f));
}

__device__ __forceinline__ bool score_is_inlier(float m, float b, float inv,
                                                float x, float y,
                                                float thresh) {
  const float d =
      __fmul_rn(fabsf(__fadd_rn(__fsub_rn(__fmul_rn(m, x), y), b)), inv);
  return d < thresh;
}
