// RANSAC hypothesis scoring on Hopper: inlier counts of NH candidate
// lines over B scan points.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// score_lines_pallas (body _score_kernel): for each line y = m·x + b,
//   count = #{ i : valid[i] && |m·x_i - y_i + b| · rsqrt(m² + 1) < thresh }.
//
// Work: one warp per line, eight lines per 256-thread block.  The lanes
// stride over the B points and a shuffle reduction gives the int32 count;
// no shared memory, no atomics.
//
// Bound: at the batched extractor's shape (NH = 64, B = 1024) the call
// reads ~10 KB and makes ~65k distance tests — nanoseconds of bandwidth
// or arithmetic, so a single launch's latency (a few µs) is what bounds
// it.  The design therefore keeps it to one small launch.
//
// Numerics: the test is score_lines.cuh's, which the batched wall search
// (wall_search.cu) shares: rsqrtf as the TPU kernel uses lax.rsqrt
// (kernels.py:682); the products and sums are rounded one by one
// (__fmul_rn/__fadd_rn, no FMA contraction) like the plain PyTorch
// version, which divides by sqrt instead.  The two can disagree only for a
// point within an ulp of thresh.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_lines.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LINES_PER_BLOCK = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
score_lines_kernel(const float* __restrict__ points,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ lines, int B, int NH,
                   float thresh, int32_t* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.x * LINES_PER_BLOCK + threadIdx.x / 32;
  if (h >= NH) return;                        // whole warp leaves together
  const float m = lines[2 * h], b = lines[2 * h + 1];
  const float inv = score_inv_norm(m);
  int cnt = 0;
  for (int i = lane; i < B; i += 32) {
    cnt += (valid[i] != 0) &&
           score_is_inlier(m, b, inv, points[2 * i], points[2 * i + 1],
                           thresh);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if (lane == 0) out[h] = cnt;
}

}  // namespace

extern "C" int score_lines(const void* points, const void* valid,
                           const void* lines, int B, int NH, float thresh,
                           void* out, void* stream) {
  const int blocks = (NH + LINES_PER_BLOCK - 1) / LINES_PER_BLOCK;
  score_lines_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(lines), B, NH, thresh,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
