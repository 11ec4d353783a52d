// Fused maximum-likelihood gate costs on Hopper: the [M,K] cost plane of
// M measurements against K landmark slots.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/gating.py
// gate_costs_pallas (body _gate_kernel).  For slot k and measurement m:
//   Φ0_k  = A·Prr·Aᵀ + A·Prl_k·Bᵀ + B·Prl_kᵀ·Aᵀ + B·Pll_k·Bᵀ  (symmetric P)
//   S     = Φ0_k + diag(r0_m, r1_m)
//   cost  = νᵀS⁻¹ν (det form) + (z_sig_m − sig_k)² / s_cost,  +inf if the
//           slot is inactive,
// with ν = (z_r − ‖Δ‖, z_φ − ẑ_φ) and the bearing innovation wrapped by
// n1 − floor((n1 + 180)/360)·360 when wrap != 0.
//
// Work: one thread per landmark k.  The thread builds the Jacobian blocks
// A, B and Φ0_k once in registers, then loops over its chunk of the
// measurements and writes out[m, k]: neighbouring threads write
// neighbouring addresses, so every store is coalesced.  gridDim.y splits
// large M into chunks of M_CHUNK measurements (each chunk rebuilds Φ0_k,
// a few hundred flops, against up to M_CHUNK·~30 for the costs).  The
// TPU kernel's [TM, TK] tiles are not copied: they exist for the TPU's
// vector layout.
//
// Bearing strip: ẑ_φ = wrapTo360(atan2d(Δy, Δx) − θ) is computed by torch
// before the launch and read here (``zphi``), as the JAX package computes
// it in XLA before its kernel (gating.py:172-178).  Kernel and plain
// version then share the same ẑ_φ to the bit; a bearing innovation of a
// well-matched landmark is a small difference of two large angles, which
// an ulp of disagreement in atan2 would otherwise show as a large
// relative error.
//
// Numerics: the source is built with -fmad=false (ops/kernels.py
// _EXTRA_FLAGS), so every product and sum is rounded on its own, in the
// plain version's order of operations, as its separate PyTorch kernels
// round them.  On the same inputs the two agree to the bit, except where
// the wrap's floor((n1 + 180)/360) sits on an integer (the ±180 seam) and
// a division rounds differently from PyTorch's.
//
// Bound: at the session's shape (M = 8, K = 10000) the call reads about
// 0.6 MB of strips and writes 0.32 MB of costs — under a microsecond at
// HBM rate — against ~3 MFLOP: the floor is one launch's latency.  The
// design is one small launch with no shared memory and no atomics.
//
// Inputs (float32 except ``active``, all contiguous): pose [3] (x, y,
// θ deg), prr [3,3], zs [M,3] (range, bearing, signature), rdiag [M,2],
// lm [K,2], zphi [K], sig [K], active [K] (bool bytes), prl [K,6]
// (P[0:3, 3+2k:5+2k] row-major), pll [K,4] (p00, p01, p10, p11).
// Output out [M,K] float32.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int M_CHUNK = 64;

__global__ void __launch_bounds__(THREADS)
gate_costs_kernel(const float* __restrict__ pose,
                  const float* __restrict__ prr,
                  const float* __restrict__ zs,
                  const float* __restrict__ rdiag,
                  const float* __restrict__ lm,
                  const float* __restrict__ zphi,
                  const float* __restrict__ sig,
                  const uint8_t* __restrict__ active,
                  const float* __restrict__ prl,
                  const float* __restrict__ pll, float inv_scost, int wrap,
                  int M, int K, float* __restrict__ out) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const int m0 = blockIdx.y * M_CHUNK;
  const int m1 = min(M, m0 + M_CHUNK);

  // Jacobian blocks of the range/bearing model (Correspondence.m:62-63),
  // in the order the TPU kernel evaluates them
  const float dx = lm[2 * k] - pose[0];
  const float dy = lm[2 * k + 1] - pose[1];
  float q = dx * dx + dy * dy;
  q = (q == 0.f) ? 1.f : q;
  const float sq = sqrtf(q);
  const float inv_q = 1.f / q;
  const float A[2][3] = {{-sq * dx * inv_q, -sq * dy * inv_q, 0.f},
                         {dy * inv_q, -dx * inv_q, -1.f}};
  const float B[2][2] = {{sq * dx * inv_q, sq * dy * inv_q},
                         {-dy * inv_q, dx * inv_q}};
  float p[9], c[6], l[4];
#pragma unroll
  for (int e = 0; e < 9; ++e) p[e] = prr[e];
#pragma unroll
  for (int e = 0; e < 6; ++e) c[e] = prl[6 * static_cast<size_t>(k) + e];
#pragma unroll
  for (int e = 0; e < 4; ++e) l[e] = pll[4 * static_cast<size_t>(k) + e];

  auto arow = [&](int i, int j) {          // A[i,:]·Prr·A[j,:]
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) s = s + A[i][a] * p[3 * a + b] * A[j][b];
    return s;
  };
  auto aprlb = [&](int i, int j) {         // A[i,:]·Prl_k·B[j,:]
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) s = s + A[i][a] * c[2 * a + b] * B[j][b];
    return s;
  };
  auto bpllb = [&](int i, int j) {         // B[i,:]·Pll_k·B[j,:]
    return B[i][0] * (l[0] * B[j][0] + l[1] * B[j][1]) +
           B[i][1] * (l[2] * B[j][0] + l[3] * B[j][1]);
  };
  const float phi00 = arow(0, 0) + 2.f * aprlb(0, 0) + bpllb(0, 0);
  const float phi11 = arow(1, 1) + 2.f * aprlb(1, 1) + bpllb(1, 1);
  const float phi01 = arow(0, 1) + aprlb(0, 1) + aprlb(1, 0) + bpllb(0, 1);

  const bool act = active[k] != 0;
  const float zr = sq, zp = zphi[k], sg = sig[k];
  for (int m = m0; m < m1; ++m) {
    const float n0 = zs[3 * m] - zr;
    float n1 = zs[3 * m + 1] - zp;
    if (wrap) n1 = n1 - floorf((n1 + 180.f) / 360.f) * 360.f;
    const float s00 = phi00 + rdiag[2 * m];
    const float s11 = phi11 + rdiag[2 * m + 1];
    const float det = s00 * s11 - phi01 * phi01;
    const float pos =
        (n0 * (s11 * n0 - phi01 * n1) + n1 * (-phi01 * n0 + s00 * n1)) / det;
    const float ds = zs[3 * m + 2] - sg;
    out[static_cast<size_t>(m) * K + k] =
        act ? pos + ds * ds * inv_scost : INFINITY;
  }
}

}  // namespace

extern "C" int gate_costs(const void* pose, const void* prr, const void* zs,
                          const void* rdiag, const void* lm, const void* zphi,
                          const void* sig, const void* active,
                          const void* prl, const void* pll, float inv_scost,
                          int wrap, int M, int K, void* out, void* stream) {
  const dim3 grid((K + THREADS - 1) / THREADS, (M + M_CHUNK - 1) / M_CHUNK);
  gate_costs_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pose), static_cast<const float*>(prr),
      static_cast<const float*>(zs), static_cast<const float*>(rdiag),
      static_cast<const float*>(lm), static_cast<const float*>(zphi),
      static_cast<const float*>(sig), static_cast<const uint8_t*>(active),
      static_cast<const float*>(prl), static_cast<const float*>(pll),
      inv_scost, wrap, M, K, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
