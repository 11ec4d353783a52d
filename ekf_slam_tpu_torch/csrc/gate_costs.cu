// Fused maximum-likelihood gate costs on Hopper: the [M,K] cost plane of
// M measurements against K landmark slots, read straight from the filter
// state in one launch.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/gating.py
// gate_costs_pallas (body _gate_kernel) together with the XLA work that
// feeds it there (strips_from_state, the R diagonal, the bearing strip).
// For slot k and measurement m:
//   Φ0_k  = A·Prr·Aᵀ + A·Prl_k·Bᵀ + B·Prl_kᵀ·Aᵀ + B·Pll_k·Bᵀ  (symmetric P)
//   S     = Φ0_k + diag(R_m[0,0], R_m[1,1])
//   cost  = νᵀS⁻¹ν (det form) + (z_sig_m − sig_k)² / s_cost,  +inf if the
//           slot is inactive,
// with ν = (z_r − ‖Δ‖, z_φ − ẑ_φ), ẑ_φ = wrapTo360(atan2d(Δy, Δx) − θ),
// and the bearing innovation wrapped by n1 − floor((n1 + 180)/360)·360
// when wrap != 0.
//
// Inputs, read where they lie:
//   x [≥3]        pose (x, y, θ in degrees) at x[0:3]
//   P [≥3+2K, ld] covariance, row-major with leading dimension ld:
//                 Prr = P[0:3, 0:3]; the pose↔landmark strip of slot k at
//                 P[r, 3+2k] and P[r, 4+2k], r = 0..2 (neighbouring threads
//                 read neighbouring columns); the slot's diagonal block
//                 p00 = P[3+2k, 3+2k], p01 = P[3+2k, 4+2k] (super-diagonal),
//                 p10 = P[4+2k, 3+2k] (sub-diagonal), p11 = P[4+2k, 4+2k]
//                 (two 32-byte sectors a slot).  float32 or bfloat16
//                 (PT = float or __nv_bfloat16, widened on load).
//   lm [K,2], sig [K], active [K] (bool bytes) — landmark table
//   zs [M,3] (range, bearing, signature), Rs [M,2,2] (R's diagonal only)
// Output out [M,K] float32.
//
// Work: one thread per landmark k.  The thread builds ẑ_φ, the Jacobian
// blocks A, B and Φ0_k once in registers, then loops over its chunk of
// the measurements and writes out[m, k]: neighbouring threads write
// neighbouring addresses, so every store is coalesced.  gridDim.y splits
// large M into chunks of M_CHUNK measurements (each chunk rebuilds Φ0_k,
// a few hundred flops, against up to M_CHUNK·~30 for the costs).  The
// TPU kernel's [TM, TK] tiles are not copied: they exist for the TPU's
// vector layout.
//
// Bearing: computed here with atan2f, in the order of operations of the
// plain version (ops/gating._bearing_strip on CUDA tensors): Δ = lm −
// pose, atan2f, times ``rad2deg`` — PyTorch's CUDA division by a Python
// float multiplies by the float32 reciprocal of the float32 divisor, and
// the wrapper passes that reciprocal — then − θ, then wrapTo360's
// fmod-based definition with positive multiples of 360 sent to 360
// (ops/angles.wrap_to_360).  Mosaic has no atan2 lowering, which is why
// the JAX package computes this strip in XLA before its kernel
// (gating.py:172-178); CUDA has one, so the strip costs no launches.
//
// Numerics: the source is built with -fmad=false (ops/kernels.py
// _EXTRA_FLAGS), so every product and sum is rounded on its own, in the
// plain version's order of operations, as its separate PyTorch kernels
// round them.  On the same inputs the two agree to the bit wherever
// atan2f does (libdevice's atan2f carries explicit FMAs; chip_smoke.py
// phase 4 prints the ẑ_φ gap in ulps), except where the wrap's
// floor((n1 + 180)/360) sits on an integer (the ±180 seam) and a division
// rounds differently from PyTorch's.
//
// Bound: at the session's shape (M = 8, K = 10000) the call reads about
// 0.24 MB of P's pose rows, 0.64 MB of diagonal sectors and 0.13 MB of
// landmark table, and writes 0.32 MB of costs — 0.4 µs at HBM rate —
// against ~3 MFLOP: the floor is one launch's latency.  The design is one
// small launch with no shared memory, no atomics and no torch op between
// the state and the kernel.
//
// ``zphi_out`` (nullable): where given, the chunk-0 threads also write
// their ẑ_φ there [K], so a check can hold the in-kernel bearing to the
// plain version's in ulps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int M_CHUNK = 64;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename PT>
__global__ void __launch_bounds__(THREADS)
gate_costs_kernel(const float* __restrict__ x, const PT* __restrict__ P,
                  int64_t ld, const float* __restrict__ lm,
                  const float* __restrict__ sig,
                  const uint8_t* __restrict__ active,
                  const float* __restrict__ zs, const float* __restrict__ Rs,
                  float rad2deg, float inv_scost, int wrap, int M, int K,
                  float* __restrict__ out, float* __restrict__ zphi_out) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const int m0 = blockIdx.y * M_CHUNK;
  const int m1 = min(M, m0 + M_CHUNK);

  // Jacobian blocks of the range/bearing model (Correspondence.m:62-63),
  // in the order the TPU kernel evaluates them
  const float dx = lm[2 * k] - x[0];
  const float dy = lm[2 * k + 1] - x[1];
  float q = dx * dx + dy * dy;
  q = (q == 0.f) ? 1.f : q;
  const float sq = sqrtf(q);
  const float inv_q = 1.f / q;
  const float A[2][3] = {{-sq * dx * inv_q, -sq * dy * inv_q, 0.f},
                         {dy * inv_q, -dx * inv_q, -1.f}};
  const float B[2][2] = {{sq * dx * inv_q, sq * dy * inv_q},
                         {-dy * inv_q, dx * inv_q}};

  // predicted bearing wrapTo360(atan2d(Δy, Δx) − θ)
  const float t = atan2f(dy, dx) * rad2deg - x[2];
  float w = fmodf(t, 360.f);               // jnp.mod: shift a negative
  if (w < 0.f) w = w + 360.f;              // remainder by the divisor
  const float zp = (w == 0.f && t > 0.f) ? 360.f : w;
  if (zphi_out != nullptr && blockIdx.y == 0) zphi_out[k] = zp;

  // Prr (the same 9 values in every thread), the slot's pose↔landmark
  // strip from P's rows 0..2 and its diagonal block
  const int64_t c0 = 3 + 2 * static_cast<int64_t>(k);
  float p[9], c[6], l[4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) p[3 * a + b] = load(P + a * ld + b);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) c[2 * a + b] = load(P + a * ld + c0 + b);
  l[0] = load(P + c0 * ld + c0);
  l[1] = load(P + c0 * ld + c0 + 1);
  l[2] = load(P + (c0 + 1) * ld + c0);
  l[3] = load(P + (c0 + 1) * ld + c0 + 1);

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
  const float zr = sq, sg = sig[k];
  for (int m = m0; m < m1; ++m) {
    const float n0 = zs[3 * m] - zr;
    float n1 = zs[3 * m + 1] - zp;
    if (wrap) n1 = n1 - floorf((n1 + 180.f) / 360.f) * 360.f;
    const float s00 = phi00 + Rs[4 * m];
    const float s11 = phi11 + Rs[4 * m + 3];
    const float det = s00 * s11 - phi01 * phi01;
    const float pos =
        (n0 * (s11 * n0 - phi01 * n1) + n1 * (-phi01 * n0 + s00 * n1)) / det;
    const float ds = zs[3 * m + 2] - sg;
    out[static_cast<size_t>(m) * K + k] =
        act ? pos + ds * ds * inv_scost : INFINITY;
  }
}

template <typename PT>
int launch(const void* x, const void* P, int64_t ld, const void* lm,
           const void* sig, const void* active, const void* zs,
           const void* Rs, float rad2deg, float inv_scost, int wrap, int M,
           int K, void* out, void* zphi_out, void* stream) {
  const dim3 grid((K + THREADS - 1) / THREADS, (M + M_CHUNK - 1) / M_CHUNK);
  gate_costs_kernel<PT><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const PT*>(P), ld,
      static_cast<const float*>(lm), static_cast<const float*>(sig),
      static_cast<const uint8_t*>(active), static_cast<const float*>(zs),
      static_cast<const float*>(Rs), rad2deg, inv_scost, wrap, M, K,
      static_cast<float*>(out), static_cast<float*>(zphi_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p_dtype: 0 float32 P, 1 bfloat16 P.  M ≥ 1 and K ≥ 1 (the wrapper
// launches nothing for an empty plane).
extern "C" int gate_costs(const void* x, const void* P, int64_t ld,
                          int p_dtype, const void* lm, const void* sig,
                          const void* active, const void* zs, const void* Rs,
                          float rad2deg, float inv_scost, int wrap, int M,
                          int K, void* out, void* zphi_out, void* stream) {
  if (p_dtype == 1)
    return launch<__nv_bfloat16>(x, P, ld, lm, sig, active, zs, Rs, rad2deg,
                                 inv_scost, wrap, M, K, out, zphi_out,
                                 stream);
  return launch<float>(x, P, ld, lm, sig, active, zs, Rs, rad2deg, inv_scost,
                       wrap, M, K, out, zphi_out, stream);
}
