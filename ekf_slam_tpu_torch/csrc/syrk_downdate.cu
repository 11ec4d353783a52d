// Symmetric rank-R covariance downdate P <- P - W·Wᵀ, in place, on Hopper.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// syrk_downdate_pallas (bodies _syrk_kernel / _syrk_kernel_wres): the
// EKF's rank-2M correction Kg·(H·P) = W·Wᵀ with W = PHᵀ·L⁻ᵀ.
//
// Work: one block per lower-triangle tile pair (i >= j) of 64x64 tiles.
// The block stages the two W row bands in shared memory (f32), forms
// acc = W_i·W_jᵀ in f32 registers, writes P_ij - acc and, for i != j, the
// mirror P_ji - accᵀ from the SAME accumulator.  An input P that is
// bit-symmetric therefore leaves bit-symmetric; the TPU's identity-matmul
// transpose is replaced by a read of the accumulator through shared
// memory.
//
// Bound: the function must read P once and write it once.  At the
// headline shape (D = 20480, R = 16, bf16) that is 2·D²·2 B = 1.68 GB,
// >= 0.50 ms at 3.35 TB/s, against D²·R ≈ 6.7 GFLOP (~7 µs at the bf16
// tensor rate): memory bound ~70x.  So the design spends nothing on the
// math (plain f32 FMAs on CUDA cores) and everything on the stream: each
// thread issues all its 16-byte P loads of both tiles before the W
// contraction, so the loads are in flight while the FMAs run, and each
// P element is read and written exactly once.  Ragged edge tiles (any D)
// and rows whose start is not 16-byte aligned take a masked scalar path.
//
// dtype: 0 = float32 P/W, 1 = bfloat16 P/W (stored as raw uint16 bits),
// both accumulated in f32 and rounded to nearest-even on the way out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;
constexpr int RK = 32;            // rank chunk staged in shared memory
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ uint16_t from_f<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename T>
union Vec16 {
  uint4 u;
  T e[16 / sizeof(T)];
};

// Linear block index -> lower-triangle tile pair (i >= j).
__device__ __forceinline__ void tile_pair(long long k, int* i, int* j) {
  long long r = static_cast<long long>(
      (sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  while (r * (r + 1) / 2 > k) --r;
  *i = static_cast<int>(r);
  *j = static_cast<int>(k - r * (r + 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
syrk_downdate_kernel(T* __restrict__ P, const T* __restrict__ W, int D,
                     int R, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);               // elements per 16 B
  constexpr int VPR = TILE / VEC;                   // vectors per tile row
  constexpr int NV = TILE * VPR / THREADS;          // vectors per thread
  __shared__ float sWi[TILE][RK + 1];
  __shared__ float sWj[TILE][RK + 1];
  __shared__ float sAcc[TILE][TILE + 1];

  int bi, bj;
  tile_pair(blockIdx.x, &bi, &bj);
  const int r0 = bi * TILE, c0 = bj * TILE;
  const int tid = threadIdx.x;
  const bool mirror = bi != bj;
  const bool fast = vec_ok && (r0 + TILE <= D) && (c0 + TILE <= D);

  // 1. issue this thread's P loads of both tiles (fast path only)
  Vec16<T> pa[NV], pb[NV];
  if (fast) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * THREADS;
      const int rr = v / VPR, cc = (v % VPR) * VEC;
      pa[n].u = *reinterpret_cast<const uint4*>(
          P + static_cast<size_t>(r0 + rr) * D + c0 + cc);
      if (mirror)
        pb[n].u = *reinterpret_cast<const uint4*>(
            P + static_cast<size_t>(c0 + rr) * D + r0 + cc);
    }
  }

  // 2. acc = W_i·W_jᵀ: each thread owns a 4x4 micro-tile
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  for (int k0 = 0; k0 < R; k0 += RK) {
    for (int e = tid; e < TILE * RK; e += THREADS) {
      const int rr = e / RK, kk = e % RK, k = k0 + kk;
      float wi = 0.f, wj = 0.f;
      if (k < R) {
        if (r0 + rr < D) wi = to_f(W[static_cast<size_t>(r0 + rr) * R + k]);
        if (c0 + rr < D) wj = to_f(W[static_cast<size_t>(c0 + rr) * R + k]);
      }
      sWi[rr][kk] = wi;
      sWj[rr][kk] = wj;
    }
    __syncthreads();
    const int kmax = min(RK, R - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        a[m] = sWi[ty * 4 + m][kk];
        b[m] = sWj[tx * 4 + m][kk];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) sAcc[ty * 4 + m][tx * 4 + n] = acc[m][n];
  __syncthreads();

  // 3. P_ij -= acc and P_ji -= accᵀ, each element written once
  if (fast) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * THREADS;
      const int rr = v / VPR, cc = (v % VPR) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        pa[n].e[e] = from_f<T>(to_f(pa[n].e[e]) - sAcc[rr][cc + e]);
      *reinterpret_cast<uint4*>(
          P + static_cast<size_t>(r0 + rr) * D + c0 + cc) = pa[n].u;
      if (mirror) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          pb[n].e[e] = from_f<T>(to_f(pb[n].e[e]) - sAcc[cc + e][rr]);
        *reinterpret_cast<uint4*>(
            P + static_cast<size_t>(c0 + rr) * D + r0 + cc) = pb[n].u;
      }
    }
    return;
  }
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int rr = e / TILE, cc = e % TILE;
    if (r0 + rr < D && c0 + cc < D) {
      T* p = P + static_cast<size_t>(r0 + rr) * D + c0 + cc;
      *p = from_f<T>(to_f(*p) - sAcc[rr][cc]);
    }
    if (mirror && c0 + rr < D && r0 + cc < D) {
      T* p = P + static_cast<size_t>(c0 + rr) * D + r0 + cc;
      *p = from_f<T>(to_f(*p) - sAcc[cc][rr]);
    }
  }
}

}  // namespace

extern "C" int syrk_downdate(void* P, const void* W, int D, int R,
                             int dtype, int vec_ok, void* stream) {
  const long long T = (D + TILE - 1) / TILE;
  const long long blocks = T * (T + 1) / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    syrk_downdate_kernel<float><<<static_cast<unsigned>(blocks), THREADS, 0,
                                  s>>>(static_cast<float*>(P),
                                       static_cast<const float*>(W), D, R,
                                       vec_ok);
  } else if (dtype == 1) {
    syrk_downdate_kernel<uint16_t><<<static_cast<unsigned>(blocks), THREADS,
                                     0, s>>>(static_cast<uint16_t*>(P),
                                             static_cast<const uint16_t*>(W),
                                             D, R, vec_ok);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
