// Rank-R covariance correction P <- P - K·V, in place, on Hopper.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// cov_update_pallas (body _cov_update_kernel): the batched EKF's gemm
// correction P − Kg·(H·P) with Kg [N,R], V = H·P [R,D] and R = 2M.
//
// Bound: the function must read P once and write it once.  At the
// session's shape (N = D = 20003, R = 16, f32) that is 2·D²·4 B = 3.2 GB,
// >= 0.956 ms at 3.35 TB/s, against 2·D²·R = 12.8 GFLOP (0.19 ms at the
// 67 TFLOP/s f32 rate without tensor cores): memory bound about 5x.  So
// the design spends nothing on the math (plain f32 FMAs on CUDA cores)
// and everything on the stream.
//
// Work: one block per 64 x 128 tile of P, 256 threads.  Each thread owns 8
// rows x 4 columns of the tile, 32 apart along the row, so each warp
// reads and writes 128 consecutive bytes of a row at a time.  The thread
// issues all 32 of its P loads first, then stages the tile's K row band
// and V column band in shared memory (RK = 16 of the rank at a time) and
// runs the rank-R FMAs while those loads are in flight, then writes
// P − K·V: each element of P is read once and written once.
//
// D = 3 + 2K is odd, so no row after the first starts 16-byte aligned:
// the accesses are 4-byte, and ragged edge tiles are masked (rows >= N
// and columns >= D are neither read nor written).  P is not padded.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;            // tile rows
constexpr int TN = 128;           // tile columns
constexpr int RK = 16;            // rank chunk staged in shared memory
constexpr int TX = 32, TY = 8;    // 256 threads
constexpr int RPT = TM / TY;      // rows per thread (8)
constexpr int CPT = TN / TX;      // columns per thread (4)

__global__ void __launch_bounds__(TX * TY)
cov_update_kernel(float* __restrict__ P, const float* __restrict__ Kg,
                  const float* __restrict__ V, int N, int D, int R) {
  __shared__ float sK[TM][RK + 1];
  __shared__ float sV[RK][TN];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int r0 = blockIdx.y * TM, c0 = blockIdx.x * TN;

  // 1. issue this thread's P loads
  float p[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + tx + j * TX;
      p[i][j] = (r < N && c < D) ? P[static_cast<size_t>(r) * D + c] : 0.f;
    }
  }

  // 2. acc = K_band · V_band, RK ranks at a time
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < R; k0 += RK) {
    for (int e = tid; e < TM * RK; e += TX * TY) {
      const int rr = e / RK, kk = e % RK;
      const int r = r0 + rr, k = k0 + kk;
      sK[rr][kk] = (r < N && k < R) ? Kg[static_cast<size_t>(r) * R + k] : 0.f;
    }
    for (int e = tid; e < RK * TN; e += TX * TY) {
      const int kk = e / TN, cc = e % TN;
      const int c = c0 + cc, k = k0 + kk;
      sV[kk][cc] = (c < D && k < R) ? V[static_cast<size_t>(k) * D + c] : 0.f;
    }
    __syncthreads();
    const int kmax = min(RK, R - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = sK[ty + i * TY][kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = sV[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // 3. P − K·V, each element written once
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + tx + j * TX;
      if (r < N && c < D) P[static_cast<size_t>(r) * D + c] = p[i][j] - acc[i][j];
    }
  }
}

}  // namespace

extern "C" int cov_update(void* P, const void* Kg, const void* V, int N,
                          int D, int R, void* stream) {
  const dim3 grid((D + TN - 1) / TN, (N + TM - 1) / TM);
  cov_update_kernel<<<grid, dim3(TX, TY), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(P), static_cast<const float*>(Kg),
      static_cast<const float*>(V), N, D, R);
  return static_cast<int>(cudaGetLastError());
}
