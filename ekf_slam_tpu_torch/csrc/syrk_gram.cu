// Symmetric Gram G = S·Sᵀ from the lower tile pairs only, on Hopper.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// syrk_gram_pallas (body _gram_kernel): the Gram of the square-root
// filter's factor that its periodic recompression hands to a Cholesky
// (models/srekf_fast.sr_recompress).  S is [D, R] row-major; G is [D, D]
// in the accumulation type.
//
// Bound: the lower half is D·(D+1)/2 dot products of length R, about
// D²·R multiply-adds.  At the recompression's shape (D = R = 20067, f32)
// that is 2·D²·R/2 ≈ 8.1·10¹² FLOP, >= 121 ms at the card's 67 TFLOP/s
// f32 rate outside the tensor cores, against >= 3.2 GB of bytes (read S,
// write G), ~1 ms: compute bound by two orders of magnitude.  So the
// design is a register-blocked SGEMM, not the stream of the downdate
// kernels: the work is to keep the FMA pipes fed.
//
// Work: one block of 256 threads per lower tile pair (i >= j) of 128x128
// tiles of G, found from the linear block index.  The block walks the
// contraction in slabs of BK = 16 columns of S: it stages the two 128-row
// bands of the slab in shared memory, transposed so that each k is one
// contiguous row, and each thread accumulates an 8x8 micro-tile of G in
// registers (two 4-row by two 4-column groups, read from shared memory as
// 16-byte vectors).  Each slab element staged feeds 128 multiply-adds, so
// shared-memory traffic stays below the FMA rate; the next slab's global
// loads are issued into registers before the current slab's FMAs, so
// they are in flight while the block computes.  Ragged edges (any D, any
// R) are masked: rows past D and columns past R load as 0 and rows past
// D are not written.
//
// Bit-symmetry: every element of G is written once, from one register.
// An off-diagonal tile writes G_ij and its mirror G_ji from the same
// accumulators; a diagonal tile writes its lower elements and mirrors
// each one into the upper half, so the upper half of a diagonal tile is
// never computed on its own either.  The mirror stores are uncoalesced
// (4 bytes per row); they move ~0.8 GB at the recompression's shape,
// which is small beside the compute time.
//
// Precision: plain f32 FMAs on CUDA cores, no TF32 (the consumer is a
// Cholesky, and TF32 keeps 10 mantissa bits).  bf16 S is widened to f32
// when staged and accumulates in f32; f64 S accumulates in f64.  Tensor
// core variants (bf16 or TF32 MMA with a precision argument) are later
// work.
//
// dtype: 0 = float32 S -> float32 G, 1 = bfloat16 S (raw uint16 bits) ->
// float32 G, 2 = float64 S -> float64 G.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;         // tile of G
constexpr int BK = 16;            // contraction slab staged in shared memory
constexpr int THREADS = 256;      // 16 x 16 threads, 8x8 elements each
constexpr int PAD = 4;            // keeps 16-byte alignment of each row
constexpr int LOADS = TILE * BK / THREADS;   // slab elements per thread (8)

template <typename In, typename Acc> struct Widen;
template <> struct Widen<float, float> {
  __device__ __forceinline__ static float f(float v) { return v; }
};
template <> struct Widen<uint16_t, float> {
  __device__ __forceinline__ static float f(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
};
template <> struct Widen<double, double> {
  __device__ __forceinline__ static double f(double v) { return v; }
};

// Four consecutive accumulators from shared memory as 16-byte loads.
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double* o) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  o[0] = v0.x; o[1] = v0.y; o[2] = v1.x; o[3] = v1.y;
}

// This thread's LOADS slab elements of one band row (masked to 0 past D
// and past R), widened to the accumulation type.
template <typename In, typename Acc>
__device__ __forceinline__ void fetch(const In* row, bool ok, int k, int R,
                                      Acc (&out)[LOADS]) {
#pragma unroll
  for (int e = 0; e < LOADS; ++e)
    out[e] = (ok && k + e < R) ? Widen<In, Acc>::f(row[k + e]) : Acc(0);
}

// Linear block index -> lower-triangle tile pair (i >= j).
__device__ __forceinline__ void tile_pair(long long k, int* i, int* j) {
  long long r = static_cast<long long>(
      (sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  while (r * (r + 1) / 2 > k) --r;
  *i = static_cast<int>(r);
  *j = static_cast<int>(k - r * (r + 1) / 2);
}

template <typename In, typename Acc>
__global__ void __launch_bounds__(THREADS)
syrk_gram_kernel(const In* __restrict__ S, Acc* __restrict__ G, int D,
                 int R) {
  __shared__ __align__(16) Acc sA[BK][TILE + PAD];
  __shared__ __align__(16) Acc sB[BK][TILE + PAD];

  int bi, bj;
  tile_pair(blockIdx.x, &bi, &bj);
  const int r0 = bi * TILE, c0 = bj * TILE;
  const bool diag = bi == bj;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  // slab loader: thread -> (row of the band, LOADS consecutive k of the
  // slab), so a warp reads 16 rows x 64 (f32) or 128 (f64) contiguous bytes
  const int lrow = tid / 2, lk = (tid % 2) * LOADS;
  const bool arow = r0 + lrow < D, brow = c0 + lrow < D;
  const In* pa = S + static_cast<size_t>(arow ? r0 + lrow : 0) * R;
  const In* pb = S + static_cast<size_t>(brow ? c0 + lrow : 0) * R;
  Acc na[LOADS], nb[LOADS];

  Acc acc[8][8];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = Acc(0);

  fetch(pa, arow, lk, R, na);
  fetch(pb, brow, lk, R, nb);
  for (int k0 = 0; k0 < R; k0 += BK) {
#pragma unroll
    for (int e = 0; e < LOADS; ++e) {
      sA[lk + e][lrow] = na[e];
      sB[lk + e][lrow] = nb[e];
    }
    __syncthreads();
    if (k0 + BK < R) {                       // next slab in flight
      fetch(pa, arow, k0 + BK + lk, R, na);
      fetch(pb, brow, k0 + BK + lk, R, nb);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[8], b[8];
      load4(&sA[kk][ty * 4], a);
      load4(&sA[kk][64 + ty * 4], a + 4);
      load4(&sB[kk][tx * 4], b);
      load4(&sB[kk][64 + tx * 4], b + 4);
#pragma unroll
      for (int m = 0; m < 8; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fma(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

  // write G_ij and its mirror G_ji, each element once
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int lr = (m < 4 ? 0 : 64) + ty * 4 + (m & 3);
    const int r = r0 + lr;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int lc = (n < 4 ? 0 : 64) + tx * 4 + (n & 3);
      const int c = c0 + lc;
      if (r >= D || c >= D || (diag && lc > lr)) continue;
      G[static_cast<size_t>(r) * D + c] = acc[m][n];
      if (r != c) G[static_cast<size_t>(c) * D + r] = acc[m][n];
    }
  }
}

template <typename In, typename Acc>
int launch(const void* S, void* G, int D, int R, cudaStream_t s) {
  const long long T = (D + TILE - 1) / TILE;
  const long long blocks = T * (T + 1) / 2;
  syrk_gram_kernel<In, Acc><<<static_cast<unsigned>(blocks), THREADS, 0,
                              s>>>(static_cast<const In*>(S),
                                   static_cast<Acc*>(G), D, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int syrk_gram(const void* S, void* G, int D, int R, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, float>(S, G, D, R, s);
  if (dtype == 1) return launch<uint16_t, float>(S, G, D, R, s);
  if (dtype == 2) return launch<double, double>(S, G, D, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
