// Symmetric Gram G = S·Sᵀ from the lower tile pairs only, on Hopper.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// syrk_gram_pallas (body _gram_kernel): the Gram of the square-root
// filter's factor that its periodic recompression hands to a Cholesky
// (models/srekf_fast.sr_recompress, one launch a recompression on CUDA).
// S is [D, R] row-major, read as it lies (any D, any R, no padded copy);
// G is [D, D] in the accumulation type.
//
// Bound: the lower half is D·(D+1)/2 dot products of length R.  At the
// recompression's shape (D = R = 20067, f32) that is D·(D+1)·R ≈ 8.08·10¹²
// FLOP against ~3.2 GB of bytes (read S, write G; ~1 ms): compute bound.
// An f32-accurate product on the tensor cores takes three TF32 products
// (below), so its bound is 3 · 8.08·10¹² / 495 TFLOP/s = 48.98 ms; the
// same work as f32 FMAs on CUDA cores is bounded at 120.61 ms
// (67 TFLOP/s).
//
// float32 S (dtype 0): tensor cores, 3xTF32 (syrk_gram_kernel_tf32).
//
//   Precision.  Each staged element is split in registers as the
//   fragments are read: hi = tf32_rna(a), lo = tf32_rna(a − hi) (a − hi is
//   exact in f32), and each product is taken as lo·hiᵀ + hi·loᵀ + hi·hiᵀ,
//   small terms first.  What is dropped (lo·lo and the rounding of lo) is
//   <= ~3·2⁻²² |a·b| a product, below the f32 rounding of a long sum.  One
//   TF32 pass would err by ~2⁻¹¹ a product, which the Cholesky would see
//   squared in κ.  The tensor cores' own f32 sums may truncate instead of
//   rounding to nearest, a bias that grows with R on the positive
//   diagonal; so each 32-column slab's products go into partial sums that
//   start at 0 (the MMA's C operand), and each partial sum is added to the
//   running sum by an f32 add on the CUDA cores, rounded to nearest: a
//   truncated chain is 12 MMAs long, whatever R.  checks.gram_compare
//   holds the result to the f64 Gram.
//
//   MMA.  mma.sync.aligned.m16n8k8.row.col, TF32 operands, f32 sums.  Both
//   operands are rows of S with the contraction contiguous, so A's row
//   fragment and B's column fragment both come from staged S rows as they
//   lie, by ldmatrix (an 8x4 block of TF32 is an 8x8 block of 16-bit
//   halves): nothing is transposed.
//
//   Tiling.  One block of 256 threads (8 warps) per lower tile pair
//   (i >= j) of 128x128 tiles of G, the pairs taken in panels of 8 tile
//   rows, column by column, so that the blocks running together share
//   their bands of S in L2.  Each warp owns a 64x32 warp tile, 4x4 MMA
//   tiles: 64 running and 64 partial sums a thread.  The contraction is
//   staged in slabs of BK = 32 columns of the two 128-row bands through a
//   3-stage cp.async ring in dynamic shared memory (110,592 bytes; the
//   attribute is set once a device), each staged row padded to BK + 4
//   floats, so that ldmatrix's eight 16-byte row reads fall on 32
//   distinct banks.  A quarter of the copies of the slab two ahead is
//   issued before each 8-deep step, so they do not queue in front of the
//   MMAs.
//
//   Staging.  One path: every element is a 4-byte cp.async.ca, a warp one
//   staged row of 32 columns a copy.  At the recompression's shape R is
//   odd, so rows start on 4-byte boundaries and their stride (4·R bytes)
//   is no multiple of 16: neither a 16-byte cp.async nor a TMA tensor map
//   can read S as it lies.  Rows >= D and columns >= R are zero-filled
//   through the copy's src-size operand.  The narrow copies cost issue
//   slots, not bandwidth: each staged element feeds 3·128 multiply-adds.
//
// bfloat16 S (dtype 1, widened to f32 when staged, f32 sums) and float64
// S (dtype 2, f64 sums): FMAs on CUDA cores (syrk_gram_kernel), 128x128
// register tiles with an 8x8 micro-tile a thread, staged through registers
// into shared memory transposed so that each k is one contiguous row.
//
// Bit-symmetry, both bodies: every element of G is written once, from one
// register.  An off-diagonal tile writes G_ij and its mirror G_ji from the
// same sum; a diagonal tile writes its lower elements and mirrors each one
// into the upper half (under 3xTF32 an upper element computed on its own
// would differ in rounding: hi_i·lo_j and lo_i·hi_j trade places).  The
// stores go straight to device memory: a warp's mirror store fills four
// whole 32-byte sectors and its direct store half of eight, which the next
// store completes; all of G is 1.6 GB at the recompression's shape, ~0.5 ms
// of the card's bandwidth.
//
// dtype: 0 = float32 S -> float32 G, 1 = bfloat16 S (raw uint16 bits) ->
// float32 G, 2 = float64 S -> float64 G.

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;         // tile of G
constexpr int GROUP = 8;          // tile rows of a panel (tf32 kernel)

// Linear block index -> lower-triangle tile pair (i >= j), row by row.
__device__ __forceinline__ void tile_pair(long long k, int* i, int* j) {
  long long r = static_cast<long long>(
      (sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  while (r * (r + 1) / 2 > k) --r;
  *i = static_cast<int>(r);
  *j = static_cast<int>(k - r * (r + 1) / 2);
}

// Linear block index -> lower-triangle tile pair, in panels of GROUP tile
// rows, each panel column by column.  A panel's pairs are one run of
// block indices in row order too, so block k's panel is that of its row.
__device__ __forceinline__ void tile_pair_panels(long long k, int T, int* i,
                                                 int* j) {
  int r, c;
  tile_pair(k, &r, &c);
  const int i0 = r / GROUP * GROUP;
  const int i1 = min(i0 + GROUP, T), H = i1 - i0;
  long long q = k - static_cast<long long>(i0) * (i0 + 1) / 2;
  if (q < static_cast<long long>(i0 + 1) * H) {   // columns 0..i0, full
    *j = static_cast<int>(q / H);
    *i = i0 + static_cast<int>(q % H);
    return;
  }
  q -= static_cast<long long>(i0 + 1) * H;        // the corner triangle
  int col = i0 + 1;
  while (q >= i1 - col) {
    q -= i1 - col;
    ++col;
  }
  *j = col;
  *i = col + static_cast<int>(q);
}

long long tile_pairs(int D) {
  const long long T = (D + TILE - 1) / TILE;
  return T * (T + 1) / 2;
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BK = 32;                     // contraction slab (columns)
constexpr int STEPS = BK / 8;              // 8-deep MMA steps of a slab
constexpr int LD = BK + 4;                 // staged row, padded (floats)
constexpr int THREADS = 256;               // 8 warps: 2 x 4 warp tiles
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = 2 * TILE * LD;        // both bands' rows
constexpr int SMEM = STAGES * STAGE_FLOATS * 4;    // bytes
static_assert(BK == 32, "a warp stages one 32-column row a copy");
static_assert(STEPS * 8 == 32, "a step's copies are 8 of a warp's 32 rows");

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero as cvt.rna does it, for finite x, in two integer operations
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + (what TF32 drops of lo); x − hi is exact in f32
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi,
                                      uint32_t& lo) {
  hi = tf32(__uint_as_float(x));
  lo = tf32(__uint_as_float(x) - __uint_as_float(hi));
}

// d = a·b + c on one 16x8x8 tile (TF32 operands, f32 sums)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2],
                                    const float (&c)[4]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// four 8x4 TF32 blocks from shared memory (8x8 of 16-bit halves each):
// lane l gives the address of row l%8 of block l/8 and receives element
// (l/4, l%4) of each block, the m16n8k8 fragment layout
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 4 bytes global -> shared; `bytes` (0 or 4) of them read, the rest zero
__device__ __forceinline__ void cp4(uint32_t dst, const float* src,
                                    int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <bool B> struct Flag { static constexpr bool value = B; };

__global__ void __launch_bounds__(THREADS, 1)
syrk_gram_kernel_tf32(const float* __restrict__ S, float* __restrict__ G,
                      int D, int R) {
  extern __shared__ __align__(16) float smem[];

  int bi, bj;
  tile_pair_panels(blockIdx.x, (D + TILE - 1) / TILE, &bi, &bj);
  const int r0 = bi * TILE, c0 = bj * TILE;
  const bool diag = bi == bj;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;        // fragment coordinates
  const int wm = warp >> 2, wn = warp & 3;      // 64-row x 32-column tile
  const uint32_t sbase =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  // loader: warp w stages rows 32w .. 32w+31 of a stage, rows 0-127 from
  // band i and 128-255 from band j; `rows` of its 32 lie in S
  const int grow0 = (warp < 4 ? r0 : c0) + (warp & 3) * 32;
  const int rows = min(max(D - grow0, 0), 32);
  const int KT = (R + BK - 1) / BK;

  // quarter q (rows 8q .. 8q+7 of the warp's 32) of slab kt's copies into
  // ring stage `stage`; FULL: those rows lie in S and the slab in R
  auto load = [&](auto full, int stage, int kt, int q) {
    constexpr bool FULL = decltype(full)::value;
    const int k = kt * BK + lane;          // lane -> column of each row
    const uint32_t dst =
        sbase + ((stage * STAGE_FLOATS + warp * 32 * LD) + lane) * 4;
    const float* src = S + static_cast<size_t>(grow0) * R + k;
#pragma unroll
    for (int lr = 8 * q; lr < 8 * q + 8; ++lr) {
      const uint32_t d = dst + lr * LD * 4;
      if (FULL) {
        cp4(d, src + static_cast<size_t>(lr) * R);
      } else {
        const bool ok = lr < rows && k < R;
        cp4(d, ok ? src + static_cast<size_t>(lr) * R : S, ok ? 4 : 0);
      }
    }
  };

  float acc[4][4][4], part[4][4][4];    // running sums; this slab's
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};

  // lane l addresses row l%8 (+8 for l%16 >= 8) and columns 4·(l/16)..+3
  // of a 16-row block: a0..a3 of an A fragment, or b0, b1 of two B ones
  const uint32_t lane_off =
      (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4) * 4;

  // slab kt's products, with the copies of slab kt + STAGES − 1 spread
  // over its steps; FULL as for load
  auto slab = [&](auto full, int kt) {
    constexpr bool FULL = decltype(full)::value;
    const int nk = kt + STAGES - 1;
    const uint32_t stage = sbase + (kt % STAGES) * STAGE_FLOATS * 4;
    const uint32_t As = stage + wm * 64 * LD * 4 + lane_off;
    const uint32_t Bs = stage + (TILE + wn * 32) * LD * 4 + lane_off;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      if (FULL || nk < KT) load(full, nk % STAGES, nk, s);
      uint32_t bh[4][2], bl[4][2];          // B[k][n] = S[c0 + n][k]
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t v[4];
        ldsm4(v, Bs + (nj * 16 * LD + s * 8) * 4);
        split(v[0], bh[2 * nj][0], bl[2 * nj][0]);
        split(v[2], bh[2 * nj][1], bl[2 * nj][1]);
        split(v[1], bh[2 * nj + 1][0], bl[2 * nj + 1][0]);
        split(v[3], bh[2 * nj + 1][1], bl[2 * nj + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {      // A[m][k] = S[r0 + m][k]
        uint32_t v[4], ah[4], al[4];
        ldsm4(v, As + (mi * 16 * LD + s * 8) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[e], ah[e], al[e]);
        // small terms first; the slab's first step starts from 0
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (s == 0) mma(part[mi][ni], al, bh[ni], zero);
          else mma(part[mi][ni], al, bh[ni], part[mi][ni]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(part[mi][ni], ah, bl[ni], part[mi][ni]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma(part[mi][ni], ah, bh[ni], part[mi][ni]);
      }
    }
    // the slab's partial sums into the running sums, rounded to nearest
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  };

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) {
#pragma unroll
      for (int q = 0; q < STEPS; ++q) load(Flag<false>(), st, st, q);
    }
    commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    wait_groups<STAGES - 2>();             // slab kt has landed, for this
    __syncthreads();                       // thread and all; kt−1 is read
    if (rows == 32 && (kt + STAGES) * BK <= R)
      slab(Flag<true>(), kt);
    else
      slab(Flag<false>(), kt);
    commit();
  }
  wait_groups<0>();

  // G_ij and its mirror G_ji, each element once, from one register
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int lr = wm * 64 + mi * 16 + g + (e >> 1) * 8;
        const int lc = wn * 32 + ni * 8 + 2 * t + (e & 1);
        const int r = r0 + lr, c = c0 + lc;
        if (r >= D || c >= D || (diag && lc > lr)) continue;
        G[static_cast<size_t>(r) * D + c] = acc[mi][ni][e];
        if (r != c) G[static_cast<size_t>(c) * D + r] = acc[mi][ni][e];
      }
}

// The ring is over 48 KB, so dynamic shared memory has to be allowed for
// the kernel; that is fixed for a device, so it is set on the first launch
// there and kept.
constexpr int MAX_DEVICES = 64;

int launch(const float* S, float* G, int D, int R, cudaStream_t s) {
  static std::atomic<bool> ready[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(syrk_gram_kernel_tf32,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready[dev].store(true, std::memory_order_relaxed);
  }
  syrk_gram_kernel_tf32<<<static_cast<unsigned>(tile_pairs(D)), THREADS,
                          SMEM, s>>>(S, G, D, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bfloat16 and float64: FMAs on CUDA cores
// ---------------------------------------------------------------------------
namespace simt {

constexpr int BK = 16;            // contraction slab staged in shared memory
constexpr int THREADS = 256;      // 16 x 16 threads, 8x8 elements each
constexpr int PAD = 4;            // keeps 16-byte alignment of each row
constexpr int LOADS = TILE * BK / THREADS;   // slab elements per thread (8)

template <typename In, typename Acc> struct Widen;
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
  // slab), so a warp reads 16 rows x 32 (bf16) or 128 (f64) contiguous
  // bytes
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
  syrk_gram_kernel<In, Acc><<<static_cast<unsigned>(tile_pairs(D)), THREADS,
                              0, s>>>(static_cast<const In*>(S),
                                      static_cast<Acc*>(G), D, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace simt

}  // namespace

extern "C" int syrk_gram(const void* S, void* G, int D, int R, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tc::launch(static_cast<const float*>(S), static_cast<float*>(G),
                      D, R, s);
  if (dtype == 1) return simt::launch<uint16_t, float>(S, G, D, R, s);
  if (dtype == 2) return simt::launch<double, double>(S, G, D, R, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
