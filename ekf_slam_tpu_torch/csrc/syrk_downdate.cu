// Symmetric rank-R covariance downdate P <- P - W·Wᵀ, in place, on Hopper.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// syrk_downdate_pallas (bodies _syrk_kernel / _syrk_kernel_wres): the
// EKF's rank-2M correction Kg·(H·P) = W·Wᵀ with W = PHᵀ·L⁻ᵀ.  Only the
// lower-triangle tile pairs (i >= j) are computed; each writes P_ij - acc
// and, for i != j, the mirror P_ji - accᵀ from the SAME f32 accumulator,
// so an input P that is bit-symmetric leaves bit-symmetric (the TPU's
// identity-matmul transpose becomes a read of the accumulator through
// shared memory).
//
// Bound (D = 20480, bf16 P and W): the function must read P once and
// write it once, 2·D²·2 B = 1.68 GB, >= 0.50 ms at 3.35 TB/s, and form
// D²·R products (half of W·Wᵀ, by symmetry).
//   * R = 16 (a tick's 8 observations): 6.7 GFLOP, ~7 µs at the bf16
//     tensor rate, so memory bound ~70x: the kernel is a P stream.
//   * R = 1024 (a 512-observation chunk of the 10k batched update):
//     4.3e11 FLOP, 0.43 ms at the dense bf16 tensor rate, against 0.51 ms
//     of bytes; on CUDA-core f32 FMAs (67 TFLOP/s) it would be >= 6.4 ms.
//     Every 128x128 tile pair also re-reads its two W row bands: 12,880
//     pairs x 512 KB = 6.8 GB from L2, the largest traffic of the call.
//
// bf16 P/W (dtype 1), what each part of the design does about that bound:
//   * Tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32, fed by ldmatrix
//     from padded shared memory (no bank conflicts).  A bf16 product is
//     exact in f32, so the kernel forms exactly the products of the plain
//     version (widen to f32, W·Wᵀ); only the order of the f32 sums
//     differs.  8 warps own 64x32 sub-tiles of a 128x128 output tile; each
//     k16 step reads all its fragments before its 16 MMAs.
//   * The tile is 128x128 because the W bands' L2 traffic falls as 1/tile
//     while the accumulator (64 f32 registers a thread) and the shared
//     memory (both P tiles, 68 KB, and the W ring) must fit.
//   * Two shapes of the W ring (cp.async, 16-byte copies), by rank: up to
//     R = 32 one slab of 32 in a 2-stage ring, 110.6 KB, so two blocks an
//     SM keep the P stream going; above it slabs of 64 in a 4-stage ring,
//     217 KB, one block an SM, so three slabs are in flight while one is
//     multiplied.  A slab past R, and rows past D, are zero-filled in
//     shared memory, so W is never padded in device memory.
//   * P streams beside the product: each pair's P_ij and P_ji tiles go out
//     as cp.async (256-byte row runs, L2 evict-first) right after the ring's
//     first slabs, which therefore do not wait for them.  At a wide rank
//     the block also asks L2 for its next pair's tiles (prefetch), so they
//     come from DRAM while this pair computes; in the R <= 32 stream, with
//     no product to hide it behind, that prefetch slowed the kernel on an
//     H100, so it is off there.  The result goes back from shared memory
//     in 16-byte streaming stores.
//   * Persistent blocks (as many as fit) walk the tile pairs in 8x8
//     groups: the blocks that run together share 8 row and 8 column bands
//     of W in L2 and read 2 KB runs of each P row between them.
//   * One accumulator per pair of outputs: out_ij = P_ij - acc and
//     out_ji = P_ji - accᵀ in shared memory.  On a diagonal tile, (r, c)
//     and (c, r) both come from the one accumulator element with r >= c
//     (two MMA fragments need not round alike).
//   * Ragged tiles (any D) are masked; rows whose start is not 16-byte
//     aligned take a scalar path for P, and so does W when R·2 bytes is
//     not a multiple of 16.
// f32 P/W (dtype 0): full f32 FMAs on CUDA cores (no TF32), one block per
// 64x64 tile pair, the P loads of both tiles issued before the product.
// Both accumulate in f32 and round to nearest-even on the way out.

#include <atomic>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Linear pair index -> lower-triangle tile pair (i >= j), row-major.
__device__ __forceinline__ void tile_pair(long long k, int* i, int* j) {
  long long r = static_cast<long long>(
      (sqrt(8.0 * static_cast<double>(k) + 1.0) - 1.0) * 0.5);
  while ((r + 1) * (r + 2) / 2 <= k) ++r;
  while (r * (r + 1) / 2 > k) --r;
  *i = static_cast<int>(r);
  *j = static_cast<int>(k - r * (r + 1) / 2);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, persistent blocks
// ---------------------------------------------------------------------------

constexpr int BT = 128;                // output tile edge
constexpr int THREADS = 256;           // 8 warps: 2 (rows) x 4 (columns)
constexpr int PLD = BT + 8;            // padded P tile row: 272 B
constexpr int P_TILE = BT * PLD;       // elements
constexpr int P_CHUNKS = BT * BT / 8 / THREADS;   // 16-byte chunks a thread
constexpr int ST = 8;                  // pairs are walked in ST x ST groups

// The two shapes of the rank ring: a tick's rank (R <= 32) is one slab,
// and the kernel is a P stream that wants two blocks an SM; a wide rank
// is compute, and wants a deep ring, so one block an SM.
template <int BK_, int STAGES_, int MINB_, bool PREFETCH_>
struct Ring {
  static constexpr int BK = BK_, STAGES = STAGES_, MINB = MINB_;
  static constexpr bool PREFETCH = PREFETCH_;   // ask L2 for the next pair
  static constexpr int WLD = BK + 8;   // padded slab row (bank-conflict free)
  static constexpr int W_BAND = BT * WLD;
  static constexpr int W_STAGE = 2 * W_BAND;
  static constexpr int SMEM = (2 * P_TILE + STAGES * W_STAGE) * 2;  // bytes
};
using Narrow = Ring<32, 2, 2, false>;  // 110,592 B of shared memory
using Wide = Ring<64, 4, 1, true>;     // 217,088 B

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16_first(uint32_t dst,
                                                 const void* src,
                                                 int src_bytes,
                                                 uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::
          "r"(dst),
      "l"(src), "r"(src_bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ uint16_t to_bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Slot k of the walk -> tile pair (i, j): slots run over ST x ST groups of
// tile pairs, the groups in row-major lower-triangle order, so the blocks
// that run together share ST row bands and ST column bands of W (in L2)
// and read 2 KB runs of each P row between them.  False where the slot is
// above the diagonal or past the last tile.
__device__ __forceinline__ bool tile_slot(long long k, int T, int* i,
                                          int* j) {
  int gi, gj;
  tile_pair(k / (ST * ST), &gi, &gj);
  const int w = static_cast<int>(k % (ST * ST));
  *i = gi * ST + w / ST;
  *j = gj * ST + w % ST;
  return *i < T && *j <= *i;
}

// The P tile at (row0, col0) into s (row stride PLD); zeros outside D.
__device__ __forceinline__ void load_p_tile(uint16_t* s,
                                            const uint16_t* __restrict__ P,
                                            int D, int row0, int col0,
                                            int vec_ok, uint64_t policy) {
  const int tid = threadIdx.x;
  if (vec_ok) {                 // D % 8 == 0: a chunk is all in or all out
#pragma unroll
    for (int n = 0; n < P_CHUNKS; ++n) {
      const int q = tid + n * THREADS, r = q >> 4, c = (q & 15) * 8;
      const bool in = row0 + r < D && col0 + c < D;
      const uint16_t* src =
          in ? P + static_cast<size_t>(row0 + r) * D + col0 + c : P;
      cp_async16_first(smem_addr(s + r * PLD + c), src, in ? 16 : 0, policy);
    }
    return;
  }
  for (int e = tid; e < BT * BT; e += THREADS) {
    const int r = e >> 7, c = e & (BT - 1);
    s[r * PLD + c] = (row0 + r < D && col0 + c < D)
                         ? P[static_cast<size_t>(row0 + r) * D + col0 + c]
                         : uint16_t(0);
  }
}

// Ask L2 for the P tile at (row0, col0): two 128-byte lines a row.
__device__ __forceinline__ void prefetch_p_tile(const uint16_t* P, int D,
                                                int row0, int col0) {
  const int r = threadIdx.x >> 1, c = (threadIdx.x & 1) * 64;
  if (row0 + r < D && col0 + c < D)
    asm volatile("prefetch.global.L2::evict_last [%0];\n" ::"l"(
        P + static_cast<size_t>(row0 + r) * D + col0 + c));
}

// Rank slab k0 .. k0+BK of W's row bands r0 and c0 into one ring stage.
template <class C>
__device__ __forceinline__ void load_w_slab(uint16_t* s,
                                            const uint16_t* __restrict__ W,
                                            int D, int R, int r0, int c0,
                                            int k0, int w_vec) {
  constexpr int KC = C::BK / 8;        // 16-byte chunks a slab row
  const int tid = threadIdx.x;
  if (w_vec) {                  // R % 8 == 0: a chunk is all in or all out
#pragma unroll
    for (int n = 0; n < 2 * BT * KC / THREADS; ++n) {
      const int q = tid + n * THREADS;
      const int band = q / (BT * KC), r = (q / KC) % BT, kc = (q % KC) * 8;
      const int row = (band ? c0 : r0) + r;
      const bool in = row < D && k0 + kc < R;
      const uint16_t* src =
          in ? W + static_cast<size_t>(row) * R + k0 + kc : W;
      cp_async16(smem_addr(s + band * C::W_BAND + r * C::WLD + kc), src,
                 in ? 16 : 0);
    }
    return;
  }
  for (int e = tid; e < 2 * BT * C::BK; e += THREADS) {
    const int band = e / (BT * C::BK), r = (e / C::BK) % BT;
    const int kk = e % C::BK, row = (band ? c0 : r0) + r, k = k0 + kk;
    s[band * C::W_BAND + r * C::WLD + kk] =
        (row < D && k < R) ? W[static_cast<size_t>(row) * R + k]
                           : uint16_t(0);
  }
}

// One k16 step of the warp's 64x32 sub-tile: every fragment of the step
// is loaded (ldmatrix) before its 16 MMAs are issued.
template <class C>
__device__ __forceinline__ void mma_step(float (&acc)[4][4][4],
                                         const uint16_t* sA,
                                         const uint16_t* sB, int kk,
                                         int lane, int wm, int wn) {
  uint32_t a[4][4], b[4][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int nrow = wn * 32 + h * 16 + (lane & 7) + ((lane >> 4) << 3);
    const int kcol = kk + (((lane >> 3) & 1) << 3);
    ldmatrix_x4(smem_addr(sB + nrow * C::WLD + kcol), b[2 * h][0],
                b[2 * h][1], b[2 * h + 1][0], b[2 * h + 1][1]);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int mrow = wm * 64 + mi * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
    const int kcol = kk + ((lane >> 4) << 3);
    ldmatrix_x4(smem_addr(sA + mrow * C::WLD + kcol), a[mi][0], a[mi][1],
                a[mi][2], a[mi][3]);
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
}

template <class C>
__global__ void __launch_bounds__(THREADS, C::MINB)
syrk_downdate_kernel_bf16(uint16_t* __restrict__ P,
                          const uint16_t* __restrict__ W, int D, int R,
                          int T, long long slots, int vec_ok, int w_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sPa = reinterpret_cast<uint16_t*>(smem);     // P_ij
  uint16_t* sPb = sPa + P_TILE;                          // P_ji
  uint16_t* sW = sPb + P_TILE;                           // the W ring

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;               // 64x32 sub-tile
  const int g = lane >> 2, t = lane & 3;
  const int nslab = (R + C::BK - 1) / C::BK;
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(evict_first));

  for (long long p = blockIdx.x; p < slots; p += gridDim.x) {
    int bi, bj;
    if (!tile_slot(p, T, &bi, &bj)) continue;            // block-uniform
    const int r0 = bi * BT, c0 = bj * BT;
    const bool mirror = bi != bj;

    // 1. the ring's first slabs, this pair's P tiles (committed after
    // them, so the first slabs need not wait for P), and an L2 prefetch
    // of this block's next pair
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {
      if (s < nslab)
        load_w_slab<C>(sW + s * C::W_STAGE, W, D, R, r0, c0, s * C::BK,
                       w_vec);
      cp_async_commit();
    }
    load_p_tile(sPa, P, D, r0, c0, vec_ok, evict_first);
    if (mirror) load_p_tile(sPb, P, D, c0, r0, vec_ok, evict_first);
    cp_async_commit();
    for (long long pn = p + gridDim.x; C::PREFETCH && pn < slots;
         pn += gridDim.x) {
      int ni, nj;
      if (tile_slot(pn, T, &ni, &nj)) {
        prefetch_p_tile(P, D, ni * BT, nj * BT);
        if (ni != nj) prefetch_p_tile(P, D, nj * BT, ni * BT);
        break;
      }
    }

    // 2. acc = W_i·W_jᵀ over the rank, slab by slab through the ring
    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int s = 0; s < nslab; ++s) {
      // slab s has landed (the P group, younger than the first slabs,
      // only from slab STAGES-1 on) ...
      if (s < C::STAGES - 1)
        cp_async_wait<C::STAGES - 1>();
      else
        cp_async_wait<C::STAGES - 2>();
      __syncthreads();     // ... for every thread; and the stage that slab
                           // s+STAGES-1 reuses is free
      const int sn = s + C::STAGES - 1;
      if (sn < nslab)
        load_w_slab<C>(sW + (sn % C::STAGES) * C::W_STAGE, W, D, R, r0, c0,
                       sn * C::BK, w_vec);
      cp_async_commit();
      const uint16_t* sA = sW + (s % C::STAGES) * C::W_STAGE;   // band i
      const uint16_t* sB = sA + C::W_BAND;                      // band j
      const int kmax = min(C::BK, R - s * C::BK);
      if (kmax == C::BK) {
#pragma unroll
        for (int kk = 0; kk < C::BK; kk += 16)
          mma_step<C>(acc, sA, sB, kk, lane, wm, wn);
      } else {
        for (int kk = 0; kk < kmax; kk += 16)
          mma_step<C>(acc, sA, sB, kk, lane, wm, wn);
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 3. out_ij = P_ij - acc, out_ji = P_ji - accᵀ, in shared memory
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 64 + mi * 16 + g + h * 8;
          const int c = wn * 32 + ni * 8 + 2 * t;
          const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
          if (mirror) {
            __nv_bfloat162* pa =
                reinterpret_cast<__nv_bfloat162*>(sPa + r * PLD + c);
            const float2 f = __bfloat1622float2(*pa);
            *pa = __floats2bfloat162_rn(f.x - v0, f.y - v1);
            uint16_t* pb = sPb + c * PLD + r;
            pb[0] = to_bf(bf(pb[0]) - v0);
            pb[PLD] = to_bf(bf(pb[PLD]) - v1);
          } else {
            // diagonal tile: (r, c) and (c, r) from the element r >= c
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int cc = c + e;
              const float v = e ? v1 : v0;
              if (r >= cc) {
                uint16_t* lo = sPa + r * PLD + cc;
                *lo = to_bf(bf(*lo) - v);
                if (r > cc) {
                  uint16_t* up = sPa + cc * PLD + r;
                  *up = to_bf(bf(*up) - v);
                }
              }
            }
          }
        }
    __syncthreads();

    // 4. write back: 16-byte streaming stores of 256-byte row runs
    if (vec_ok) {
#pragma unroll
      for (int n = 0; n < P_CHUNKS; ++n) {
        const int q = tid + n * THREADS, r = q >> 4, c = (q & 15) * 8;
        if (r0 + r < D && c0 + c < D)
          __stcs(reinterpret_cast<uint4*>(
                     P + static_cast<size_t>(r0 + r) * D + c0 + c),
                 *reinterpret_cast<const uint4*>(sPa + r * PLD + c));
        if (mirror && c0 + r < D && r0 + c < D)
          __stcs(reinterpret_cast<uint4*>(
                     P + static_cast<size_t>(c0 + r) * D + r0 + c),
                 *reinterpret_cast<const uint4*>(sPb + r * PLD + c));
      }
    } else {
      for (int e = tid; e < BT * BT; e += THREADS) {
        const int r = e >> 7, c = e & (BT - 1);
        if (r0 + r < D && c0 + c < D)
          P[static_cast<size_t>(r0 + r) * D + c0 + c] = sPa[r * PLD + c];
        if (mirror && c0 + r < D && r0 + c < D)
          P[static_cast<size_t>(c0 + r) * D + r0 + c] = sPb[r * PLD + c];
      }
    }
    __syncthreads();       // the next pair's loads overwrite the tiles
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, one block per 64x64 tile pair
// ---------------------------------------------------------------------------

constexpr int TILE32 = 64;
constexpr int RK32 = 32;               // rank chunk staged in shared memory

__global__ void __launch_bounds__(THREADS)
syrk_downdate_kernel_f32(float* __restrict__ P, const float* __restrict__ W,
                         int D, int R, int vec_ok) {
  constexpr int VPR = TILE32 / 4;                   // 16-byte vectors a row
  constexpr int NV = TILE32 * VPR / THREADS;        // vectors a thread
  __shared__ float sWi[TILE32][RK32 + 1];
  __shared__ float sWj[TILE32][RK32 + 1];
  __shared__ float sAcc[TILE32][TILE32 + 1];

  int bi, bj;
  tile_pair(blockIdx.x, &bi, &bj);
  const int r0 = bi * TILE32, c0 = bj * TILE32;
  const int tid = threadIdx.x;
  const bool mirror = bi != bj;
  const bool fast = vec_ok && (r0 + TILE32 <= D) && (c0 + TILE32 <= D);

  // 1. issue this thread's P loads of both tiles (fast path only)
  float4 pa[NV], pb[NV];
  if (fast) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int v = tid + n * THREADS;
      const int rr = v / VPR, cc = (v % VPR) * 4;
      pa[n] = *reinterpret_cast<const float4*>(
          P + static_cast<size_t>(r0 + rr) * D + c0 + cc);
      if (mirror)
        pb[n] = *reinterpret_cast<const float4*>(
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
  for (int k0 = 0; k0 < R; k0 += RK32) {
    for (int e = tid; e < TILE32 * RK32; e += THREADS) {
      const int rr = e / RK32, kk = e % RK32, k = k0 + kk;
      float wi = 0.f, wj = 0.f;
      if (k < R) {
        if (r0 + rr < D) wi = W[static_cast<size_t>(r0 + rr) * R + k];
        if (c0 + rr < D) wj = W[static_cast<size_t>(c0 + rr) * R + k];
      }
      sWi[rr][kk] = wi;
      sWj[rr][kk] = wj;
    }
    __syncthreads();
    const int kmax = min(RK32, R - k0);
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
      const int rr = v / VPR, cc = (v % VPR) * 4;
      pa[n].x -= sAcc[rr][cc];
      pa[n].y -= sAcc[rr][cc + 1];
      pa[n].z -= sAcc[rr][cc + 2];
      pa[n].w -= sAcc[rr][cc + 3];
      *reinterpret_cast<float4*>(
          P + static_cast<size_t>(r0 + rr) * D + c0 + cc) = pa[n];
      if (mirror) {
        pb[n].x -= sAcc[cc][rr];
        pb[n].y -= sAcc[cc + 1][rr];
        pb[n].z -= sAcc[cc + 2][rr];
        pb[n].w -= sAcc[cc + 3][rr];
        *reinterpret_cast<float4*>(
            P + static_cast<size_t>(c0 + rr) * D + r0 + cc) = pb[n];
      }
    }
    return;
  }
  for (int e = tid; e < TILE32 * TILE32; e += THREADS) {
    const int rr = e / TILE32, cc = e % TILE32;
    if (r0 + rr < D && c0 + cc < D) {
      float* p = P + static_cast<size_t>(r0 + rr) * D + c0 + cc;
      *p -= sAcc[rr][cc];
    }
    if (mirror && c0 + rr < D && r0 + cc < D) {
      float* p = P + static_cast<size_t>(c0 + rr) * D + r0 + cc;
      *p -= sAcc[cc][rr];
    }
  }
}

// One persistent block per resident slot of the card, at most one a pair.
// The resident count and the shared-memory attribute are fixed for a
// device, so each is set on the first launch there and kept.
constexpr int MAX_DEVICES = 64;

template <class C>
int launch_bf16(void* P, const void* W, int D, int R, int T,
                long long slots, int vec_ok, int w_vec, cudaStream_t s) {
  static std::atomic<int> resident[MAX_DEVICES];   // zero until first set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEVICES)
    return static_cast<int>(cudaErrorInvalidDevice);
  int held = resident[dev].load(std::memory_order_relaxed);
  if (held == 0) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(syrk_downdate_kernel_bf16<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, syrk_downdate_kernel_bf16<C>, THREADS, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    held = per_sm * sms;
    resident[dev].store(held, std::memory_order_relaxed);
  }
  const long long pairs = static_cast<long long>(T) * (T + 1) / 2;
  const long long blocks = held < pairs ? held : pairs;
  syrk_downdate_kernel_bf16<C><<<static_cast<unsigned>(blocks), THREADS,
                                 C::SMEM, s>>>(
      static_cast<uint16_t*>(P), static_cast<const uint16_t*>(W), D, R, T,
      slots, vec_ok, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P <- P - W·Wᵀ in place.  dtype: 0 = float32, 1 = bfloat16 (raw uint16
// bits).  vec_ok: P's rows start 16-byte aligned (D·element size % 16 == 0
// and P aligned).  Returns a CUDA error code (0 on success).
extern "C" int syrk_downdate(void* P, const void* W, int D, int R,
                             int dtype, int vec_ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 1 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    const long long T = (D + TILE32 - 1) / TILE32;
    syrk_downdate_kernel_f32<<<static_cast<unsigned>(T * (T + 1) / 2),
                               THREADS, 0, s>>>(
        static_cast<float*>(P), static_cast<const float*>(W), D, R, vec_ok);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int T = (D + BT - 1) / BT;
  const long long groups = (T + ST - 1) / ST;
  const long long slots = groups * (groups + 1) / 2 * ST * ST;
  const int w_vec = (R * 2) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(W) % 16 == 0;
  return R <= Narrow::BK
             ? launch_bf16<Narrow>(P, W, D, R, T, slots, vec_ok, w_vec, s)
             : launch_bf16<Wide>(P, W, D, R, T, slots, vec_ok, w_vec, s);
}
