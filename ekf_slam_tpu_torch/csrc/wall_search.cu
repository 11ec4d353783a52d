// The batched RANSAC wall search on Hopper: the initial scoring of NH
// trial lines and all T greedy rounds of find_walls_batched in one launch
// of one thread block.
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// score_lines_pallas (body _score_kernel), launched 1 + T times a scan by
// ekf_slam_tpu/ops/ransac.py find_walls_batched, together with the XLA
// work of its greedy rounds (the ``pick`` scan, ransac.py:337-355, with
// _finalize_wall, :199-230).  The plain version is
// ekf_slam_tpu_torch/ops/ransac.py wall_search_ref.  For round r:
//   best   = first argmax of the counts; ok = counts[best] > consensus
//   inl    = avail & dist(trial[best]) < inlier_dist      (sqrt form)
//   (m, b) = fit_line(inl); ok &= the fit is not degenerate
//   split_on_gap, split_on_kink (two passes each, when switched on),
//   refine_fit (refine_passes), fit_rms, the RMS gate, the statistics
//   [σθ², σc², t̄]
//   avail &= ~inl where ok; counts = score(avail) where ok; counts[best] = 0
// and out: lines[r] = (m, b), ok[r], stats[r]; after the last round avail.
// Where given, counts[r] gets the counts round r picks from (counts[T]
// those after the last round) and pools[r] the pool round r leaves.
//
// Bound: the scan is tiny (B = 1024 points, NH = 64 lines, T = 4 at the
// flagship settings: ~10 KB in, ~0.3 M distance tests and a few thousand
// flops of fitting), so bytes and operations bound it at nanoseconds.
// What bounds it is latency: each round is a chain of ~10 dependent
// block-wide steps (argmax, masks, five-sum reductions, sorts), and the
// plain version runs each as its own device operation (~100 a round)
// launched by the host.  The design keeps the chain inside one block of
// 1024 threads on one SM, serialised by __syncthreads(): one launch a
// scan, no host round trip between rounds.
//
// Layout: points [B,2], the working masks (avail, inl), the NH trial
// lines, trial_ok and the counts live in dynamic shared memory, with a
// sort buffer of the next power of two ≥ B floats: 10·B + 4·P2 + 13·NH
// bytes (points 8·B, sort keys 4·P2, lines 8·NH, counts 4·NH, avail B,
// inl B, trial_ok NH; with the 1,584 bytes of static scratch ≤ 227 KB: B
// up to 16,384 at NH = 64; the wrapper checks).
// Point i is always handled by thread i mod 1024, so its mask bytes need
// no barrier between the per-point passes; the sort and the scoring read
// across threads and sit behind barriers.
//
// Numerics (built with -fmad=false; every operation is also written with
// the round-to-nearest intrinsics):
// * the counts use score_lines.cuh's test (rsqrtf), so they are the
//   scoring kernel's (score_lines.cu) to the bit;
// * the inlier masks, chords and distances are rounded as the plain
//   version's PyTorch operations round them: products and sums one by one,
//   a correctly rounded sqrt (__fsqrt_rn) and division (__fdiv_rn);
// * the fit sums are f32, reduced per thread, then by warp shuffles, then
//   by one warp over the 32 partials: another order than PyTorch's, so
//   lines and statistics differ from the plain version's by rounding
//   (ekf_slam_tpu_torch/checks.py wall_search_tolerance);
// * the sort is a bitonic sort of the chords, padded with +inf: its
//   sorted values are torch.sort's;
// * thresholds are rounded to f32 as PyTorch rounds a Python float
//   compared with an f32 tensor; refine_fit's shrinking band is computed
//   in double, as Python does, then rounded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score_lines.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SUMS = 8;            // the kink pass fits two halves
constexpr int MAX_COUNTS = 2;

struct Params {
  int B, NH, T, P2;
  double inlier_dist;
  int consensus;
  int refine_passes;
  double refine_frac;
  int use_gap;
  float split_gap;
  int use_kink;
  float kink_rad;
  int use_rms;
  float max_rms;
};

// block-wide scratch: reduction partials (rows 0..31) and results (row 32)
struct Scratch {
  float f[WARPS + 1][MAX_SUMS];
  int c[WARPS + 1][MAX_COUNTS];
  float av[WARPS + 1];
  int ai[WARPS + 1];
};

struct Fit {
  float m, b;
  bool ok;
};

// Sums of NF floats and NC ints over the block, returned to every thread.
// Order: each thread's own points in index order, then shuffles within a
// warp, then one warp over the 32 partials.
template <int NF, int NC>
__device__ __forceinline__ void block_sum(float (&f)[NF], int (&c)[NC],
                                          Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < NF; ++k)
      f[k] = __fadd_rn(f[k], __shfl_down_sync(FULL, f[k], o));
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] += __shfl_down_sync(FULL, c[k], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) sh.f[warp][k] = f[k];
#pragma unroll
    for (int k = 0; k < NC; ++k) sh.c[warp][k] = c[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NF; ++k) f[k] = sh.f[lane][k];
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] = sh.c[lane][k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < NF; ++k)
        f[k] = __fadd_rn(f[k], __shfl_down_sync(FULL, f[k], o));
#pragma unroll
      for (int k = 0; k < NC; ++k) c[k] += __shfl_down_sync(FULL, c[k], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NF; ++k) sh.f[WARPS][k] = f[k];
#pragma unroll
      for (int k = 0; k < NC; ++k) sh.c[WARPS][k] = c[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NF; ++k) f[k] = sh.f[WARPS][k];
#pragma unroll
  for (int k = 0; k < NC; ++k) c[k] = sh.c[WARPS][k];
}

__device__ __forceinline__ int block_count(int n, Scratch& sh) {
  float f[1] = {0.0f};
  int c[1] = {n};
  block_sum<1, 1>(f, c, sh);
  return c[0];
}

// first maximum, as torch.argmax / jnp.argmax: the larger value, on a tie
// the smaller index
__device__ __forceinline__ void arg_better(float& v, int& i, float v2,
                                           int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void block_argmax(float& v, int& i, Scratch& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    arg_better(v, i, __shfl_down_sync(FULL, v, o),
               __shfl_down_sync(FULL, i, o));
  if (lane == 0) {
    sh.av[warp] = v;
    sh.ai[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = sh.av[lane];
    i = sh.ai[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      arg_better(v, i, __shfl_down_sync(FULL, v, o),
                 __shfl_down_sync(FULL, i, o));
    if (lane == 0) {
      sh.av[WARPS] = v;
      sh.ai[WARPS] = i;
    }
  }
  __syncthreads();
  v = sh.av[WARPS];
  i = sh.ai[WARPS];
}

// sqrt(m² + 1), the plain version's point_line_dist and _chord divisor
__device__ __forceinline__ float line_norm(float m) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(m, m), 1.0f));
}

__device__ __forceinline__ float dist(float m, float b, float nrm, float2 q) {
  return __fdiv_rn(fabsf(__fadd_rn(__fsub_rn(__fmul_rn(m, q.x), q.y), b)),
                   nrm);
}

__device__ __forceinline__ float chord(float m, float nrm, float2 q) {
  return __fdiv_rn(__fadd_rn(q.x, __fmul_rn(m, q.y)), nrm);
}

__device__ __forceinline__ void add_point(float* s, float2 q) {
  s[0] = __fadd_rn(s[0], q.x);
  s[1] = __fadd_rn(s[1], q.y);
  s[2] = __fadd_rn(s[2], __fmul_rn(q.x, q.x));
  s[3] = __fadd_rn(s[3], __fmul_rn(q.x, q.y));
}

// fit_line from its sums (ops/ransac.py fit_line, in its order of
// operations)
__device__ __forceinline__ Fit fit_from_sums(int cnt, const float* s) {
  const float sx = s[0], sy = s[1], sxx = s[2], sxy = s[3];
  const float n = static_cast<float>(cnt);
  const float n_safe = fmaxf(n, 1.0f);
  const float denom = __fsub_rn(sxx, __fdiv_rn(__fmul_rn(sx, sx), n_safe));
  Fit L;
  L.ok = (n >= 2.0f) && (fabsf(denom) > 1e-12f);
  const float ds = L.ok ? denom : 1.0f;
  L.m = __fdiv_rn(__fsub_rn(sxy, __fdiv_rn(__fmul_rn(sx, sy), n_safe)), ds);
  L.b = __fdiv_rn(__fsub_rn(sy, __fmul_rn(L.m, sx)), n_safe);
  return L;
}

// Ascending bitonic sort of keys[0 .. P2), P2 a power of two.
__device__ void bitonic_sort(float* keys, int P2) {
  for (int k = 2; k <= P2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < P2 / 2; p += THREADS) {
        const int i = (p / j) * 2 * j + (p % j);
        const float a = keys[i], c = keys[i + j];
        if ((i & k) == 0 ? (a > c) : (a < c)) {
          keys[i] = c;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// the chords of the inliers, +inf elsewhere, sorted; returns the inlier
// count
__device__ int sorted_chords(const Params& p, const float2* pts,
                             const uint8_t* inl, float m, float nrm,
                             float* keys, Scratch& sh) {
  int c = 0;
  for (int i = threadIdx.x; i < p.P2; i += THREADS) {
    float k = INFINITY;
    if (i < p.B && inl[i]) {
      k = chord(m, nrm, pts[i]);
      ++c;
    }
    keys[i] = k;
  }
  const int n = block_count(c, sh);     // its barriers publish the keys
  bitonic_sort(keys, p.P2);
  return n;
}

// inl ← inl & (t < cut) or inl & (t ≥ cut), refit; returns the fit
__device__ Fit keep_side(const Params& p, const float2* pts, uint8_t* inl,
                         float m, float nrm, float cut, bool left,
                         Scratch& sh) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int c[1] = {0};
  for (int i = threadIdx.x; i < p.B; i += THREADS) {
    if (!inl[i]) continue;
    const float t = chord(m, nrm, pts[i]);
    const bool keep = left ? (t < cut) : (t >= cut);
    inl[i] = keep;
    if (keep) {
      add_point(s, pts[i]);
      ++c[0];
    }
  }
  block_sum<4, 1>(s, c, sh);
  return fit_from_sums(c[0], s);
}

// one pass of split_on_gap
__device__ void gap_pass(const Params& p, const float2* pts, uint8_t* inl,
                         float* keys, float& m, float& b, Scratch& sh) {
  const float nrm = line_norm(m);
  const int n = sorted_chords(p, pts, inl, m, nrm, keys, sh);
  float gv = -INFINITY;
  int gi = 0x7fffffff;
  for (int j = threadIdx.x; j < p.B - 1; j += THREADS)
    arg_better(gv, gi,
               j < n - 1 ? __fsub_rn(keys[j + 1], keys[j]) : -INFINITY, j);
  block_argmax(gv, gi, sh);
  if (!(gv > p.split_gap)) return;                  // uniform: no gap
  const float cut = __fmul_rn(0.5f, __fadd_rn(keys[gi], keys[gi + 1]));
  int c = 0;
  for (int i = threadIdx.x; i < p.B; i += THREADS)
    c += inl[i] && chord(m, nrm, pts[i]) < cut;
  const int nl = block_count(c, sh);
  const Fit L = keep_side(p, pts, inl, m, nrm, cut, nl * 2 >= n, sh);
  if (L.ok) {
    m = L.m;
    b = L.b;
  }
}

// one pass of split_on_kink
__device__ void kink_pass(const Params& p, const float2* pts, uint8_t* inl,
                          float* keys, float& m, float& b, Scratch& sh) {
  const float nrm = line_norm(m);
  const int n = sorted_chords(p, pts, inl, m, nrm, keys, sh);
  const float med = keys[min(max(n / 2, 0), p.B - 1)];
  float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int c[2] = {0, 0};
  for (int i = threadIdx.x; i < p.B; i += THREADS) {
    if (!inl[i]) continue;
    if (chord(m, nrm, pts[i]) < med) {
      add_point(s, pts[i]);
      ++c[0];
    } else {
      add_point(s + 4, pts[i]);
      ++c[1];
    }
  }
  block_sum<8, 2>(s, c, sh);
  const Fit Ll = fit_from_sums(c[0], s), Lr = fit_from_sums(c[1], s + 4);
  const float kink = fabsf(__fsub_rn(atanf(Ll.m), atanf(Lr.m)));
  if (!(Ll.ok && Lr.ok && kink > p.kink_rad)) return;   // uniform
  const float dd = __fsub_rn(Ll.m, Lr.m);
  const float dm = fabsf(dd) < 1e-9f ? 1.0f : dd;
  const float xi = __fdiv_rn(__fsub_rn(Lr.b, Ll.b), dm);
  const float yi = __fadd_rn(__fmul_rn(Ll.m, xi), Ll.b);
  const float ti = __fdiv_rn(__fadd_rn(xi, __fmul_rn(m, yi)), nrm);
  int cl[2] = {0, 0};
  for (int i = threadIdx.x; i < p.B; i += THREADS) {
    if (!inl[i]) continue;
    if (chord(m, nrm, pts[i]) < ti)
      ++cl[0];
    else
      ++cl[1];
  }
  float dummy[1] = {0.0f};
  block_sum<1, 2>(dummy, cl, sh);
  const Fit L = keep_side(p, pts, inl, m, nrm, ti, cl[0] >= cl[1], sh);
  if (L.ok) {
    m = L.m;
    b = L.b;
  }
}

// counts of every line h ≠ skip over the points where mask is set;
// trial_ok (when given) zeroes the lines that failed their seeding
__device__ void score_all(const Params& p, const float2* pts,
                          const uint8_t* mask, const float2* lns,
                          const uint8_t* tok, int skip, float thresh,
                          int* cnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < p.NH; h += WARPS) {
    if (h == skip) continue;                        // uniform in the warp
    const float2 l = lns[h];
    const float inv = score_inv_norm(l.x);
    int c = 0;
    for (int i = lane; i < p.B; i += 32) {
      const float2 q = pts[i];
      c += mask[i] && score_is_inlier(l.x, l.y, inv, q.x, q.y, thresh);
    }
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) cnt[h] = (tok == nullptr || tok[h]) ? c : 0;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
wall_search_kernel(const float* __restrict__ points,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ trial,
                   const uint8_t* __restrict__ trial_ok, const Params p,
                   float* __restrict__ lines_out,
                   uint8_t* __restrict__ ok_out,
                   uint8_t* __restrict__ avail_out,
                   float* __restrict__ stats_out,
                   int32_t* __restrict__ counts_out,
                   uint8_t* __restrict__ pools_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Scratch sh;
  const int B = p.B, NH = p.NH, tid = threadIdx.x;
  float2* pts = reinterpret_cast<float2*>(smem);
  float* keys = reinterpret_cast<float*>(pts + B);
  float2* lns = reinterpret_cast<float2*>(keys + p.P2);
  int* cnt = reinterpret_cast<int*>(lns + NH);
  uint8_t* avail = reinterpret_cast<uint8_t*>(cnt + NH);
  uint8_t* inl = avail + B;
  uint8_t* tok = inl + B;

  for (int i = tid; i < B; i += THREADS) {
    pts[i] = make_float2(points[2 * i], points[2 * i + 1]);
    avail[i] = valid[i] != 0;
  }
  for (int h = tid; h < NH; h += THREADS) {
    lns[h] = make_float2(trial[2 * h], trial[2 * h + 1]);
    tok[h] = trial_ok[h] != 0;
  }
  __syncthreads();
  const float band = static_cast<float>(p.inlier_dist);
  score_all(p, pts, avail, lns, tok, -1, band, cnt);
  __syncthreads();
  if (counts_out != nullptr)
    for (int h = tid; h < NH; h += THREADS) counts_out[h] = cnt[h];

  for (int r = 0; r < p.T; ++r) {
    // the round's winner, and the inliers of its trial line
    float bv = -INFINITY;
    int best = 0x7fffffff;
    for (int h = tid; h < NH; h += THREADS)
      arg_better(bv, best, static_cast<float>(cnt[h]), h);
    block_argmax(bv, best, sh);
    bool ok = cnt[best] > p.consensus;
    const float2 tl = lns[best];
    const float tn = line_norm(tl.x);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int c[1] = {0};
    for (int i = tid; i < B; i += THREADS) {
      const bool a = avail[i] && dist(tl.x, tl.y, tn, pts[i]) < band;
      inl[i] = a;
      if (a) {
        add_point(s, pts[i]);
        ++c[0];
      }
    }
    block_sum<4, 1>(s, c, sh);
    const Fit L = fit_from_sums(c[0], s);
    ok = ok && L.ok;
    float m = L.m, b = L.b;

    // _finalize_wall: splits, refits, the RMS gate and the statistics
    if (p.use_gap)
      for (int k = 0; k < 2; ++k) gap_pass(p, pts, inl, keys, m, b, sh);
    if (p.use_kink)
      for (int k = 0; k < 2; ++k) kink_pass(p, pts, inl, keys, m, b, sh);
    double thr = p.inlier_dist;
    for (int k = 0; k < p.refine_passes; ++k) {
      thr *= p.refine_frac;
      const float tf = static_cast<float>(thr);
      const float nrm = line_norm(m);
      float sr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int cr[1] = {0};
      for (int i = tid; i < B; i += THREADS) {
        if (avail[i] && dist(m, b, nrm, pts[i]) < tf) {
          add_point(sr, pts[i]);
          ++cr[0];
        }
      }
      block_sum<4, 1>(sr, cr, sh);
      const Fit R = fit_from_sums(cr[0], sr);
      if (R.ok) {
        m = R.m;
        b = R.b;
      }
    }
    const float nrm = line_norm(m);
    float sq[2] = {0.0f, 0.0f};                 // Σ d², Σ t over inl
    int ni[1] = {0};
    for (int i = tid; i < B; i += THREADS) {
      if (!inl[i]) continue;
      const float d = dist(m, b, nrm, pts[i]);
      sq[0] = __fadd_rn(sq[0], __fmul_rn(d, d));
      sq[1] = __fadd_rn(sq[1], chord(m, nrm, pts[i]));
      ++ni[0];
    }
    block_sum<2, 1>(sq, ni, sh);
    const float nf = static_cast<float>(ni[0]);
    const float rms = __fsqrt_rn(__fdiv_rn(sq[0], fmaxf(nf, 1.0f)));
    const float n2 = fmaxf(nf, 2.0f);
    const float tbar = __fdiv_rn(sq[1], n2);
    float sv[1] = {0.0f};
    int dummy[1] = {0};
    for (int i = tid; i < B; i += THREADS) {
      if (!inl[i]) continue;
      const float e = __fsub_rn(chord(m, nrm, pts[i]), tbar);
      sv[0] = __fadd_rn(sv[0], __fmul_rn(e, e));
    }
    block_sum<1, 1>(sv, dummy, sh);
    const float vart = fmaxf(__fdiv_rn(sv[0], n2), 1e-6f);
    const float rc = fmaxf(rms, 0.01f);
    const float r2 = __fmul_rn(rc, rc);
    ok = ok && (!p.use_rms || rms < p.max_rms);

    // the pool shrinks by an accepted wall's inliers; re-score
    if (ok)
      for (int i = tid; i < B; i += THREADS)
        if (inl[i]) avail[i] = 0;
    if (pools_out != nullptr)
      for (int i = tid; i < B; i += THREADS) pools_out[r * B + i] = avail[i];
    __syncthreads();
    if (ok) score_all(p, pts, avail, lns, nullptr, best, band, cnt);
    if (tid == 0) {
      cnt[best] = 0;
      lines_out[2 * r] = m;
      lines_out[2 * r + 1] = b;
      ok_out[r] = ok;
      stats_out[3 * r] = __fdiv_rn(r2, __fmul_rn(n2, vart));
      stats_out[3 * r + 1] = __fdiv_rn(r2, n2);
      stats_out[3 * r + 2] = tbar;
    }
    __syncthreads();
    if (counts_out != nullptr)
      for (int h = tid; h < NH; h += THREADS)
        counts_out[(r + 1) * NH + h] = cnt[h];
  }
  for (int i = tid; i < B; i += THREADS) avail_out[i] = avail[i];
}

}  // namespace

// Dynamic shared memory of one launch (the layout above).
extern "C" long long wall_search_smem(int B, int NH) {
  long long P2 = 2;
  while (P2 < B) P2 <<= 1;
  return 10LL * B + 4LL * P2 + 13LL * NH;
}

// The most dynamic shared memory a launch on ``device`` may ask for: the
// block's opt-in limit less the kernel's static scratch; on a CUDA error
// the error code, negated.
extern "C" long long wall_search_smem_limit(int device) {
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, wall_search_kernel);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return static_cast<long long>(optin) -
         static_cast<long long>(fa.sharedSizeBytes);
}

// The name of a CUDA error code (cudaGetErrorName).
extern "C" const char* wall_search_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

extern "C" int wall_search(const void* points, const void* valid,
                           const void* trial, const void* trial_ok, int B,
                           int NH, int T, double inlier_dist, int consensus,
                           int refine_passes, double refine_frac, int use_gap,
                           float split_gap, int use_kink, float kink_rad,
                           int use_rms, float max_rms, void* lines, void* ok,
                           void* avail, void* stats, void* counts,
                           void* pools, void* stream) {
  Params p;
  p.B = B;
  p.NH = NH;
  p.T = T;
  p.P2 = 2;
  while (p.P2 < B) p.P2 <<= 1;
  p.inlier_dist = inlier_dist;
  p.consensus = consensus;
  p.refine_passes = refine_passes;
  p.refine_frac = refine_frac;
  p.use_gap = use_gap;
  p.split_gap = split_gap;
  p.use_kink = use_kink;
  p.kink_rad = kink_rad;
  p.use_rms = use_rms;
  p.max_rms = max_rms;
  const int smem = static_cast<int>(wall_search_smem(B, NH));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wall_search_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wall_search_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(trial), static_cast<const uint8_t*>(trial_ok),
      p, static_cast<float*>(lines), static_cast<uint8_t*>(ok),
      static_cast<uint8_t*>(avail), static_cast<float*>(stats),
      static_cast<int32_t*>(counts), static_cast<uint8_t*>(pools));
  return static_cast<int>(cudaGetLastError());
}
