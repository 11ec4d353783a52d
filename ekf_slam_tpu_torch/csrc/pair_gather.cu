// Row-pair gather on Hopper: out[2i : 2i+2, :] = P[starts[i] : starts[i]+2, :].
//
// Replaces the Pallas TPU kernel ekf_slam_tpu/ops/pallas/kernels.py
// pair_gather_pallas (body _pair_gather_kernel).  The batched update in
// rows mode reads P·Hᵀ as the observed rows of P: the pose rows and one
// contiguous row pair per gated landmark (models/batched.hp_from_rows).
//
// Bound: at the session's shape (8 pairs, D = 20003, f32) the call copies
// 2·8·D·4 B = 1.28 MB and writes as much: 0.76 µs at 3.35 TB/s.  Its floor
// is one launch's latency.  The TPU kernel DMAs tile-aligned windows and
// rotates the pair into place because the TPU cannot DMA single rows; a
// CUDA block reads any row directly, so this kernel does nothing of that:
// grid (pairs, column chunks), each thread copies a few elements of both
// rows of its pair, neighbouring threads on neighbouring addresses.
//
// The starts are read from device memory by each block, so the caller
// never copies them to the host.  Guard: each start is clamped into
// [0, rows − 2] before use, so no start can make the kernel read outside
// P; the callers already keep starts in that range (slots are clamped),
// and the plain version clamps the same way.
//
// Element types: 4-byte (float32) and 2-byte (bfloat16) copied as raw
// bits; starts int32 or int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int CHUNK = THREADS * PER_THREAD;   // columns per block

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS)
pair_gather_kernel(const T* __restrict__ P, const I* __restrict__ starts,
                   int rows, int D, T* __restrict__ out) {
  const int pair = blockIdx.x;
  long long s = static_cast<long long>(starts[pair]);
  s = s < 0 ? 0 : (s > rows - 2 ? rows - 2 : s);
  const T* src = P + static_cast<size_t>(s) * D;
  T* dst = out + static_cast<size_t>(2 * pair) * D;
  const int c0 = blockIdx.y * CHUNK + threadIdx.x;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int c = c0 + e * THREADS;
    if (c < D) {
      dst[c] = src[c];
      dst[D + c] = src[D + c];
    }
  }
}

template <typename T>
int launch(const void* P, const void* starts, int idx64, int pairs, int rows,
           int D, void* out, cudaStream_t s) {
  const dim3 grid(pairs, (D + CHUNK - 1) / CHUNK);
  if (idx64)
    pair_gather_kernel<T, int64_t><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(P), static_cast<const int64_t*>(starts), rows,
        D, static_cast<T*>(out));
  else
    pair_gather_kernel<T, int32_t><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(P), static_cast<const int32_t*>(starts), rows,
        D, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pair_gather(const void* P, const void* starts, int idx64,
                           int pairs, int rows, int D, int elem_bytes,
                           void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch<uint32_t>(P, starts, idx64, pairs, rows, D, out, s);
  if (elem_bytes == 2)
    return launch<uint16_t>(P, starts, idx64, pairs, rows, D, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
