#!/usr/bin/env python3
"""How the H100's tensor cores round their f32 sums, and the K6 Gram
kernel's first check, on one NVIDIA GPU.

    python3 experiments/torch_k6_probe.py      # from the repository root

1. The rounding of one mma.sync.m16n8k8 (TF32 operands, f32 sums): C = ±1
   plus one exact product of 0.75, 0.5 or 0.25 units in the last place of
   1 (ulp = 2⁻²³).  Rounding to nearest gives 1 + ulp for 0.75;
   truncation gives 1.
2. What that does to a long sum: the diagonal element Σ x_k² of R = 20064
   TF32 values x_k (standard normal, rounded to TF32, so every product is
   exact) accumulated by one warp in R/8 MMAs, (a) in one chain of MMA
   accumulators and (b) in partial sums of 32 columns (4 MMAs) that start
   at 0, each added to a running sum by an f32 add (K6's two levels);
   each against the f64 sum, beside a sequential f32 sum on the CPU.
3. K6 as built (ekf_slam_tpu_torch/csrc/syrk_gram.cu through
   ops/kernels.py): its -Xptxas -v report and HMMA count; f32 S at the
   edge shapes of its tiling and at D = R = 20067 (dense) through
   checks.gram_compare, with the single-TF32-pass control; then K6 and
   torch.matmul(S, S.T) at D = R = 20067 (CUDA events, 3 calls after one
   warm-up).
4. The rate of mma.sync m16n8k8 TF32 alone, on this card: 8 (as K6) or
   16 warps an SM, each issuing 16 independent MMAs a round from
   registers, no memory traffic; printed before 3, in TFLOP/s and as a
   share of the 495 TFLOP/s dense TF32 rate.

The probe kernels of 1, 2 and 4 are in this file, built by nvcc into
build/k6_probe/.  Prints the card's name and power limit first.
"""
import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "k6_probe")

PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2],
                                    const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// case i: D[0][0] = c[i] + a[i]·b[i] on one tile, every other entry 0
__global__ void one_product(const float* a, const float* b, const float* c,
                            float* d, int n) {
  const int lane = threadIdx.x;
  for (int i = 0; i < n; ++i) {
    uint32_t A[4] = {0, 0, 0, 0}, B[2] = {0, 0};
    float C[4] = {0.f, 0.f, 0.f, 0.f}, Dd[4];
    if (lane == 0) {
      A[0] = __float_as_uint(a[i]);
      B[0] = __float_as_uint(b[i]);
      C[0] = c[i];
    }
    mma(Dd, A, B, C);
    if (lane == 0) d[i] = Dd[0];
  }
}

// D[0][0] = Σ x_k² over R (a multiple of 32) TF32 values: A's row 0 and
// B's column 0 are x, lanes 0..3 holding columns t and t + 4 of each
// 8-deep step; two_level: partial sums of 4 MMAs from 0, added in f32
__global__ void long_sum(const float* x, int R, int two_level, float* out) {
  const int lane = threadIdx.x;
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, part[4];
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < R; k0 += 32) {
    for (int s = 0; s < 4; ++s) {
      uint32_t A[4] = {0, 0, 0, 0}, B[2] = {0, 0};
      if (lane < 4) {
        const int k = k0 + 8 * s + lane;
        A[0] = B[0] = __float_as_uint(x[k]);
        A[2] = B[1] = __float_as_uint(x[k + 4]);
      }
      if (!two_level) {
        mma(acc, A, B, acc);
      } else if (s == 0) {
        mma(part, A, B, zero);
      } else {
        mma(part, A, B, part);
      }
    }
    if (two_level)
      for (int e = 0; e < 4; ++e) acc[e] += part[e];
  }
  if (lane == 0) *out = acc[0];
}

// the rate of mma.sync m16n8k8 TF32 alone: each warp issues `iters`
// rounds of 16 MMAs into 16 independent accumulators (K6's 4x4 MMA tiles
// a warp), on constant fragments, with no memory traffic in the loop
__global__ void mma_rate(int iters, float* out) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1u, 3u, 5u};
  const uint32_t b[2] = {7u, threadIdx.x};
  float acc[16][4];
  for (int t = 0; t < 16; ++t)
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int t = 0; t < 16; ++t) mma(acc[t], a, b, acc[t]);
  }
  float sum = 0.f;
  for (int t = 0; t < 16; ++t)
    for (int e = 0; e < 4; ++e) sum += acc[t][e];
  if (sum == 1.2345f) *out = sum;          // keeps the loop alive
}

extern "C" int run_rate(int blocks, int threads, int iters, float* out) {
  mma_rate<<<blocks, threads>>>(iters, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_one(const float* a, const float* b, const float* c,
                       float* d, int n) {
  one_product<<<1, 32>>>(a, b, c, d, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int run_long(const float* x, int R, int two_level, float* out) {
  long_sum<<<1, 32>>>(x, R, two_level, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_probe():
    os.makedirs(OUT, exist_ok=True)
    src, so = os.path.join(OUT, "probe.cu"), os.path.join(OUT, "probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.run_one.argtypes = [vp, vp, vp, vp, ci]
    lib.run_long.argtypes = [vp, ci, ci, vp]
    lib.run_rate.argtypes = [ci, ci, ci, vp]
    return lib


def main():
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ekf_slam_tpu_torch.checks import (gram_compare, gram_dense_case,
                                           gram_plain_errors, tf32_round,
                                           tf32_single_pass)
    from ekf_slam_tpu_torch.ops import kernels as K
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    # 1. one product into C = ±1
    lib = build_probe()
    ulp = 2.0 ** -23
    cases = [(1.0, 1.5 * 2 ** -12, 2 ** -12, "+0.75 ulp"),
             (-1.0, -1.5 * 2 ** -12, 2 ** -12, "-0.75 ulp"),
             (1.0, 2 ** -12, 2 ** -12, "+0.5 ulp"),
             (1.0, 2 ** -13, 2 ** -12, "+0.25 ulp")]
    c, a, b = (torch.tensor([x[i] for x in cases], dtype=torch.float32,
                            device=dev) for i in range(3))
    d = torch.empty_like(a)
    assert lib.run_one(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                       d.data_ptr(), len(cases)) == 0
    torch.cuda.synchronize()
    for (cc, _, _, name), got in zip(cases, d.tolist()):
        print(f"1. C = {cc:+.0f}, product {name}: MMA gives C + "
              f"{(got - cc) / ulp:+.2f} ulp", flush=True)

    # 2. a long positive sum, one chain against two levels
    R = 20064
    rng = np.random.default_rng(0)
    x = tf32_round(torch.from_numpy(rng.standard_normal(R,
                                                        dtype=np.float32)))
    truth = float((x.double() ** 2).sum())
    seq = np.float32(0.0)
    for v in (x.numpy() ** 2):              # exact products, f32 sum
        seq = np.float32(seq + v)
    xd, out = x.to(dev), torch.empty(1, device=dev)
    for two in (0, 1):
        assert lib.run_long(xd.data_ptr(), R, two, out.data_ptr()) == 0
        torch.cuda.synchronize()
        rel = (float(out.item()) - truth) / truth
        how = "two levels (32-column partials)" if two else "one MMA chain"
        print(f"2. Σ x² over R = {R}, {how}: relative error {rel:+.3e}",
              flush=True)
    print(f"2. sequential f32 sum on the CPU: relative error "
          f"{(float(seq) - truth) / truth:+.3e}", flush=True)

    # 4. the mma.sync TF32 rate alone, before the heavy runs of 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 20000
    for warps in (8, 16):
        blocks, threads = sms * warps // 8, 256
        f = (lambda: lib.run_rate(blocks, threads, iters, out.data_ptr()))
        assert f() == 0
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(5):
            f()
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / 5
        flop = blocks * 8 * iters * 16 * 2 * 16 * 8 * 8
        print(f"4. mma.sync m16n8k8 TF32 alone, {warps} warps an SM "
              f"({blocks} blocks of 256 threads): {flop / ms / 1e9:.1f} "
              f"TFLOP/s ({ms:.3f} ms for {flop:.4g} FLOP), "
              f"{100 * flop / ms / 1e9 / 495:.1f}% of 495 TFLOP/s",
              flush=True)

    # 3. K6 as built
    K.build(["syrk_gram"])
    log = K.build_log("syrk_gram")
    print("3. -Xptxas -v:\n" + "\n".join(
        ln for ln in log.splitlines()
        if re.search(r"entry function|registers|spill|smem", ln)),
        flush=True)
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(K.library_path("syrk_gram"))],
                          capture_output=True, text=True, check=True).stdout
    print("3. HMMA per kernel: " + str({
        chunk.split()[0][-40:]: len(re.findall(r"\bHG?MMA\b", chunk))
        for chunk in sass.split("Function : ")[1:]}), flush=True)
    for D, R in [(D, R) for D in (1, 127, 128, 129) for R in (1, 3, 31, 33)]:
        S = gram_dense_case(D, R).to(dev)
        G = K.syrk_gram(S, use_pallas=True)
        plain = gram_plain_errors(S)
        res, ctrl = (gram_compare(G, S, plain),
                     gram_compare(tf32_single_pass(S), S, plain))
        print(f"3. D={D} R={R}: e {res['err']:.3e} limit {res['limit']:.3e} "
              f"ok {res['ok']} symmetric {torch.equal(G, G.T)}; control e "
              f"{ctrl['err']:.3e} ok {ctrl['ok']}", flush=True)
    D = 20067
    g = torch.Generator(device=dev).manual_seed(0)
    S = torch.randn((D, D), generator=g, device=dev)
    G = K.syrk_gram(S, use_pallas=True)
    plain = gram_plain_errors(S)
    res = gram_compare(G, S, plain)
    ctrl = gram_compare(tf32_single_pass(S), S, plain)
    print(f"3. D=R={D} dense: e {res['err']:.3e} limit {res['limit']:.3e} "
          f"ok {res['ok']} symmetric {torch.equal(G, G.T)}; plain "
          f"{plain}; control e {ctrl['err']:.3e} ok {ctrl['ok']}",
          flush=True)
    del G
    for name, fn in (("K6", lambda: K.syrk_gram(S, use_pallas=True)),
                     ("torch.matmul", lambda: torch.matmul(S, S.T))):
        fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(3):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        print(f"3. {name} at D=R={D} f32: {ev[0].elapsed_time(ev[1]) / 3:.4f}"
              f" ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
