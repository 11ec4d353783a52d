#!/usr/bin/env python3
"""Where K1's time goes at the batched update's rank, on one NVIDIA GPU.

    python3 experiments/torch_k1_split.py      # from the repository root

Builds ekf_slam_tpu_torch/csrc/syrk_downdate.cu four ways into
build/k1_split/ and times each on a bf16 P [20480²] at R = 16 and
R = 1024 (CUDA events over 30 and 10 launches, two rounds in turn), beside
torch.addmm(P, W, Wᵀ, alpha=-1):

* ``as built`` — the kernel;
* ``no MMA`` — the same, with the tensor-core instructions taken out (the
  W ring, the ldmatrix reads, the P stream and the epilogue remain);
* ``no MMA, no ldmatrix`` — the W ring, the P stream and the epilogue;
* ``no W after the first slabs`` — the ring stops loading after its
  first slabs, so the MMAs run on what is there: the product without the
  W bands' L2 traffic.

Only the first is a correct kernel; the others are timings.  Each edit is
a string replacement that must match the source, so an edited source
fails here loudly.  Prints the card's name and power limit first.

A one-off: it diagnoses the kernel as PR 11 left it and is expected to
break, and be deleted rather than mended, once K1's body changes.
"""
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "ekf_slam_tpu_torch", "csrc", "syrk_downdate.cu")
OUT = os.path.join(HERE, "build", "k1_split")

MMA = "      mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);"
STEP_START = "  uint32_t a[4][4], b[4][2];"
STEP_END = "      mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);\n}"
RING = ("        load_w_slab<C>(sW + (sn % C::STAGES) * C::W_STAGE, W, D, R, "
        "r0, c0,\n                       sn * C::BK, w_vec);")


def variants(src):
    def cut(text, a, b, by):
        assert a in text and b in text, f"source changed near {a!r}"
        i = text.index(a)
        return text[:i] + by + text[text.index(b, i) + len(b):]

    assert MMA in src and RING in src, "the K1 source changed"
    return {
        "as built": src,
        # keep the fragments alive without the product
        "no MMA": src.replace(MMA, "      acc[mi][ni][0] += __uint_as_float("
                              "a[mi][0] ^ b[ni][1]) * 0.f;"),
        "no MMA, no ldmatrix": cut(src, STEP_START, STEP_END,
                                   "  (void)acc; (void)sA; (void)sB; "
                                   "(void)kk; (void)lane; (void)wm; "
                                   "(void)wn;\n}"),
        "no W after the first slabs": src.replace(RING, "        (void)0;"),
    }


def main():
    import torch
    if not torch.cuda.is_available():
        print("torch_k1_split: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    sys.path.insert(0, HERE)
    from ekf_slam_tpu_torch.ops import kernels as K
    os.makedirs(OUT, exist_ok=True)
    nvcc = K._nvcc()
    srcs = variants(open(SRC).read())
    procs = {}
    for n, (name, text) in enumerate(srcs.items()):
        cu, so = (os.path.join(OUT, f"v{n}.{ext}") for ext in ("cu", "so"))
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *K._NVCC_FLAGS, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        lib = ctypes.CDLL(so)
        K._bind("syrk_downdate", lib)
        libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    D = 20480
    P = (torch.randn((D, D), generator=g, device=dev) * 0.1).to(
        torch.bfloat16)
    Ws = {R: (torch.randn((D, R), generator=g, device=dev) * 1e-3).to(
        torch.bfloat16) for R in (16, 1024)}

    def launch(lib, W):
        err = lib.syrk_downdate(P.data_ptr(), W.data_ptr(), D, W.shape[1], 1,
                                1, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def ms(fn, n):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    times = {name: {16: [], 1024: []} for name in libs}
    order = list(libs)
    for rnd in range(2):
        for name in order if rnd == 0 else order[::-1]:
            for R, n in ((16, 30), (1024, 10)):
                times[name][R].append(ms(lambda: launch(libs[name], Ws[R]),
                                         n))
    for name in order:
        print(f"{name}: " + ", ".join(
            f"R={R} " + " ".join(f"{t:.4f}" for t in ts) + " ms"
            for R, ts in times[name].items()))
    W = Ws[1024]
    print(f"torch.addmm at R=1024: "
          f"{ms(lambda: torch.addmm(P, W, W.T, alpha=-1), 10):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
