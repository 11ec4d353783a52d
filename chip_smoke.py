#!/usr/bin/env python3
"""On-card smoke run of ekf_slam_tpu_torch (the PyTorch/CUDA port) on one
NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each prints one line; any failure exits non-zero with no result):

1. build the CUDA kernels from ekf_slam_tpu_torch/csrc (one nvcc per
   source, started together) and print the card's name and power limit;
2. K1 syrk_downdate against its plain version: bf16 at D = 20480, R = 16
   (≤ 1 bf16 ulp of |P|max, output bit-symmetric) and f32 at D = 1003
   (ragged edge, ≤ 1e-5 relative, bit-symmetric);
3. K3 score_lines against its plain version at NH = 64, B = 1024: equal
   counts;
4. the session on the card against the same session on the CPU
   (capacity 256, f32 P, rows + syrk, 32 ticks, the same draws):
   n_active equal every tick, pose within 1e-3;
5. the slice at full width: the tuned 10k-landmark batched session
   (D = 20480 padded, bf16 P, rows + syrk) for 64 ticks of the flagship
   simulator run, with every kernel counter set to 0 just before and read
   just after: finite state, landmarks mapped, one SYRK launch and
   1 + wall_search_timeout scoring launches per tick, no host sync in a
   tick; then the median tick time and a torch.profiler line (device busy
   share, device operations per tick, the kernels with most device time);
6. each kernel timed at the main path's shapes (CUDA-graph replays
   between CUDA events) beside its plain version, its library yardstick
   and its roofline bound.

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  This script imports nothing of JAX or of
ekf_slam_tpu.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16 tensor
# rate, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_name_and_limit():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warmup=3):
    """Mean device time of one call: ``iters`` calls captured in one CUDA
    graph (after ``warmup`` eager calls on a side stream), the graph
    replayed once between two CUDA events.  The replay launches without
    the host in the way, so a call of a few µs is timed as the card runs
    it, not at the rate Python can launch it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                                  # first replay uploads
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / iters


def bf16_ulp(x):
    """Spacing of bfloat16 numbers at magnitude x (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def profile_ticks(torch, sess, carry, traj, t0, n):
    """Where a tick's time goes: ``n`` further ticks (from tick ``t0`` of
    ``traj``) under torch.profiler.  Returns one line: the host window per
    tick, the device busy share of that window (union of the kernel and
    copy intervals), the device operations per tick, and the five
    kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        for t in range(t0, t0 + n):
            carry, _ = sess.step(carry, traj.odom[t], traj.ranges[t],
                                 traj.beam_angles)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - w0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == cuda)
    if not spans:
        return "not measured: torch.profiler saw no device activity"
    busy, end = 0.0, -math.inf
    for s, e, _ in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    top_s = "; ".join(f"{name[:60]} {us / n / 1e3:.3f} ms/tick"
                      for name, us in top)
    ours = []
    for kern in ("syrk_downdate_kernel", "score_lines_kernel"):
        durs = [e - s for s, e, name in spans if kern in name]
        if durs:
            ours.append(f"{kern} {len(durs) / n:.0f}/tick at "
                        f"{sum(durs) / len(durs) / 1e3:.4f} ms device each")
    return (f"{n} ticks, host window {window_us / n / 1e3:.3f} ms/tick, "
            f"device busy {busy / n / 1e3:.3f} ms/tick "
            f"({100 * busy / window_us:.1f}% of the window), "
            f"{len(spans) / n:.0f} device ops/tick; ours: {ours}; "
            f"top: {top_s}")


def slice_params(torch, capacity, **ekf_kw):
    from ekf_slam_tpu_torch.config import EKFParams, RansacParams
    ep = EKFParams(capacity=capacity, max_obs=8, ref_compat=False,
                   update_mode="batched", dtype=torch.float32, **ekf_kw)
    rp = RansacParams(line_consensus=60, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=64,
                      dtype=torch.float32)
    return ep, rp


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import ekf_slam_tpu_torch as tp
    except ImportError as e:
        print(f"chip_smoke: ekf_slam_tpu_torch is not importable from "
              f"{HERE}: {e}", file=sys.stderr)
        return 2
    check(os.path.dirname(os.path.dirname(os.path.abspath(tp.__file__)))
          == HERE, f"ekf_slam_tpu_torch resolved outside {HERE}")
    from ekf_slam_tpu_torch.checks import (score_lines_case,
                                           session_on_devices)
    from ekf_slam_tpu_torch.ops import kernels as K
    from ekf_slam_tpu_torch.sim import world as W
    from ekf_slam_tpu_torch.utils.schedule import tuned_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {}

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    card = gpu_name_and_limit()
    log(f"phase 1 build ok: {build_s:.2f} s (build dir {K.BUILD_DIR}); "
        f"card: {card}")

    # -- 2. K1 against its plain version ----------------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    D, R = 20480, 16
    A = torch.randn((D, D), generator=g, device=dev)
    P = ((A + A.T) * 0.5).to(torch.bfloat16)            # bit-symmetric
    del A
    Wb = (torch.randn((D, R), generator=g, device=dev) * 0.1).to(
        torch.bfloat16)
    ref = K.syrk_downdate_ref(P, Wb)
    out = K.syrk_downdate(P.clone(), Wb)
    torch.cuda.synchronize()
    err_k1 = (out.float() - ref.float()).abs().max().item()
    ulp = bf16_ulp(P.float().abs().max().item())
    check(err_k1 <= ulp, f"K1 bf16 max|Δ| {err_k1} > 1 ulp {ulp}")
    check(torch.equal(out, out.T), "K1 bf16 output not bit-symmetric")
    del out, ref
    for Dr in (1003, 2048):            # ragged scalar path, aligned f32 path
        A = torch.randn((Dr, Dr), generator=g, device=dev, dtype=torch.float64)
        Pf = ((A + A.T) * 0.5).float()
        Wf = torch.randn((Dr, R), generator=g, device=dev)
        ref = K.syrk_downdate_ref(Pf, Wf)
        out = K.syrk_downdate(Pf.clone(), Wf)
        torch.cuda.synchronize()
        rel = ((out - ref).abs().max() / ref.abs().max()).item()
        check(rel <= 1e-5, f"K1 f32 D={Dr} relative error {rel} > 1e-5")
        check(torch.equal(out, out.T), f"K1 f32 D={Dr} not bit-symmetric")
        log(f"phase 2 K1 f32 D={Dr} ok: relative error {rel:.3e}, "
            "bit-symmetric")
    log(f"phase 2 K1 bf16 D={D} R={R} ok: max|Δ| {err_k1} "
        f"(1 ulp of |P|max = {ulp}), bit-symmetric")

    # -- 3. K3 against its plain version ---------------------------------------
    NH, B, thresh = 64, 1024, 0.25
    pts, valid, lines = score_lines_case(g, NH, B, thresh)
    c_ref = K.score_lines_ref(pts, valid, lines, thresh)
    c_k = K.score_lines(pts, valid, lines, thresh)
    torch.cuda.synchronize()
    err_k3 = (c_k - c_ref).abs().max().item()
    check(err_k3 == 0, f"K3 counts differ by up to {err_k3}")
    log(f"phase 3 K3 NH={NH} B={B} ok: counts equal "
        f"(sum {int(c_k.sum().item())})")

    # -- 4. the session, card against CPU ---------------------------------------
    T4 = 32
    ep4, rp4 = slice_params(torch, 256, pht_mode="rows",
                            correction="syrk")
    outs4 = session_on_devices(ep4, rp4, T4, 1024, ("cuda", "cpu"))
    na_c, na_h = outs4["cuda"].n_active.cpu(), outs4["cpu"].n_active
    check(torch.equal(na_c, na_h),
          f"n_active differs: card {na_c.tolist()} cpu {na_h.tolist()}")
    dpose = (outs4["cuda"].pose.cpu() - outs4["cpu"].pose).abs().max().item()
    check(dpose <= 1e-3, f"card/CPU pose differ by {dpose} > 1e-3")
    log(f"phase 4 card vs CPU ok: {T4} ticks, capacity 256, n_active equal "
        f"(final {int(na_h[-1])}), max pose diff {dpose:.3e}")

    # -- 5. the slice at full width ------------------------------------------
    T = 64
    cfg = tp.SimConfig(n_beams=1024, max_range=12.0)
    gs = torch.Generator(device=dev)
    gs.manual_seed(0)
    T_PROF = 8                          # ticks profiled after the run
    traj = W.simulate(W.rectangle_room(4.0, 3.0, device=dev),
                      W.circle_controls(T + T_PROF, 0.05, 3.0, device=dev),
                      cfg, gs)
    ep, rp = slice_params(torch, 10000)
    ep = tuned_params(ep, batch=ep.max_obs)
    check((ep.pht_mode, ep.cov_dtype, ep.correction, ep.update_chunks)
          == ("rows", torch.bfloat16, "syrk", 1),
          f"tuned schedule changed: {ep}")
    sess = tp.SlamSession(ekf_params=ep, ransac_params=rp, seed=1)
    warm = sess.init_carry(first_odom=traj.odom[0])
    for t in range(3):                                  # warm-up ticks
        warm, _ = sess.step(warm, traj.odom[t], traj.ranges[t],
                            traj.beam_angles)
    # sync census of one tick: the tick is built to enqueue work without
    # reading any device value back (the debug mode's census is PyTorch's
    # own and may miss some kinds of synchronisation)
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        warm, _ = sess.step(warm, traj.odom[3], traj.ranges[3],
                            traj.beam_angles)
    torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
             for w in caught if "synchroniz" in str(w.message)]
    del warm
    torch.cuda.synchronize()

    carry = sess.init_carry(first_odom=traj.odom[0])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(T + 1)]
    outs = []
    K.syrk_downdate.launches = 0
    K.score_lines.launches = 0
    t0 = time.perf_counter()
    ev[0].record()
    for t in range(T):
        carry, o = sess.step(carry, traj.odom[t], traj.ranges[t],
                             traj.beam_angles)
        ev[t + 1].record()
        outs.append(o)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / T
    launches = {"syrk_downdate": K.syrk_downdate.launches,
                "score_lines": K.score_lines.launches}
    tick_ms = [ev[t].elapsed_time(ev[t + 1]) for t in range(T)]
    filt = carry.filt
    n_active = int(filt.n_active.item())
    check(filt.P.shape == (20480, 20480) and filt.P.dtype == torch.bfloat16,
          f"P is {tuple(filt.P.shape)} {filt.P.dtype}")
    check(bool(torch.isfinite(filt.x).all()), "non-finite x")
    check(bool(torch.isfinite(filt.P).all()), "non-finite P")
    check(n_active > 0, "no landmark mapped")
    check(launches["syrk_downdate"] == T,
          f"syrk_downdate launched {launches['syrk_downdate']} times, "
          f"expected {T}")
    expect_sl = T * (1 + rp.wall_search_timeout)
    check(launches["score_lines"] == expect_sl,
          f"score_lines launched {launches['score_lines']} times, "
          f"expected {expect_sl}")
    check(not syncs, f"a tick synchronised with the host at {syncs}")
    poses = torch.stack([o.pose for o in outs])
    ate = W.ate_rmse(poses[:, :2], traj.truth[:T, :2]).item()
    check(ate < 0.5, f"ATE {ate} m against the simulator's truth")
    log(f"phase 5 full width ok: capacity 10000, D={filt.P.shape[0]} bf16, "
        f"{T} ticks, n_active {n_active}, ATE {ate:.4f} m, launches "
        f"{launches}, tick median {statistics.median(tick_ms):.3f} ms "
        f"(CUDA events), wall {wall_ms:.3f} ms/tick, "
        f"{len(syncs)} host syncs in one tick at {syncs}")
    log("phase 5 profile: "
        + profile_ticks(torch, sess, carry, traj, T, T_PROF))
    del carry

    # -- 6. kernel timings at the main path's shapes ---------------------------
    Dm = filt.P.shape[0]
    Rm = 2 * ep.max_obs
    Pm = filt.P.clone()
    Wm = (torch.randn((Dm, Rm), generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    k1_ms = cuda_ms(torch, lambda: K.syrk_downdate(Pm, Wm), 20)
    k1_plain = cuda_ms(torch, lambda: K.syrk_downdate_ref(Pm, Wm), 5)
    k1_lib = cuda_ms(torch, lambda: torch.addmm(Pm, Wm, Wm.T, alpha=-1), 5)
    k1_bytes = 2 * Dm * Dm * 2 + Dm * Rm * 2
    k1_flops = Dm * Dm * Rm + Dm * Dm      # half the products, + subtract
    k1_bb = (k1_bytes / HBM_BYTES_PER_S, k1_flops / BF16_FLOPS)
    kernels["syrk_downdate"] = dict(
        route="cuda", source="ekf_slam_tpu_torch/csrc/syrk_downdate.cu",
        replaces="ekf_slam_tpu/ops/pallas/kernels.py:229",
        launches=launches["syrk_downdate"], max_abs_err=err_k1,
        ms=k1_ms, plain_ms=k1_plain, bound_ms=max(k1_bb) * 1e3,
        bound_by="bytes" if k1_bb[0] >= k1_bb[1] else "operations",
        library_ms=k1_lib)
    del Pm

    k3_ms = cuda_ms(torch, lambda: K.score_lines(pts, valid, lines, thresh),
                    200)
    k3_plain = cuda_ms(
        torch, lambda: K.score_lines_ref(pts, valid, lines, thresh), 200)
    k3_bytes = B * 2 * 4 + B + NH * 2 * 4 + NH * 4
    k3_ops = NH * B * 7 + NH * 3           # 7 per test, 3 per line
    k3_bb = (k3_bytes / HBM_BYTES_PER_S, k3_ops / F32_FLOPS)
    kernels["score_lines"] = dict(
        route="cuda", source="ekf_slam_tpu_torch/csrc/score_lines.cu",
        replaces="ekf_slam_tpu/ops/pallas/kernels.py:689",
        launches=launches["score_lines"], max_abs_err=float(err_k3),
        ms=k3_ms, plain_ms=k3_plain, bound_ms=max(k3_bb) * 1e3,
        bound_by="bytes" if k3_bb[0] >= k3_bb[1] else "operations",
        library_ms=None)
    for name, k in kernels.items():
        log(f"phase 6 {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']})")

    print(json.dumps({"kernels": [dict(name=n, **k)
                                  for n, k in kernels.items()]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
