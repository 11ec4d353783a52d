#!/usr/bin/env python3
"""On-card smoke run of ekf_slam_tpu_torch (the PyTorch/CUDA port) on one
NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each prints one line; any failure exits non-zero with no result):

1. build the five CUDA kernels from ekf_slam_tpu_torch/csrc (one nvcc per
   source, started together) and print the card's name and power limit;
2. K1 syrk_downdate against its plain version: bf16 at D = 20480, R = 16
   (≤ 1 bf16 ulp of |P|max, output bit-symmetric) and f32 at D = 1003
   and 2048 (≤ 1e-5 relative, bit-symmetric);
3. K3 score_lines against its plain version at NH = 64, B = 1024: equal
   counts;
4. K2 gate_costs at M = 8 and M = 300 against K = 10000 slots (+inf in
   exactly the inactive slots, ≤ 1e-5 relative elsewhere, entries within
   1e-4° of the bearing wrap's seam left out), K4 cov_update at D = 20003
   and D = 1003, f32 (in place, ≤ 1e-5 of |P|max), K5 pair_gather on f32
   and bf16 P with duplicate, unordered and last-row-pair starts
   (bit-equal to index_select) and with out-of-range starts (clamped),
   each against its plain version;
5. the session on the card against the same session on the CPU
   (capacity 256, f32 P, 32 ticks, the same draws), for the tuned path
   (rows + syrk) and the kernel path (rows, pair gather, fused gate, gemm
   correction through cov_update): n_active equal every tick, pose within
   1e-3;
6. the tuned path at full width: the 10k-landmark batched session
   (D = 20480 padded, bf16 P, rows + syrk) for 64 ticks of the flagship
   simulator run, with every kernel counter set to 0 just before and read
   just after: finite state, landmarks mapped, ATE < 0.5 m, one SYRK launch
   and 1 + wall_search_timeout scoring launches per tick, no K2, K4 or K5
   launch, no host sync in a tick; then the median tick time and a
   torch.profiler line (device busy share, device operations per tick,
   the kernels with most device time);
7. the kernel path at full width: the same run with use_pallas,
   rows_gather='pallas' and the gemm correction (D = 20003 unpadded, f32
   P) for 32 ticks, counters set to 0 just before and read just after:
   finite state, P (20003, 20003) f32, landmarks mapped, ATE < 0.5 m, one
   launch each of K2, K4 and K5 and 1 + wall_search_timeout of K3 per
   tick, no K1 launch, no host sync in a tick; the median tick time and a
   torch.profiler line;
8. each kernel timed at its path's shapes (CUDA-graph replays between
   CUDA events) beside its plain version, its library yardstick and its
   roofline bound.

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

# device symbols of the port's kernels, as torch.profiler names them
KERNEL_SYMBOLS = ("syrk_downdate_kernel", "gate_costs_kernel",
                  "score_lines_kernel", "cov_update_kernel",
                  "pair_gather_kernel")


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
    for kern in KERNEL_SYMBOLS:
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


# the batched session's kernel path: the fused gate (K2), the row-pair
# gather (K5) and the gemm correction through cov_update (K4), f32 P
KERNEL_PATH = dict(rows_gather="pallas", correction="gemm", use_pallas=True)


def full_width_run(torch, tp, W, counted, ep, rp, traj, T):
    """``T`` ticks of ``traj`` through a fresh ``SlamSession(ep, rp)``:
    three warm-up ticks and a sync census of one tick on a first carry,
    then a second carry from the start, with every kernel counter in
    ``counted`` set to 0 just before the run and read just after.  Checks
    finite state, landmarks mapped, ATE < 0.5 m and no host sync in a tick.
    Returns the session, the final carry, the launches and a summary."""
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
    for fn in counted.values():
        fn.launches = 0
    t0 = time.perf_counter()
    ev[0].record()
    for t in range(T):
        carry, o = sess.step(carry, traj.odom[t], traj.ranges[t],
                             traj.beam_angles)
        ev[t + 1].record()
        outs.append(o)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / T
    launches = {name: fn.launches for name, fn in counted.items()}
    tick_ms = [ev[t].elapsed_time(ev[t + 1]) for t in range(T)]
    filt = carry.filt
    n_active = int(filt.n_active.item())
    check(bool(torch.isfinite(filt.x).all()), "non-finite x")
    check(bool(torch.isfinite(filt.P).all()), "non-finite P")
    check(n_active > 0, "no landmark mapped")
    check(not syncs, f"a tick synchronised with the host at {syncs}")
    poses = torch.stack([o.pose for o in outs])
    ate = W.ate_rmse(poses[:, :2], traj.truth[:T, :2]).item()
    check(ate < 0.5, f"ATE {ate} m against the simulator's truth")
    summary = (f"{T} ticks, n_active {n_active}, ATE {ate:.4f} m, launches "
               f"{launches}, tick median {statistics.median(tick_ms):.3f} "
               f"ms (CUDA events), wall {wall_ms:.3f} ms/tick, "
               f"{len(syncs)} host syncs in one tick at {syncs}")
    return dict(sess=sess, carry=carry, launches=launches, summary=summary)


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
    from ekf_slam_tpu_torch.checks import (gate_case, pair_starts,
                                           score_lines_case,
                                           session_on_devices)
    from ekf_slam_tpu_torch.ops import gating as G
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

    # -- 4. K2, K4 and K5 against their plain versions --------------------------
    S_COST = 1e6            # small enough that position costs show
    err_k2 = None
    for M2, K2n in ((8, 10000), (300, 10000)):
        args2, keep = gate_case(g, M2, K2n)
        act2 = args2[6]
        ref = G.gate_costs_ref(*args2, S_COST, True)
        got = G.gate_costs(*args2, S_COST, True)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(got), ~act2[None, :].expand(M2, K2n)),
              f"K2 M={M2}: +inf not in exactly the inactive slots")
        ok = keep & act2[None, :]
        diff = (got - ref).abs()[ok]
        rel = (diff / ref.abs()[ok]).max().item()
        check(rel <= 1e-5, f"K2 M={M2} relative error {rel} > 1e-5")
        if err_k2 is None:
            err_k2, args8 = diff.max().item(), args2
        log(f"phase 4 K2 M={M2} K={K2n} ok: relative error {rel:.3e}, "
            f"max|Δ| {diff.max().item():.3e}, {int(ok.sum())} entries "
            f"compared, {int((~keep).sum())} at the wrap's seam left out")
    del ref, got

    Rk = 2 * 8
    for Dr in (20003, 1003):
        A = torch.randn((Dr, Dr), generator=g, device=dev)
        P4 = (A + A.T) * 0.5
        del A
        Kg = torch.randn((Dr, Rk), generator=g, device=dev)
        V = torch.randn((Rk, Dr), generator=g, device=dev) * 0.1
        ref = K.cov_update_ref(P4, Kg, V)
        out = P4.clone()
        ptr = out.data_ptr()
        K.cov_update(out, Kg, V)
        torch.cuda.synchronize()
        check(out.data_ptr() == ptr, "K4 did not update P in place")
        d4 = (out - ref).abs().max().item()
        rel = d4 / ref.abs().max().item()
        check(rel <= 1e-5, f"K4 D={Dr} relative error {rel} > 1e-5")
        if Dr == 20003:
            err_k4, D5 = d4, Dr
            for dt5 in (torch.float32, torch.bfloat16):
                P5 = P4.to(dt5)
                for idx in (torch.int64, torch.int32):
                    st = pair_starts(Dr, dev, idx)
                    rows = (st.long()[:, None]
                            + torch.arange(2, device=dev)).reshape(-1)
                    check(torch.equal(K.pair_gather(P5, st),
                                      P5.index_select(0, rows)),
                          f"K5 {dt5} {idx} differs from index_select")
                bad = torch.tensor([-7, Dr - 1, Dr + 100, 1 << 40],
                                   device=dev)
                got5 = K.pair_gather(P5, bad)
                torch.cuda.synchronize()
                check(torch.equal(got5, K.pair_gather_ref(P5, bad)),
                      f"K5 {dt5} out-of-range starts not clamped")
            del P5, got5
        log(f"phase 4 K4 D={Dr} R={Rk} f32 ok: relative error {rel:.3e}, "
            "in place")
        del P4, Kg, V, ref, out
    log(f"phase 4 K5 D={D5} ok: f32 and bf16, int64 and int32 starts, "
        "bit-equal to index_select; out-of-range starts clamped")

    # -- 5. the session, card against CPU ---------------------------------------
    counted = {"syrk_downdate": K.syrk_downdate, "gate_costs": G.gate_costs,
               "score_lines": K.score_lines, "cov_update": K.cov_update,
               "pair_gather": K.pair_gather}
    T4 = 32
    for path, kw, ours in (("tuned", dict(correction="syrk"),
                            ("syrk_downdate",)),
                           ("kernel", KERNEL_PATH,
                            ("gate_costs", "cov_update", "pair_gather"))):
        ep4, rp4 = slice_params(torch, 256, pht_mode="rows", **kw)
        for fn in counted.values():
            fn.launches = 0
        outs4 = session_on_devices(ep4, rp4, T4, 1024, ("cuda", "cpu"))
        check(all(counted[k].launches == T4 for k in ours),
              f"{path} path on the card launched "
              f"{ {k: counted[k].launches for k in ours} }, expected {T4} "
              "each")
        na_c, na_h = outs4["cuda"].n_active.cpu(), outs4["cpu"].n_active
        check(torch.equal(na_c, na_h),
              f"{path} path n_active differs: card {na_c.tolist()} "
              f"cpu {na_h.tolist()}")
        dpose = (outs4["cuda"].pose.cpu()
                 - outs4["cpu"].pose).abs().max().item()
        check(dpose <= 1e-3, f"{path} path card/CPU pose differ by {dpose}")
        log(f"phase 5 {path} path card vs CPU ok: {T4} ticks, capacity "
            f"256, n_active equal (final {int(na_h[-1])}), max pose diff "
            f"{dpose:.3e}")

    # -- 6. the tuned path at full width -------------------------------------------
    T = 64
    T_PROF = 8                          # ticks profiled after the run
    cfg = tp.SimConfig(n_beams=1024, max_range=12.0)
    gs = torch.Generator(device=dev)
    gs.manual_seed(0)
    traj = W.simulate(W.rectangle_room(4.0, 3.0, device=dev),
                      W.circle_controls(T + T_PROF, 0.05, 3.0, device=dev),
                      cfg, gs)
    ep, rp = slice_params(torch, 10000)
    ep = tuned_params(ep, batch=ep.max_obs)
    check((ep.pht_mode, ep.cov_dtype, ep.correction, ep.update_chunks)
          == ("rows", torch.bfloat16, "syrk", 1),
          f"tuned schedule changed: {ep}")
    run6 = full_width_run(torch, tp, W, counted, ep, rp, traj, T)
    filt, launches = run6["carry"].filt, run6["launches"]
    check(filt.P.shape == (20480, 20480) and filt.P.dtype == torch.bfloat16,
          f"P is {tuple(filt.P.shape)} {filt.P.dtype}")
    expect_sl = T * (1 + rp.wall_search_timeout)
    check(launches == dict(syrk_downdate=T, gate_costs=0,
                           score_lines=expect_sl, cov_update=0,
                           pair_gather=0),
          f"tuned path launches {launches}, expected {T} syrk_downdate, "
          f"{expect_sl} score_lines and no other")
    log(f"phase 6 tuned path full width ok: capacity {ep.capacity}, "
        f"D={filt.P.shape[0]} bf16, " + run6["summary"])
    log("phase 6 profile: "
        + profile_ticks(torch, run6["sess"], run6["carry"], traj, T, T_PROF))
    launches6 = launches
    del run6

    # -- 7. the kernel path at full width ------------------------------------------
    T7 = 32
    ep7, rp7 = slice_params(torch, 10000, pht_mode="rows", **KERNEL_PATH)
    check((ep7.cov_dtype, ep7.update_chunks, 2 * ep7.max_obs)
          == (None, 1, 16), f"kernel path configuration changed: {ep7}")
    run7 = full_width_run(torch, tp, W, counted, ep7, rp7, traj, T7)
    filt7, launches7 = run7["carry"].filt, run7["launches"]
    D7 = ep7.dim
    check(filt7.P.shape == (D7, D7) and filt7.P.dtype == torch.float32,
          f"kernel path P is {tuple(filt7.P.shape)} {filt7.P.dtype}")
    expect7 = dict(syrk_downdate=0, gate_costs=T7,
                   score_lines=T7 * (1 + rp7.wall_search_timeout),
                   cov_update=T7, pair_gather=T7)
    check(launches7 == expect7,
          f"kernel path launches {launches7}, expected {expect7}")
    log(f"phase 7 kernel path full width ok: capacity {ep7.capacity}, "
        f"D={D7} f32, "
        + run7["summary"])
    log("phase 7 profile: "
        + profile_ticks(torch, run7["sess"], run7["carry"], traj, T7,
                        T_PROF))
    P7 = filt7.P.clone()
    del run7, filt7

    # -- 8. kernel timings at the paths' shapes -----------------------------------
    def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
              ops, peak, library_ms):
        bb = (nbytes / HBM_BYTES_PER_S, ops / peak)
        kernels[name] = dict(
            route="cuda", source=f"ekf_slam_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=max(bb) * 1e3,
            bound_by="bytes" if bb[0] >= bb[1] else "operations",
            library_ms=library_ms)

    Dm = filt.P.shape[0]
    Rm = 2 * ep.max_obs
    Pm = filt.P.clone()
    Wm = (torch.randn((Dm, Rm), generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    entry("syrk_downdate", "syrk_downdate.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:229",
          launches6["syrk_downdate"], err_k1,
          cuda_ms(torch, lambda: K.syrk_downdate(Pm, Wm), 20),
          cuda_ms(torch, lambda: K.syrk_downdate_ref(Pm, Wm), 5),
          2 * Dm * Dm * 2 + Dm * Rm * 2,
          Dm * Dm * Rm + Dm * Dm,          # half the products, + subtract
          BF16_FLOPS,
          cuda_ms(torch, lambda: torch.addmm(Pm, Wm, Wm.T, alpha=-1), 5))
    del Pm, filt

    M8, K8 = args8[2].shape[0], args8[4].shape[0]
    strip_ms = cuda_ms(torch, lambda: G._bearing_strip(args8[0], args8[4]),
                       200)
    entry("gate_costs", "gate_costs.cu",
          "ekf_slam_tpu/ops/pallas/gating.py:143",
          launches7["gate_costs"], err_k2,
          cuda_ms(torch, lambda: G.gate_costs(*args8, S_COST, True), 200),
          cuda_ms(torch, lambda: G.gate_costs_ref(*args8, S_COST, True), 50),
          # pose, prr, zs, rdiag; lm, sig, active, prl, pll; out
          4 * (3 + 9 + 5 * M8) + K8 * (4 * 2 + 4 + 1 + 4 * 6 + 4 * 4)
          + 4 * M8 * K8,
          216 * K8 + 30 * M8 * K8,         # per slot Φ0, per pair the cost
          F32_FLOPS, None)

    entry("score_lines", "score_lines.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:689",
          launches6["score_lines"], float(err_k3),
          cuda_ms(torch, lambda: K.score_lines(pts, valid, lines, thresh),
                  200),
          cuda_ms(torch, lambda: K.score_lines_ref(pts, valid, lines,
                                                   thresh), 200),
          B * 2 * 4 + B + NH * 2 * 4 + NH * 4,
          NH * B * 7 + NH * 3,             # 7 per test, 3 per line
          F32_FLOPS, None)

    Km = torch.randn((D7, Rm), generator=g, device=dev) * 1e-3
    Vm = torch.randn((Rm, D7), generator=g, device=dev) * 1e-3
    entry("cov_update", "cov_update.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:62",
          launches7["cov_update"], err_k4,
          cuda_ms(torch, lambda: K.cov_update(P7, Km, Vm), 20),
          cuda_ms(torch, lambda: K.cov_update_ref(P7, Km, Vm), 5),
          2 * D7 * D7 * 4 + (D7 * Rm + Rm * D7) * 4,
          2 * D7 * D7 * Rm + D7 * D7,      # the rank-R product, + subtract
          F32_FLOPS,
          cuda_ms(torch, lambda: P7.addmm_(Km, Vm, alpha=-1), 5))

    st = pair_starts(D7, dev)
    rows = (st[:, None] + torch.arange(2, device=dev)).reshape(-1)
    n_pairs = st.shape[0]
    entry("pair_gather", "pair_gather.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:579",
          launches7["pair_gather"], 0.0,
          cuda_ms(torch, lambda: K.pair_gather(P7, st), 200),
          cuda_ms(torch, lambda: K.pair_gather_ref(P7, st), 200),
          2 * (2 * n_pairs * D7 * 4) + n_pairs * 8, 0, F32_FLOPS,
          cuda_ms(torch, lambda: P7.index_select(0, rows), 200))
    del P7
    for name, k in kernels.items():
        log(f"phase 8 {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.6f} by "
            f"{k['bound_by']}, {k['launches']} launches on its path)")
    log(f"phase 8 gate_costs: of its {kernels['gate_costs']['ms']:.4f} ms, "
        f"the bearing strip computed by torch before the launch takes "
        f"{strip_ms:.4f} ms")

    print(json.dumps({"kernels": [dict(name=n, **k)
                                  for n, k in kernels.items()]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
