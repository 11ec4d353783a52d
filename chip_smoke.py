#!/usr/bin/env python3
"""On-card smoke run of ekf_slam_tpu_torch (the PyTorch/CUDA port) on one
NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each prints one line; any failure exits non-zero with no result):

1. build the seven CUDA kernels from ekf_slam_tpu_torch/csrc (one nvcc per
   source, started together), print the card's name and power limit, and
   count the tensor-core instructions (HMMA/HGMMA) in the SASS of K1's
   bf16 kernel (`cuobjdump -sass`; more than 0, or the phase fails);
2. K1 syrk_downdate against its plain version (checks.syrk_case and
   syrk_compare): bf16 at (D, R) = (20480, 16), (20480, 1024), (2048,
   1000) and (1003, 1024), f32 at (1003, 16), (2048, 16), (1003, 2) and
   (2048, 1024); each random (≤ 1 bf16 ulp of |P|max, or ≤ 1e-5 of |P|max
   in f32, with the count of elements that differ) and on integers, where
   every sum is exact (bit-equal); in place, output bit-symmetric;
3. K3 score_lines against its plain version at NH = 64, B = 1024: equal
   counts; then K3's one-launch wall search (wall_search: the initial
   scoring and every greedy round of find_walls_batched in one thread
   block) against its plain version through checks.wall_search_compare,
   on scans of 1024 and 1000 beams with NH = 64 and 7 lines, T = 4: at
   the flagship settings every round's counts, ok and pool bit-equal; at
   examples/large_world_slam.py's (refits, splits, RMS gate) a round may
   part only at a decision within the f32 rounding band of its cut (each
   one printed); lines and statistics within checks.wall_search_tolerance
   of the f64 plain version; then a scan of the largest B a block's
   shared memory holds at NH = 64 (10·B + 4·P2 + 13·NH bytes: 16,384 on
   an H100), bit-equal, and one beam more, which must raise;
4. K2 gate_costs_state, one launch that reads x, P, the landmark table
   and Rs as they lie, at M = 8 and M = 300 against K = 10000 slots on a
   P [20003²] f32 and at M = 8 on a padded P [20480²] (NaN wherever the
   gate does not read): +inf in exactly the inactive slots, elsewhere
   within the bearing tolerance of checks.gate_tolerance (1e-5 relative
   plus what a 2-ulp(360°) gap of the in-kernel ẑ_φ can move a cost),
   the in-kernel ẑ_φ within 2 ulps of the plain version's (the gap is
   printed), entries within 1e-4° of a wrap's seam left out; what
   PyTorch's CUDA division by a Python float does; K4 cov_update at D = 20003
   and D = 1003, f32 (in place, ≤ 1e-5 of |P|max), K5 pair_gather on f32
   and bf16 P with duplicate, unordered and last-row-pair starts
   (bit-equal to index_select) and with out-of-range starts (clamped),
   K6 syrk_gram at D = R = 20067 f32, D = 1003 by R = 1500 f32, and bf16
   and f64 at D = 517 (≤ 1e-5 of |G|max, 1e-12 at f64; bit-symmetric; the
   accumulation dtype), each against its plain version;
5. the session on the card against the same session on the CPU (the same
   draws), for the tuned path (rows + syrk) and the kernel path (rows,
   pair gather, fused gate, gemm correction through cov_update), capacity
   256, f32 P, 32 ticks, and for the square-root path (update_mode=
   'srekf_fast', pair gather, capacity 256, 80 ticks, a 16-column noise
   buffer so five recompressions run): n_active equal every tick, pose
   within 1e-3 (m and degrees; on the square-root path's 80 ticks, m and
   radians, beside the CPU's own f32-against-f64 gap, since the extractor's
   f32 rounding of wall bearings moves the heading by ~1e-2 degrees); then
   the recompression's QR branch on a factor whose Gram
   is singular, on the card and on the CPU (the Cholesky gives NaN, the
   QR branch's result is taken, finite, lower triangular, within 1e-4 of
   the CPU's);
6. the tuned path at full width: the 10k-landmark batched session
   (D = 20480 padded, bf16 P, rows + syrk) for 64 ticks of the flagship
   simulator run, with every kernel counter set to 0 just before and read
   just after: finite state, landmarks mapped, ATE < 0.5 m, one SYRK launch
   and one wall_search launch per tick, no score_lines, K2, K4 or K5
   launch, no host sync in a tick; then the median tick time and a
   torch.profiler line (device busy share, device operations per tick,
   the kernels with most device time), whose device operations per tick
   must be fewer than with the rounds as torch ops (printed beside them);
6c. the JAX package's headline batched update (bench.py:211-276) at
   recommended_schedule(10000): a full state of 10,000 landmarks
   (checks.full_state, D = 20003 padded to 20480, bf16 P), bench.py's
   measurements (checks.full_measurements), and per batch of M = 4096
   the plain gate and update_chunked in G = 8 chunks (rows, SYRK: K1 at
   rank 1024); 2 warm-up and 6 timed batches, counters set to 0 just
   before each and read just after: 8 K1 launches and no other, no host
   sync, P finite and bit-symmetric, n_active 10,000; the median batch
   time with its spread, updates/s and a torch.profiler line with K1's
   share of the device time.  Then the same at rank 1024 on the card
   against the CPU (capacity 1000, D = 2048, M = 512 in one chunk, the
   measurements with noise so that x moves): slots equal, x within 1e-5
   of |x|max and moved by at least 10 times that; P element by element
   within checks.syrk_gap_bound, K1 against its plain version on the
   inputs it had on the path (checks.record_syrk), and the card's P
   against the CPU's;
7. the kernel path at full width: the same run with use_pallas,
   rows_gather='pallas' and the gemm correction (D = 20003 unpadded, f32
   P) for 32 ticks, counters set to 0 just before and read just after:
   finite state, P (20003, 20003) f32, landmarks mapped, ATE < 0.5 m, one
   launch each of K2, K4, K5 and wall_search per tick, no K1 or
   score_lines launch, no host sync in a tick; the median tick time and a
   torch.profiler line, whose device operations per tick must be fewer
   than with the rounds as torch ops (printed beside them);
7b. the square-root path at full width: update_mode='srekf_fast' with
   rows_gather='pallas' at capacity 10000 (S (20067, 20067) f32:
   3 + 2·10000 + 64 noise-buffer dims, unpadded) for 72 ticks, so the 64th
   recompresses, counters set to 0 just before and read just after:
   finite state, landmarks mapped, ATE < 0.5 m, one K5 and one
   wall_search launch per tick and no K1, K2, K4, K6 or score_lines
   launch, no host sync on an ordinary tick and exactly one on the
   recompression tick, S lower triangular with its 64 buffer columns
   exactly 0 after the recompression; the median ordinary tick, the
   recompression tick and a torch.profiler line, whose device operations
   per ordinary tick must be fewer than with the rounds as torch ops.
   Then K6 on the factor
   the recompression was handed: one launch, within 1e-5 of |S·Sᵀ|max,
   bit-symmetric, and the blocked Cholesky of its Gram within 1e-3 of the
   session's recompressed factor on the active block;
8. the launch floor (a one-element add_ replayed 2000 times in one CUDA
   graph), then each kernel timed at its path's shapes (CUDA-graph
   replays between CUDA events; K6, ~0.3 s a call, 3 calls between CUDA
   events after one warm-up) beside its plain version, its library
   yardstick, its roofline bound (bytes or operations at the card's peak
   rates) and that bound raised to the launch floor, with its share of
   the latter; K1 also at R = 1024 beside torch.addmm and the parent's
   kernel's time; K2 also beside the torch ops that fed its strip-taking
   predecessor; wall_search at the flagship and large_world settings, as
   CUDA-graph replays (device time) and as eager calls (host clock around
   synchronised calls: what a tick pays), beside its plain version timed
   both ways; and the blocked Cholesky and the whole recompression at
   D = 20067.

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  A kernel's `launches` in the JSON is its
count from its path's run.  K1's entry (R = 16, phase 6's count) also has
`wide_rank`: K1 at R = 1024, D = 20480, with its launches counted in
phase 6c's timed and warm-up batches, its time beside the plain
version's, torch.addmm's and its bound.  The parent kernel's times
(K1_BEFORE_MS, constants from an earlier run) appear in the phase-8 log
only, not in the JSON.  K6's is 0, since no session launches it, so
its entry also has `on_path: false` and `side_call_launches`, the launch
on the recompression's factor in phase 7b; so has score_lines's, whose
scoring now runs inside wall_search on every path (its side calls are
phase 3's).  Every entry also has
`launch_floor_ms`, `floor_bound_ms` and `floor_bound_by` ("launch" where
the floor is the larger): the bound raised to the launch floor, beside
`bound_ms`.  This script imports nothing of JAX or of ekf_slam_tpu.
"""
import dataclasses
import json
import math
import os
import re
import shutil
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

# the kernel path's device operations per tick when its gate kernel was
# fed by ~20 torch ops (strips, R diagonal, bearing strip), PERF.md §5
OPS_BEFORE_FUSED_GATE = 1656
# device operations per tick when the extractor's rounds ran as torch ops
# around 1 + T score_lines launches (PERF.md §5)
OPS_BEFORE_WALL_SEARCH = dict(tuned=2069, kernel=1634, srekf_fast=2094)

# the parent's K1 (one block per 64x64 tile pair, f32 FMAs on CUDA cores)
# at D = 20480 bf16, by rank: phase 8 on NVIDIA H100 80GB HBM3, 700.00 W
# (PERF.md §6)
K1_BEFORE_MS = {16: 0.9956, 1024: 20.0199}

# device symbols of the port's kernels, as torch.profiler names them
KERNEL_SYMBOLS = ("syrk_downdate_kernel", "gate_costs_kernel",
                  "score_lines_kernel", "wall_search_kernel",
                  "cov_update_kernel", "pair_gather_kernel",
                  "syrk_gram_kernel")


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


def event_ms(torch, fn, iters=3, warmup=1):
    """Mean time of one call of a long-running ``fn`` (tenths of a second,
    where launch overhead does not matter): ``warmup`` calls, then
    ``iters`` calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def eager_ms(torch, fn, iters, warmup=3):
    """Mean host-clock time of one synchronised-at-the-end call of ``fn``
    run eagerly ``iters`` times: what a caller that launches it from
    Python pays, the host's launch work included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def wall_search_work(B, NH, params, n_ok):
    """Bytes and operations one wall search needs on its inputs: points,
    valid, trial lines and trial_ok read once, lines, ok, the pool and the
    stats written once; the initial scoring and each accepting round's
    re-scoring (7 operations a distance test, as K3's entry counts), and
    per round ~30 per point (the trial distances, the five fit sums, the
    RMS, chord and spread passes), ~11 per point a refine pass and, per
    split pass, a bitonic sort of the next power of two ≥ B plus ~30 per
    point.  ``n_ok`` is the rounds this run accepts."""
    T = params.wall_search_timeout
    nbytes = B * 8 + B + NH * 8 + NH + T * 8 + T + B + T * 12
    P2 = 1 << max(1, (B - 1).bit_length())
    lg = P2.bit_length() - 1
    passes = 2 * (params.split_gap > 0) + 2 * (params.split_kink_deg > 0)
    ops = ((1 + n_ok) * NH * B * 7
           + T * (30 * B + params.refine_passes * 11 * B
                  + passes * (P2 // 2 * lg * (lg + 1) // 2 + 30 * B)))
    return nbytes, ops


def pose_gaps(a, b):
    """Largest position gap (m), heading gap (rad, wrapped) and the tick
    of the larger, between two [T, 3] pose tracks (x, y, theta_deg)."""
    dpos = (a[:, :2].double() - b[:, :2].double()).abs().amax(dim=1)
    dth = (a[:, 2].double() - b[:, 2].double() + 180.0) % 360.0 - 180.0
    dhead = dth.abs() * (math.pi / 180.0)
    worst = int((dpos + dhead).argmax())
    return dpos.max().item(), dhead.max().item(), worst


def sass_mma_counts(path):
    """Tensor-core instructions (HMMA, HGMMA) of each kernel in the
    shared library ``path``, from ``cuobjdump -sass``: {symbol: count}."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(exe), "cuobjdump not found: phase 1 cannot read "
          "the compiled K1")
    out = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return {chunk.split()[0]: len(re.findall(r"\bHG?MMA\b", chunk))
            for chunk in out.split("Function : ")[1:]}


def profile_device(torch, body, n, unit):
    """Where the time of ``n`` units (ticks, batches) goes: ``body()``
    runs them under torch.profiler.  Returns one line (the host window
    per unit, the device busy share of that window (union of the kernel
    and copy intervals), the device operations per unit, and the five
    kernels with the most device time), the device operations per unit
    (None where the profiler saw no device activity), and the device busy
    ms and each port kernel's device ms per unit."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - w0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == cuda)
    if not spans:
        return ("not measured: torch.profiler saw no device activity", None,
                None)
    busy, end = 0.0, -math.inf
    for s, e, _ in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    top_s = "; ".join(f"{name[:60]} {us / n / 1e3:.3f} ms/{unit}"
                      for name, us in top)
    ours, kernel_ms = [], {}
    for kern in KERNEL_SYMBOLS:
        durs = [e - s for s, e, name in spans if kern in name]
        if durs:
            kernel_ms[kern] = sum(durs) / n / 1e3
            ours.append(f"{kern} {len(durs) / n:.0f}/{unit} at "
                        f"{sum(durs) / len(durs) / 1e3:.4f} ms device each")
    units = {"tick": "ticks", "batch": "batches"}[unit] if n > 1 else unit
    return (
        f"{n} {units}, host window {window_us / n / 1e3:.3f} ms/{unit}, "
        f"device busy {busy / n / 1e3:.3f} ms/{unit} "
        f"({100 * busy / window_us:.1f}% of the window), "
        f"{len(spans) / n:.0f} device ops/{unit}; ours: {ours}; "
        f"top: {top_s}"), len(spans) / n, dict(busy_ms=busy / n / 1e3,
                                               kernel_ms=kernel_ms)


def profile_ticks(torch, sess, carry, traj, t0, n):
    """``profile_device`` over ``n`` further ticks of ``sess`` from tick
    ``t0`` of ``traj``: its line and the device operations per tick."""
    def body():
        c = carry
        for t in range(t0, t0 + n):
            c, _ = sess.step(c, traj.odom[t], traj.ranges[t],
                             traj.beam_angles)
    return profile_device(torch, body, n, "tick")[:2]


def slice_params(torch, capacity, update_mode="batched", **ekf_kw):
    from ekf_slam_tpu_torch.config import EKFParams, RansacParams
    ep = EKFParams(capacity=capacity, max_obs=8, ref_compat=False,
                   update_mode=update_mode, dtype=torch.float32, **ekf_kw)
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
    from ekf_slam_tpu_torch import session as session_mod
    from ekf_slam_tpu_torch.checks import (bearing_gap_ulps, bench_batch,
                                           bench_params, bf16_ulps,
                                           full_measurements, full_state,
                                           gate_case, gate_tolerance,
                                           pair_starts, recompress_qr_case,
                                           record_syrk, score_lines_case,
                                           session_on_devices, syrk_case,
                                           syrk_compare, syrk_gap_bound,
                                           wall_search_case,
                                           wall_search_compare)
    from ekf_slam_tpu_torch.ops.ransac import wall_search_ref
    from ekf_slam_tpu_torch.ops.angles import _DEG2RAD, atan2d
    from ekf_slam_tpu_torch.ops.blocked_chol import chol_for_state
    from ekf_slam_tpu_torch.state import FilterState
    from ekf_slam_tpu_torch.ops import gating as G
    from ekf_slam_tpu_torch.ops import kernels as K
    from ekf_slam_tpu_torch.sim import world as W
    from ekf_slam_tpu_torch.utils.schedule import (recommended_schedule,
                                                   tuned_params)
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
    mma = sass_mma_counts(K.library_path("syrk_downdate"))
    mma_bf16 = {k: v for k, v in mma.items()
                if "syrk_downdate_kernel_bf16" in k}
    check(len(mma_bf16) == 2 and min(mma_bf16.values()) > 0,
          f"K1's bf16 kernel has no HMMA/HGMMA instruction: {mma}")
    log(f"phase 1 K1 SASS ok: tensor-core instructions (HMMA/HGMMA) per "
        f"kernel {mma}")

    # -- 2. K1 against its plain version ----------------------------------------
    # each case random (within one rounding of the storage type) and exact
    # (integers: every sum exact, so bit-equal), output bit-symmetric
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    err_k1 = {}                         # at D = 20480, by rank
    for Dk, Rk, dtk in ((20480, 16, bf16), (20480, 1024, bf16),
                        (2048, 1000, bf16), (1003, 1024, bf16),
                        (1003, 16, f32), (2048, 16, f32), (1003, 2, f32),
                        (2048, 1024, f32)):
        notes, label = [], f"K1 D={Dk} R={Rk} {str(dtk)[6:]}"
        for exact in (False, True):
            P, Wk = syrk_case(g, Dk, Rk, dtk, exact)
            ref = K.syrk_downdate_ref(P, Wk)
            pmax = P.float().abs().max().item()
            ptr = P.data_ptr()
            out = K.syrk_downdate(P, Wk)
            torch.cuda.synchronize()
            res = syrk_compare(out, ref, pmax)
            what = f"{label} {'exact' if exact else 'random'}"
            check(out.data_ptr() == ptr, f"{what}: not in place")
            check(res["symmetric"], f"{what}: output not bit-symmetric")
            check(res["n_diff"] == 0 if exact else res["ok"],
                  f"{what}: max|Δ| {res['err']} (tolerance {res['tol']}), "
                  f"{res['n_diff']} elements differ")
            if not exact and Dk == 20480:
                err_k1[Rk] = res["err"]
            notes.append(f"{'exact: bit-equal' if exact else 'random:'}"
                         + ("" if exact else
                            f" max|Δ| {res['err']:.3e} (tolerance "
                            f"{res['tol']:.3e}), {res['n_diff']} of "
                            f"{Dk * Dk} elements differ"))
            del P, Wk, ref, out
        log(f"phase 2 {label} ok: {'; '.join(notes)}; bit-symmetric, in "
            "place")
    torch.cuda.empty_cache()

    # -- 3. K3 against its plain version ---------------------------------------
    NH, B, thresh = 64, 1024, 0.25
    sl_before = K.score_lines.launches
    pts, valid, lines = score_lines_case(g, NH, B, thresh)
    c_ref = K.score_lines_ref(pts, valid, lines, thresh)
    c_k = K.score_lines(pts, valid, lines, thresh)
    torch.cuda.synchronize()
    err_k3 = (c_k - c_ref).abs().max().item()
    check(err_k3 == 0, f"K3 counts differ by up to {err_k3}")
    log(f"phase 3 K3 NH={NH} B={B} ok: counts equal "
        f"(sum {int(c_k.sum().item())})")
    # K3's one-launch wall search against its plain version (whose f32
    # run on the card launches score_lines, 1 + T times a case)
    err_ws = 0.0
    for setting in ("flagship", "large_world"):
        for seed, Bw, NHw in ((0, 1024, 64), (1, 1024, 64), (2, 1000, 7),
                              (3, 1024, 7), (4, 1000, 64)):
            argsw, pw = wall_search_case(seed, Bw, NHw, setting, dev)
            res = wall_search_compare(argsw, pw, setting == "flagship")
            check(not res["failures"], f"wall_search {setting} seed {seed} "
                  f"B={Bw} NH={NHw}: {res['failures']}")
            if setting == "flagship":
                err_ws = max(err_ws, res["max_abs_err"])
            log(f"phase 3 wall_search {setting} seed {seed} B={Bw} NH={NHw} "
                f"T={pw.wall_search_timeout} ok: {res['accepted']} walls, "
                f"rounds compared {res['compared']}, worst gap/tolerance "
                f"{res['ratio']:.3f}, feet max|Δ| against the f32 plain "
                f"version {res['max_abs_err']:.3e} m"
                + "".join(f"; {x}" for x in res["notes"]))
    # the largest scan a block's shared memory holds, and one beam more
    lib_ws = K._lib("wall_search")
    limit = K._wall_search_limit(lib_ws, torch.cuda.current_device())
    lo, hi = 1, 1 << 16                 # the largest B whose layout fits
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = ((mid, hi) if lib_ws.wall_search_smem(mid, 64) <= limit
                  else (lo, mid - 1))
    argsw, pw = wall_search_case(5, lo, 64, "flagship", dev)
    res = wall_search_compare(argsw, pw, True)
    check(not res["failures"], f"wall_search B={lo}: {res['failures']}")
    big = wall_search_case(5, lo + 1, 64, "flagship", dev)
    try:
        K.wall_search(*big[0], big[1])
        check(False, f"wall_search took B={lo + 1}, past its shared memory")
    except ValueError:
        pass
    del big
    log(f"phase 3 wall_search flagship seed 5 B={lo} NH=64 ok: "
        f"{res['accepted']} walls, rounds compared {res['compared']}, worst "
        f"gap/tolerance {res['ratio']:.3f}; a block may take {limit} bytes "
        f"of dynamic shared memory (the layout takes 10·B + 4·P2 + 13·NH): "
        f"B ≤ {lo} at NH = 64, and B = {lo + 1} raises")
    side_sl = K.score_lines.launches - sl_before

    # -- 4. K2, K4, K5 and K6 against their plain versions --------------------
    S_COST = 1e6            # small enough that position costs show
    err_k2 = None
    D2 = 3 + 2 * 10000
    for M2, K2n, D2p in ((8, 10000, D2), (300, 10000, D2),
                         (8, 10000, 20480)):
        # P [D2p, D2p] f32, NaN wherever the gate does not read; 20480 is
        # the tuned schedule's padded layout (ld > 3 + 2K)
        args2, keep = gate_case(g, M2, K2n, D=D2p)
        act2 = args2[4]
        ref = G.gate_costs_state_ref(*args2, S_COST, True)
        tol = gate_tolerance(args2, S_COST, True)
        zk = torch.empty(K2n, device=dev)
        got = G.gate_costs_state(*args2, S_COST, True, zphi_out=zk)
        torch.cuda.synchronize()
        check(torch.equal(torch.isinf(got), ~act2[None, :].expand(M2, K2n)),
              f"K2 M={M2} D={D2p}: +inf not in exactly the inactive slots")
        ok = keep & act2[None, :]
        diff = (got - ref).abs()[ok]
        check(bool((diff <= tol[ok]).all()),
              f"K2 M={M2} D={D2p}: {int((diff > tol[ok]).sum())} costs "
              f"outside the bearing tolerance")
        gap = bearing_gap_ulps(zk, G._bearing_strip(args2[0], args2[2]))
        check(gap <= 2, f"K2 M={M2} D={D2p}: in-kernel bearing {gap} ulps "
              "off the plain version's")
        rel = (diff / ref.abs()[ok]).max().item()
        second = int((diff > 1e-5 * ref.abs()[ok]).sum())
        if err_k2 is None:
            err_k2, args8 = diff.max().item(), args2
        log(f"phase 4 K2 M={M2} K={K2n} P [{D2p}²] f32 ok: ẑ_φ gap "
            f"{gap:.0f} ulps, {int((diff == 0).sum())} of {int(ok.sum())} "
            f"costs bit-equal, relative error {rel:.3e}, max|Δ| "
            f"{diff.max().item():.3e}, {second} entries needed the bearing "
            f"term of the tolerance, {int((~keep).sum())} at a wrap's seam "
            "left out")
    del ref, got, tol, args2
    # what PyTorch's CUDA division by a Python float does: the kernel's
    # atan2d multiplies by the float32 reciprocal of float32(π/180)
    d8 = args8[2] - args8[0][:2]
    rad = torch.atan2(d8[:, 1], d8[:, 0])
    deg = atan2d(d8[:, 1], d8[:, 0])
    by_recip = int((deg == rad * G._RAD2DEG_F32).sum())
    by_div = int((deg == rad / torch.tensor(_DEG2RAD, device=dev)).sum())
    log(f"phase 4 torch's CUDA atan2(y, x) / float(π/180): equal to the "
        f"product with float32 1/float32(π/180) in {by_recip} of "
        f"{deg.numel()} slots, to the true float32 quotient in {by_div}")
    del d8, rad, deg

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
    for D6, R6, dt6 in ((20067, 20067, torch.float32),
                        (1003, 1500, torch.float32),
                        (517, 517, torch.bfloat16),
                        (517, 517, torch.float64)):
        wide = dt6 == torch.float64
        S6 = torch.randn((D6, R6), generator=g, device=dev,
                         dtype=torch.float64 if wide else torch.float32
                         ).to(dt6)
        ref = K.syrk_gram_ref(S6)
        got = K.syrk_gram(S6, use_pallas=True)
        torch.cuda.synchronize()
        check(got.dtype == ref.dtype == (torch.float64 if wide
                                         else torch.float32),
              f"K6 {dt6} gave {got.dtype}, plain {ref.dtype}")
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        tol = 1e-12 if wide else 1e-5
        check(rel <= tol, f"K6 D={D6} R={R6} {dt6} relative error {rel} "
              f"> {tol}")
        check(torch.equal(got, got.T), f"K6 D={D6} {dt6} not bit-symmetric")
        log(f"phase 4 K6 D={D6} R={R6} {str(dt6)[6:]} ok: relative error "
            f"{rel:.3e} of |G|max, bit-symmetric, {str(got.dtype)[6:]} out")
        del S6, ref, got
    torch.cuda.empty_cache()

    # -- 5. the session, card against CPU ---------------------------------------
    counted = {"syrk_downdate": K.syrk_downdate,
               "gate_costs": G.gate_costs_state,
               "score_lines": K.score_lines, "wall_search": K.wall_search,
               "cov_update": K.cov_update, "pair_gather": K.pair_gather,
               "syrk_gram": K.syrk_gram}
    SR_PATH = dict(update_mode="srekf_fast", rows_gather="pallas")
    for path, kw, ours, T4 in (
            ("tuned", dict(pht_mode="rows", correction="syrk"),
             ("syrk_downdate", "wall_search"), 32),
            ("kernel", dict(pht_mode="rows", **KERNEL_PATH),
             ("gate_costs", "cov_update", "pair_gather", "wall_search"), 32),
            ("srekf_fast", dict(SR_PATH, sr_noise_buffer=16),
             ("pair_gather", "wall_search"), 80)):
        ep4, rp4 = slice_params(torch, 256, **kw)
        for fn in counted.values():
            fn.launches = 0
        outs4 = session_on_devices(ep4, rp4, T4, 1024, ("cuda", "cpu"))
        got4 = {k: fn.launches for k, fn in counted.items()}
        want4 = {k: T4 if k in ours else 0 for k in got4}
        check(got4 == want4, f"{path} path on the card launched {got4}, "
              f"expected {want4}")
        na_c, na_h = outs4["cuda"].n_active.cpu(), outs4["cpu"].n_active
        check(torch.equal(na_c, na_h),
              f"{path} path n_active differs: card {na_c.tolist()} "
              f"cpu {na_h.tolist()}")
        pose_c = outs4["cuda"].pose.cpu()
        if path != "srekf_fast":
            dpose = (pose_c - outs4["cpu"].pose).abs().max().item()
            check(dpose <= 1e-3,
                  f"{path} path card/CPU pose differ by {dpose}")
            log(f"phase 5 {path} path card vs CPU ok: {T4} ticks, capacity "
                f"256, n_active equal (final {int(na_h[-1])}), max pose "
                f"diff {dpose:.3e}")
            continue
        # 80 f32 ticks: the heading, in degrees, carries the extractor's
        # f32 rounding of the wall bearings (~1e-3°); it is held to 1e-3
        # in radians, as the position is in metres, and the CPU's own f32
        # run against its f64 run shows the size of that rounding
        ep64, rp64 = (dataclasses.replace(p_, dtype=torch.float64)
                      for p_ in (ep4, rp4))
        pose_64 = session_on_devices(ep64, rp64, T4, 1024, ("cpu",))[
            "cpu"].pose
        dpos, dhead, worst = pose_gaps(pose_c, outs4["cpu"].pose)
        fpos, fhead, fworst = pose_gaps(outs4["cpu"].pose, pose_64)
        check(dpos <= 1e-3 and dhead <= 1e-3,
              f"{path} path card/CPU pose differ by {dpos} m, {dhead} rad "
              f"(worst tick {worst}); the CPU's f32 run differs from its "
              f"f64 run by {fpos} m, {fhead} rad (tick {fworst})")
        log(f"phase 5 {path} path card vs CPU ok: {T4} ticks, capacity 256, "
            f"buffer {ep4.sr_noise_buffer}, n_active equal (final "
            f"{int(na_h[-1])}), max position diff {dpos:.3e} m, heading "
            f"{dhead:.3e} rad ({math.degrees(dhead):.3e} deg, tick {worst}); "
            f"the CPU's f32 run against its f64 run: {fpos:.3e} m, "
            f"{fhead:.3e} rad ({math.degrees(fhead):.3e} deg, tick "
            f"{fworst})")
    qr = recompress_qr_case(("cuda", "cpu"))
    for where, res in qr.items():
        check(res["chol_failed"], f"recompression on {where}: the Cholesky "
              "of a singular Gram did not give NaN")
        check(res["qr_taken"], f"recompression on {where}: the QR "
              "branch's factor was not taken")
    Lq = qr["cuda"]["L"]
    check(bool(torch.isfinite(Lq).all()), "QR branch factor not finite")
    check(torch.equal(Lq, Lq.tril()), "QR branch factor not triangular")
    dq = (Lq.cpu() - qr["cpu"]["L"]).abs().max().item()
    check(dq <= 1e-4, f"QR branch card/CPU factors differ by {dq}")
    log(f"phase 5 recompression QR branch ok: D={Lq.shape[0]} f32, the "
        f"Cholesky gave NaN and the QR branch was taken on card and CPU, "
        f"factor finite and lower triangular, card/CPU max|Δ| {dq:.3e}")
    del qr, Lq

    # -- 6. the tuned path at full width -------------------------------------------
    T = 64
    T_SR = 72                           # the square-root path's run (7b)
    T_PROF = 8                          # ticks profiled after each run
    cfg = tp.SimConfig(n_beams=1024, max_range=12.0)
    gs = torch.Generator(device=dev)
    gs.manual_seed(0)
    traj = W.simulate(W.rectangle_room(4.0, 3.0, device=dev),
                      W.circle_controls(T_SR + T_PROF, 0.05, 3.0,
                                        device=dev),
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
    check(launches == dict(syrk_downdate=T, gate_costs=0, score_lines=0,
                           wall_search=T, cov_update=0, pair_gather=0,
                           syrk_gram=0),
          f"tuned path launches {launches}, expected {T} syrk_downdate, "
          f"{T} wall_search and no other")
    log(f"phase 6 tuned path full width ok: capacity {ep.capacity}, "
        f"D={filt.P.shape[0]} bf16, " + run6["summary"])
    prof6, ops6 = profile_ticks(torch, run6["sess"], run6["carry"], traj, T,
                                T_PROF)
    log(f"phase 6 profile: {prof6}")
    check(ops6 is not None and ops6 < OPS_BEFORE_WALL_SEARCH["tuned"],
          f"tuned path: {ops6} device ops per tick, not fewer than the "
          f"{OPS_BEFORE_WALL_SEARCH['tuned']} with the rounds as torch ops")
    log(f"phase 6 device ops per tick: {ops6:.0f} with the wall search as "
        f"one launch, {OPS_BEFORE_WALL_SEARCH['tuned']} with its rounds as "
        f"torch ops around 1 + T score_lines launches (PERF.md §5)")
    launches6 = launches
    P6 = filt.P                         # the tuned path's P, for phase 8
    del run6, filt
    torch.cuda.empty_cache()

    # -- 6c. the 10k batched update: the JAX package's headline benchmark ------
    # bench.py:211-276 at recommended_schedule(10000): M = 4096 exact
    # re-observations a batch, the plain gate, update_chunked in 8 chunks
    # of 512 (rows, bf16 P, SYRK: one K1 launch of rank 1024 a chunk) on
    # a full state of 10,000 landmarks, D = 20003 padded to 20480
    ep6c = bench_params(10000)
    M6c = recommended_schedule(10000)["batch"]
    check((M6c, ep6c.update_chunks, ep6c.pht_mode, ep6c.cov_dtype,
           ep6c.correction) == (4096, 8, "rows", torch.bfloat16, "syrk"),
          f"the 10k schedule changed: M={M6c}, {ep6c}")
    WARM6C, TIMED6C = 2, 6
    st6 = full_state(ep6c, 10000, seed=0, device=dev)
    check(st6.P.shape == (20480, 20480), f"full state P {st6.P.shape}")
    zs6 = torch.tensor(full_measurements(st6.x, 10000,
                                         (WARM6C + TIMED6C) * M6c, seed=1),
                       dtype=torch.float32, device=dev).reshape(-1, M6c, 3)
    want6c = {k: ep6c.update_chunks if k == "syrk_downdate" else 0
              for k in counted}
    batch_ms, n_assoc, k1_6c_launches = [], [], 0
    for b in range(WARM6C + TIMED6C):
        ev6 = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for fn in counted.values():
            fn.launches = 0
        # sync census of the batch (PyTorch's own, as in phases 6 and 7)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ev6[0].record()
                st6, slots6 = bench_batch(st6, zs6[b], ep6c)
                ev6[1].record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches6c = {name: fn.launches for name, fn in counted.items()}
        k1_6c_launches += launches6c["syrk_downdate"]
        syncs6c = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                   for w in caught if "synchroniz" in str(w.message)]
        torch.cuda.synchronize()
        check(launches6c == want6c, f"batch {b} launched {launches6c}, "
              f"expected {want6c}")
        check(not syncs6c, f"batch {b} synchronised with the host at "
              f"{syncs6c}")
        check(bool(torch.isfinite(st6.P).all()), f"batch {b}: P not finite")
        check(torch.equal(st6.P, st6.P.T), f"batch {b}: P not bit-symmetric")
        check(int(st6.n_active.item()) == 10000,
              f"batch {b}: n_active {int(st6.n_active.item())}")
        n_assoc.append(int((slots6.long() == zs6[b, :, 2].long() - 1).sum()))
        if b >= WARM6C:
            batch_ms.append(ev6[0].elapsed_time(ev6[1]))
    check(bool(torch.isfinite(st6.x).all()), "phase 6c: x not finite")
    med6c = statistics.median(batch_ms)
    spread6c = 100 * (max(batch_ms) - min(batch_ms)) / med6c
    log(f"phase 6c the 10k batched update ok: M={M6c}, G={ep6c.update_chunks}"
        f" (K1 at R={2 * M6c // ep6c.update_chunks}), D=20480 bf16, "
        f"{WARM6C} warm-up and {TIMED6C} timed batches, each with launches "
        f"{want6c}, no host sync, P finite and bit-symmetric, n_active 10000"
        f"; measurements associated with the slot they were made from: "
        f"{n_assoc} of {M6c}; batch median {med6c:.3f} ms (CUDA events; "
        f"min {min(batch_ms):.3f}, max {max(batch_ms):.3f}, spread "
        f"{spread6c:.1f}%): {M6c / med6c * 1e3:.1f} updates/s")
    prof6c, _, dev6c = profile_device(
        torch, lambda: bench_batch(st6, zs6[-1], ep6c), 1, "batch")
    k1_6c = dev6c["kernel_ms"].get("syrk_downdate_kernel", 0.0) \
        if dev6c else None
    log(f"phase 6c profile: {prof6c}" + (
        f"; K1 {k1_6c:.3f} ms of the {dev6c['busy_ms']:.3f} ms device busy "
        f"({100 * k1_6c / dev6c['busy_ms']:.1f}%)" if dev6c else ""))
    del st6, zs6, slots6
    torch.cuda.empty_cache()
    # card against CPU at the same rank: a full state of 1000 landmarks
    # (D = 2003 padded to 2048), rows, bf16 P, SYRK, M = 512 in one chunk,
    # the measurements with noise (0.1 m, 0.1°) so that the update moves x
    ep_s = bench_params(1000, pht_mode="rows", cov_dtype=torch.bfloat16,
                        correction="syrk", update_chunks=1)
    st_h = full_state(ep_s, 1000, seed=2, device="cpu")
    zs_h = torch.tensor(full_measurements(st_h.x, 1000, 512, seed=3,
                                          noise=(0.1, 0.1)),
                        dtype=torch.float32)
    x_in = st_h.x.clone()
    st_c = FilterState(*(v.to(dev) for v in st_h))
    for fn in counted.values():
        fn.launches = 0
    with record_syrk() as rec_c:
        out_c, slots_c = bench_batch(st_c, zs_h.to(dev), ep_s)
    torch.cuda.synchronize()
    launches_s = {name: fn.launches for name, fn in counted.items()}
    check(launches_s == {k: int(k == "syrk_downdate") for k in counted},
          f"the rank-1024 update on the card launched {launches_s}")
    with record_syrk() as rec_h:
        out_h, slots_h = bench_batch(st_h, zs_h, ep_s)
    check(torch.equal(slots_c.cpu(), slots_h), "card and CPU slots differ")
    (P_in, W_c), (P_in_h, W_h) = rec_c[0], rec_h[0]
    check(torch.equal(P_in.cpu(), P_in_h), "card and CPU P differ before K1")
    # x: f32 sums in other orders, held to the bf16-storage tolerance of
    # the port's parity tests (1e-5 of |x|max), which must be well under
    # what the noisy update moved x by, or the check would be empty
    dx = (out_c.x.cpu() - out_h.x).abs().max().item()
    tol_x = 1e-5 * out_h.x.abs().max().item()
    moved = (out_h.x - x_in).abs().max().item()
    check(dx <= tol_x, f"card/CPU x differ by {dx} > {tol_x}")
    check(moved >= 10 * tol_x, f"the update moved x by {moved}, not 10x "
          f"the tolerance {tol_x}: the x check would be empty")
    # P, element by element (checks.syrk_gap_bound): K1 on the card against
    # its plain version on the inputs it had on the path (the bf16
    # roundings and the f32 sums' errors), then the card's P against the
    # CPU's (also what their W, each rounded to bf16 from f32 values
    # summed in other orders, make of W·Wᵀ)
    ref_c = K.syrk_downdate_ref(P_in.clone(), W_c)
    gap_k = (out_c.P.double() - ref_c.double()).abs()
    over_k = int((gap_k > syrk_gap_bound(out_c.P, ref_c, P_in, W_c, W_c)
                  ).sum())
    del ref_c, gap_k
    Ph = out_h.P.to(dev)
    gap = (out_c.P.double() - Ph.double()).abs()
    bound = syrk_gap_bound(out_c.P, Ph, P_in, W_c, W_h.to(dev))
    over = int((gap > bound).sum())
    worst = (gap / bound).max().item()
    own = int((gap > bf16_ulps(torch.maximum(out_c.P.float().abs(),
                                             Ph.float().abs()))).sum())
    n_wdiff = int((W_c.cpu() != W_h).sum())
    check(over_k == 0, f"K1 on the path: {over_k} elements of P past the "
          "bound of its plain version on the same inputs")
    check(over == 0, f"card/CPU P: {over} elements past their bound "
          f"(largest gap/bound {worst:.3f})")
    check(torch.equal(out_c.P, out_c.P.T), "card P not bit-symmetric")
    log(f"phase 6c card vs CPU at R=1024 ok: capacity 1000, D=2048 bf16, "
        f"M=512 in one chunk, measurements with noise, launches "
        f"{launches_s}; slots equal ({int((slots_h.long() == zs_h[:, 2].long() - 1).sum())} "
        f"of 512 on the slot drawn); x max|Δ| {dx:.3e} (tolerance "
        f"{tol_x:.3e}, the update moved x by up to {moved:.3e}); K1 on the "
        f"path's own inputs against its plain version: {over_k} elements "
        f"past their bound; card vs CPU P: {over} of {gap.numel()} elements "
        f"past their bound (largest gap/bound {worst:.3f}), "
        f"{int(torch.count_nonzero(gap))} differ, {own} by more than one "
        f"bf16 ulp of their own magnitude, from {n_wdiff} of {W_h.numel()} "
        f"W elements that differ; card P bit-symmetric")
    del st_h, st_c, out_c, out_h, Ph, gap, bound, rec_c, rec_h, P_in, W_c

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
    expect7 = dict(syrk_downdate=0, gate_costs=T7, score_lines=0,
                   wall_search=T7, cov_update=T7, pair_gather=T7,
                   syrk_gram=0)
    check(launches7 == expect7,
          f"kernel path launches {launches7}, expected {expect7}")
    log(f"phase 7 kernel path full width ok: capacity {ep7.capacity}, "
        f"D={D7} f32, "
        + run7["summary"])
    prof7, ops7 = profile_ticks(torch, run7["sess"], run7["carry"], traj, T7,
                                T_PROF)
    log(f"phase 7 profile: {prof7}")
    check(ops7 is not None and ops7 < OPS_BEFORE_WALL_SEARCH["kernel"],
          f"kernel path: {ops7} device ops per tick, not fewer than the "
          f"{OPS_BEFORE_WALL_SEARCH['kernel']} with the rounds as torch ops")
    log(f"phase 7 device ops per tick: {ops7:.0f} with the wall search as "
        f"one launch, {OPS_BEFORE_WALL_SEARCH['kernel']} with its rounds as "
        f"torch ops, {OPS_BEFORE_FUSED_GATE} when torch ops also "
        f"built the gate's strips and bearing (PERF.md §5)")
    P7 = filt7.P.clone()
    del run7, filt7
    torch.cuda.empty_cache()

    # -- 7b. the square-root path at full width ------------------------------
    ep9, rp9 = slice_params(torch, 10000, **SR_PATH)
    D9, B9 = ep9.dim + ep9.sr_noise_buffer, ep9.sr_noise_buffer
    check((ep9.pht_mode, ep9.update_chunks, B9, 2 * ep9.max_obs, D9)
          == ("dense", 1, 64, 16, 20067),
          f"square-root path configuration changed: {ep9}")
    rec = B9 - 1                        # the tick that recompresses
    handed = {}                 # the factor sr_recompress is given, its result
    real_recompress = session_mod.sr_recompress

    def grab(filt):
        # a reference, not a copy: sr_recompress leaves its input alone
        # and the session drops it, so the timed tick does no extra work
        handed.update(S=filt.P, n_active=filt.n_active)
        return real_recompress(filt)

    sess9 = tp.SlamSession(ekf_params=ep9, ransac_params=rp9, seed=1)
    warm = sess9.init_carry(first_odom=traj.odom[0])
    for t in range(3):                                  # warm-up ticks
        warm, _ = sess9.step(warm, traj.odom[t], traj.ranges[t],
                             traj.beam_angles)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    carry9 = sess9.init_carry(first_odom=traj.odom[0])
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
          for _ in range(T_SR)]         # each tick's start and end
    outs9, syncs9, after_rec = [], [], None
    session_mod.sr_recompress = grab
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for t in range(T_SR):
            # sync census of every tick (PyTorch's own, which may miss
            # some kinds of synchronisation)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ev[t][0].record()
                carry9, o = sess9.step(carry9, traj.odom[t], traj.ranges[t],
                                       traj.beam_angles)
                ev[t][1].record()
            syncs9.append([f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                           for w in caught if "synchroniz" in str(w.message)])
            outs9.append(o)
            if t == rec:    # between two ticks' windows: the new factor
                S9 = carry9.filt.P          # (later ticks update it in place)
                handed["L"] = S9.clone()
                handed["n_active"] = handed["n_active"].clone()
                after_rec = (torch.count_nonzero(torch.triu(S9, 1)),
                             torch.count_nonzero(S9[:, ep9.dim:]))
                del S9
    finally:
        torch.cuda.set_sync_debug_mode(0)
        session_mod.sr_recompress = real_recompress
    torch.cuda.synchronize()
    launches9 = {name: fn.launches for name, fn in counted.items()}
    tick9 = [a.elapsed_time(b) for a, b in ev]
    filt9 = carry9.filt
    n9 = int(filt9.n_active.item())
    check(filt9.P.shape == (D9, D9) and filt9.P.dtype == torch.float32,
          f"square-root path S is {tuple(filt9.P.shape)} {filt9.P.dtype}")
    check(bool(torch.isfinite(filt9.x).all()), "non-finite x")
    check(bool(torch.isfinite(filt9.P).all()), "non-finite S")
    check(n9 > 0, "no landmark mapped")
    check(carry9.sr_tick == T_SR, f"sr_tick {carry9.sr_tick} != {T_SR}")
    ate9 = W.ate_rmse(torch.stack([o.pose for o in outs9])[:, :2],
                      traj.truth[:T_SR, :2]).item()
    check(ate9 < 0.5, f"square-root path ATE {ate9} m")
    expect9 = dict(syrk_downdate=0, gate_costs=0, score_lines=0,
                   wall_search=T_SR, cov_update=0, pair_gather=T_SR,
                   syrk_gram=0)
    check(launches9 == expect9,
          f"square-root path launches {launches9}, expected {expect9}")
    n_sync = [len(x) for x in syncs9]
    check(n_sync[rec] == 1 and sum(n_sync) == 1,
          f"host syncs per tick {n_sync} (expected 1 on tick {rec} only): "
          f"{[x for x in syncs9 if x]}")
    check("S" in handed, "the recompression did not run")
    off, buf = (int(c.item()) for c in after_rec)
    check(off == 0 and buf == 0, f"after the recompression S has {off} "
          f"entries above its diagonal and {buf} in its buffer columns")
    ordinary = [ms for t, ms in enumerate(tick9) if t != rec]
    log(f"phase 7b square-root path full width ok: capacity "
        f"{ep9.capacity}, S ({D9}, {D9}) f32 with {B9} buffer columns, "
        f"{T_SR} ticks, n_active {n9}, ATE {ate9:.4f} m, launches "
        f"{launches9}, host syncs 0 per ordinary tick and 1 on the "
        f"recompression tick ({syncs9[rec]}), S lower triangular with its "
        f"buffer columns 0 after it; ordinary tick median "
        f"{statistics.median(ordinary):.3f} ms, recompression tick "
        f"{tick9[rec]:.3f} ms (CUDA events)")
    prof9, ops9 = profile_ticks(torch, sess9, carry9, traj, T_SR, T_PROF)
    log(f"phase 7b profile: {prof9}")
    check(ops9 is not None and ops9 < OPS_BEFORE_WALL_SEARCH["srekf_fast"],
          f"square-root path: {ops9} device ops per tick, not fewer than "
          f"the {OPS_BEFORE_WALL_SEARCH['srekf_fast']} with the rounds as "
          f"torch ops")
    log(f"phase 7b device ops per tick: {ops9:.0f} with the wall search as "
        f"one launch, {OPS_BEFORE_WALL_SEARCH['srekf_fast']} with its "
        f"rounds as torch ops")
    del carry9, filt9, outs9, sess9
    torch.cuda.empty_cache()

    # K6 on the factor the recompression was handed: the recompression's
    # Gram through the kernel, counters set to 0 just before and read
    # just after, then the Cholesky the recompression runs
    S_h, na_h, L_sess = handed["S"], handed["n_active"], handed.pop("L")
    for fn in counted.values():
        fn.launches = 0
    G6 = K.syrk_gram(S_h, use_pallas=True)
    L6 = chol_for_state(G6, na_h)
    torch.cuda.synchronize()
    launches_k6 = {name: fn.launches for name, fn in counted.items()}
    check(launches_k6 == {k: int(k == "syrk_gram") for k in counted},
          f"the Gram through K6 launched {launches_k6}")
    G_lib = torch.matmul(S_h, S_h.T)
    err_k6 = (G6 - G_lib).abs().max().item()
    rel6 = err_k6 / G_lib.abs().max().item()
    check(rel6 <= 1e-5, f"K6 on the path: relative error {rel6} > 1e-5")
    check(torch.equal(G6, G6.T), "K6 on the path: G not bit-symmetric")
    del G_lib
    d_act = 3 + 2 * int(na_h.item())
    Ls, Lk = L_sess[:d_act, :d_act], L6[:d_act, :d_act]
    rel_l = ((Lk - Ls).abs().max() / Ls.abs().max()).item()
    check(rel_l <= 1e-3, f"Cholesky of K6's Gram differs from the "
          f"session's factor by {rel_l} of its largest entry")
    log(f"phase 7b K6 on the path ok: S ({D9}, {D9}) f32 as handed to the "
        f"recompression, launches {launches_k6}, relative error "
        f"{rel6:.3e} of |S·Sᵀ|max, bit-symmetric; the Cholesky of its Gram "
        f"is within {rel_l:.3e} of the session's factor on the active "
        f"{d_act}×{d_act} block")
    del L6, L_sess

    # -- 8. the launch floor and the kernel timings at the paths' shapes ------
    # the launch floor: a one-element add_ replayed N times in one CUDA
    # graph, the same harness as every kernel's time below
    one = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(torch, lambda: one.add_(1.0), 2000)
    del one

    def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
              ops, peak, library_ms):
        # bound_ms: bytes or operations at the card's peak rates; beside
        # it the bound with the launch floor, which no launch goes under
        bb = (nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3)
        bound = max(bb)
        kernels[name] = dict(
            route="cuda", source=f"ekf_slam_tpu_torch/csrc/{source}",
            replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound,
            bound_by="bytes" if bb[0] >= bb[1] else "operations",
            library_ms=library_ms, launch_floor_ms=floor_ms,
            floor_bound_ms=max(bound, floor_ms),
            floor_bound_by=("launch" if floor_ms > bound else
                            "bytes" if bb[0] >= bb[1] else "operations"))

    Dm = P6.shape[0]
    Rm = 2 * ep.max_obs
    Pm = P6                             # its carry is gone: update in place
    Wm = (torch.randn((Dm, Rm), generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    entry("syrk_downdate", "syrk_downdate.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:229",
          launches6["syrk_downdate"], err_k1[16],
          cuda_ms(torch, lambda: K.syrk_downdate(Pm, Wm), 20),
          cuda_ms(torch, lambda: K.syrk_downdate_ref(Pm, Wm), 5),
          2 * Dm * Dm * 2 + Dm * Rm * 2,
          Dm * Dm * Rm + Dm * Dm,          # half the products, + subtract
          BF16_FLOPS,
          cuda_ms(torch, lambda: torch.addmm(Pm, Wm, Wm.T, alpha=-1), 5))
    # K1 at the batched update's rank: the 10k schedule's chunks of 512
    # observations give W [D, 1024] (phase 6c)
    Rw = 1024
    Ww = (torch.randn((Dm, Rw), generator=g, device=dev) * 1e-3).to(
        torch.bfloat16)
    bw = (2 * Dm * Dm * 2 + Dm * Rw * 2) / HBM_BYTES_PER_S * 1e3
    ow = (Dm * Dm * Rw + Dm * Dm) / BF16_FLOPS * 1e3
    kernels["syrk_downdate"]["wide_rank"] = dict(
        R=Rw, D=Dm, launches=k1_6c_launches,
        max_abs_err=err_k1[Rw],
        ms=cuda_ms(torch, lambda: K.syrk_downdate(Pm, Ww), 10),
        plain_ms=cuda_ms(torch, lambda: K.syrk_downdate_ref(Pm, Ww), 3),
        library_ms=cuda_ms(
            torch, lambda: torch.addmm(Pm, Ww, Ww.T, alpha=-1), 5),
        bound_ms=max(bw, ow), bound_by="bytes" if bw >= ow else "operations")
    del Pm, P6, Ww

    # K2 at the kernel path's shape: M = 8 against K = 10000 on P [20003²]
    M8, K8 = args8[5].shape[0], args8[2].shape[0]
    feed_ms = cuda_ms(torch, lambda: (G.strip_args(*args8), G._bearing_strip(
        args8[0], args8[2])), 200)
    entry("gate_costs", "gate_costs.cu",
          "ekf_slam_tpu/ops/pallas/gating.py:143",
          launches7["gate_costs"], err_k2,
          cuda_ms(torch, lambda: G.gate_costs_state(*args8, S_COST, True),
                  200),
          cuda_ms(torch, lambda: G.gate_costs_state_ref(*args8, S_COST,
                                                        True), 50),
          # P's pose rows, two 32-byte sectors of diagonal block per slot,
          # lm, sig, active; out
          3 * 2 * K8 * 4 + 2 * K8 * 32 + K8 * (8 + 4 + 1) + 4 * M8 * K8,
          # per slot the bearing, Jacobian and Φ0, per pair the cost
          256 * K8 + 30 * M8 * K8,
          F32_FLOPS, None)
    del args8

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
    # the paths score inside wall_search now; score_lines's launches are
    # phase 3's (its own check and the plain wall search's f32 runs)
    kernels["score_lines"].update(on_path=False, side_call_launches=side_sl)

    # wall_search at the paths' settings (the flagship extractor) and at
    # large_world's, each on its phase-3 scan of seed 0 (B = 1024, NH = 64)
    ws = {}
    for setting in ("flagship", "large_world"):
        argsw, pw = wall_search_case(0, 1024, 64, setting, dev)
        n_ok = int(K.wall_search(*argsw, pw)[1].sum().item())
        ws[setting] = dict(
            ms=cuda_ms(torch, lambda: K.wall_search(*argsw, pw), 200),
            plain_ms=cuda_ms(torch, lambda: wall_search_ref(*argsw, pw), 20),
            eager_ms=eager_ms(torch, lambda: K.wall_search(*argsw, pw), 200),
            plain_eager_ms=eager_ms(
                torch, lambda: wall_search_ref(*argsw, pw), 20),
            work=wall_search_work(1024, 64, pw, n_ok), accepted=n_ok)
    wf = ws["flagship"]
    entry("wall_search", "wall_search.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:689",
          launches6["wall_search"], err_ws, wf["ms"], wf["plain_ms"],
          *wf["work"], F32_FLOPS, None)
    kernels["wall_search"].update(
        eager_ms=wf["eager_ms"], plain_eager_ms=wf["plain_eager_ms"],
        large_world={k: v for k, v in ws["large_world"].items()
                     if k != "work"})

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

    # K6 on the factor the recompression was handed; its lower half is
    # D(D+1)/2 dot products of length R = D
    entry("syrk_gram", "syrk_gram.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:413",
          launches9["syrk_gram"], err_k6,
          event_ms(torch, lambda: K.syrk_gram(S_h, use_pallas=True)),
          event_ms(torch, lambda: K.syrk_gram_ref(S_h)),
          D9 * D9 * 4 + D9 * D9 * 4,       # read S, write G
          D9 * (D9 + 1) * D9,              # 2 flops per multiply-add
          F32_FLOPS,
          event_ms(torch, lambda: torch.matmul(S_h, S_h.T)))
    # no session launches K6 (the recompression takes the plain Gram, as
    # the JAX default does): its one launch is the call on the factor above
    kernels["syrk_gram"].update(on_path=False,
                                side_call_launches=launches_k6["syrk_gram"])
    chol_ms = event_ms(torch, lambda: chol_for_state(G6, na_h))
    state_h = FilterState(
        x=torch.zeros((D9,), device=dev), P=S_h,
        sig=torch.zeros((ep9.capacity,), device=dev),
        active=torch.zeros((ep9.capacity,), dtype=torch.bool, device=dev),
        n_active=na_h)
    rec_ms = event_ms(torch, lambda: real_recompress(state_h))
    del G6, S_h, state_h
    for name, k in kernels.items():
        log(f"phase 8 {name}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.6f} by "
            f"{k['bound_by']}, with the launch floor "
            f"{k['floor_bound_ms']:.6f} by {k['floor_bound_by']}: "
            f"bound/time {100 * k['floor_bound_ms'] / k['ms']:.1f}%; "
            f"{k['launches']} launches on its path, "
            f"{k.get('side_call_launches', 0)} beside it)")
    k1 = kernels["syrk_downdate"]
    for r_, k_ in ((Rm, k1), (Rw, k1["wide_rank"])):
        log(f"phase 8 syrk_downdate at R={r_}, D={Dm} bf16: {k_['ms']:.4f} "
            f"ms (the parent's kernel: {K1_BEFORE_MS[r_]:.4f} ms, a constant "
            f"from an earlier run, {K1_BEFORE_MS[r_] / k_['ms']:.2f}x), "
            f"torch.addmm "
            f"{k_['library_ms']:.4f} ms, plain {k_['plain_ms']:.4f} ms, "
            f"bound {k_['bound_ms']:.6f} ms by {k_['bound_by']}: bound/time "
            f"{100 * k_['bound_ms'] / k_['ms']:.1f}%")
    log(f"phase 8 launch floor: {floor_ms:.6f} ms a launch (a one-element "
        f"add_ replayed 2000 times in one CUDA graph)")
    for setting, w in ws.items():
        nbytes, ops = w["work"]
        bound = max(floor_ms, nbytes / HBM_BYTES_PER_S * 1e3,
                    ops / F32_FLOPS * 1e3)
        log(f"phase 8 wall_search {setting} (B=1024, NH=64, T=4, "
            f"{w['accepted']} walls): {w['ms']:.4f} ms device (CUDA graph), "
            f"{w['eager_ms']:.4f} ms eager with the host; its plain version "
            f"(torch ops around 1 + T score_lines launches) "
            f"{w['plain_ms']:.4f} ms device, {w['plain_eager_ms']:.4f} ms "
            f"eager; the bound with the launch floor {bound:.6f} ms")
    log(f"phase 8 gate_costs: {kernels['gate_costs']['ms']:.4f} ms as one "
        f"launch from the state, against 0.0390 ms for the strip-taking "
        f"launch with its bearing strip before it (PERF.md §6); the torch "
        f"ops that fed that launch (strips, R diagonal, bearing strip) take "
        f"{feed_ms:.4f} ms here")
    log(f"phase 8 square-root recompression at D={D9} f32: the blocked "
        f"Cholesky (chol_for_state) {chol_ms:.3f} ms, the whole "
        f"sr_recompress (plain Gram + Cholesky + one host read) "
        f"{rec_ms:.3f} ms")

    print(json.dumps({"kernels": [dict(name=n, **k)
                                  for n, k in kernels.items()]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
