#!/usr/bin/env python3
"""On-card smoke run of ekf_slam_tpu_torch (the PyTorch/CUDA port) on one
NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (each prints one line; any failure exits non-zero with no result):

1. build the seven CUDA kernels from ekf_slam_tpu_torch/csrc (one nvcc per
   source, started together), print the card's name and power limit, and
   count the tensor-core instructions (HMMA/HGMMA) in the SASS of K1's
   bf16 kernel and of K6's f32 (3xTF32) kernel (`cuobjdump -sass`; more
   than 0 in each, or the phase fails); print K6's `-Xptxas -v` report
   (registers, spills, shared memory of each of its kernels) and fail on
   any spill;
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
   K6 syrk_gram at the edge shapes of its f32 tiling (D in 1, 127, 128,
   129 by R in 1, 3, 31, 33; inputs from numpy, checks.gram_dense_case),
   D = R = 20067 f32, D = 1003 by R = 1500 f32, and bf16 and f64 at
   D = 517 (≤ 1e-5 of |G|max, 1e-12 at f64; bit-symmetric; the
   accumulation dtype), each against its plain version run on the CPU
   (the gap to the card's is printed: at D = R = 20067 that is mostly
   cuBLAS's own f32 error); each f32 case
   also through checks.gram_compare (e against the f64 Gram within 4·m +
   8·2⁻²³, m the largest e of the plain f32 Grams: the CPU's, the CPU's
   with the columns permuted, the card's with allow_tf32 False), where
   the single-TF32-pass control (checks.tf32_single_pass) must fail at
   the edge shapes; at the dense D = R = 20067 the kernel's e must also be
   ≤ 2 × the card's torch.matmul e (the control's e is printed); then a
   banded S at D = R = 20067 (checks.gram_banded_case: ≤ 256 nonzero
   terms a sum): the kernel passes gram_compare, the control fails;
5. the session on the card against the same session on the CPU (the same
   draws), for the tuned path (rows + syrk) and the kernel path (rows,
   pair gather, fused gate, gemm correction through cov_update), capacity
   256, f32 P, 32 ticks, and for the square-root path (update_mode=
   'srekf_fast', pair gather, capacity 256, 80 ticks, a 16-column noise
   buffer so five recompressions run, each one K6 launch): n_active
   equal every tick, pose
   within 1e-3 (m and degrees; on the square-root path's 80 ticks, m and
   radians, beside the CPU's own f32-against-f64 gap, since the extractor's
   f32 rounding of wall bearings moves the heading by ~1e-2 degrees); then
   the JAX package's default session, the sequential filter with its
   preset as constructed (EKF_SLAM_UC, and EKF_SLAM: capacity 128,
   ref_compat on, f32) and the one-seed wall search at
   tests/test_sim_session.py's settings, and the QR square-root session
   (update_mode='srekf', capacity 64), 32 ticks each: no kernel launched
   (the QR session's wall_search aside), n_active equal every tick,
   position within 1e-3 m and heading within 1e-3 rad, beside the CPU's
   own f32-against-f64 gap; then the recompression's QR branch on a
   factor whose Gram is singular, on the card and on the CPU (the
   Cholesky gives NaN, the QR branch's result is taken, finite, lower
   triangular, within 1e-4 of the CPU's); then the control and
   robustness modes card against CPU (capacity 256, 32 ticks, the same
   draws): ICP and fused control with the campaign's ICP settings (the
   fused run with scans 12-16 blanked, so both choices occur), the
   guard (3 cm) with the odometry of ticks 10 and 20 corrupted once on
   the CPU by utils.faults.corrupt_odometry (so it rejects ticks), and
   maintenance (merge radius 4.9 m, trace cap 3.0) on the tuned path
   and on srekf_fast: launches (srekf_fast: one K6 per recompression and
   per evicting tick), n_active equal every tick, the decisions (ICP
   choice, rejected ticks, evictions) equal every tick
   (checks.decisions_differ), pose within 1e-3 (m and rad); then the
   same maintenance runs on the card alone with PyTorch's sync debug
   mode on, tick by tick: exactly one host sync a tick at
   models/maintenance.py (the eviction's read of the drop count), and on
   srekf_fast one more at models/srekf_fast.py for each recompression
   (each evicting tick's and the schedule's), no other;
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
   wall_search launch per tick, one K6 launch (the recompression's Gram)
   and no K1, K2, K4 or score_lines launch, no host sync on an ordinary
   tick and exactly one on the recompression tick, S lower triangular
   with its 64 buffer columns exactly 0 after the recompression; the
   median ordinary tick, the recompression tick (beside an earlier
   run's with the plain Gram, a constant) and a torch.profiler line,
   whose device operations per ordinary tick must be fewer than with the
   rounds as torch ops.
   Then K6 on the factor the recompression was handed: within 1e-5 of
   |S·Sᵀ|max, bit-symmetric, through checks.gram_compare, where the
   single-TF32-pass control must fail; and the session's recompressed
   factor within 1e-3 of the blocked Cholesky of torch.matmul(S, S.T) on
   the active block;
8. the launch floor (a one-element add_ replayed 2000 times in one CUDA
   graph), then each kernel timed at its path's shapes (CUDA-graph
   replays between CUDA events; K6, ~0.1 s a call, 3 calls between CUDA
   events after one warm-up) beside its plain version, its library
   yardstick, its roofline bound (bytes or operations at the card's peak
   rates) and that bound raised to the launch floor, with its share of
   the latter; K1 also at R = 1024 beside torch.addmm and the parent's
   kernel's time; K2 also beside the torch ops that fed its strip-taking
   predecessor; wall_search at the flagship and large_world settings, as
   CUDA-graph replays (device time) and as eager calls (host clock around
   synchronised calls: what a tick pays), beside its plain version timed
   both ways; K6 also on the dense S of phase 4 beside torch.matmul, and
   (in the log only, a different function) a single-TF32-pass
   torch.matmul with allow_tf32 True; the blocked Cholesky, and the whole
   recompression at D = 20067 with K6 and with the plain Gram, in turns
   (plain, K6, K6, plain): K6's recompression must be faster by at least
   0.8 × (the library Gram's time − K6's);
9. the sequential session at full width: update_mode='sequential',
   EKF_SLAM_UC, the one-seed wall search, capacity 10000 (P [20003²] f32,
   unpadded), 32 ticks of the flagship run with every kernel counter set
   to 0 just before and read just after: no kernel launched, finite state,
   landmarks mapped, ATE < 0.5 m, no host sync in a tick; the median tick
   and a torch.profiler line, and the rank-2 update (P.addmm_ at the
   path's shape, CUDA-graph replays) beside its HBM bound;
9b. bench.py's sequential metric (bench.py:189-208): a full state of
   1,000 landmarks (checks.full_state), ML association with s_cost 1e6
   and s_thresh 1e12, and chains of 256 gate + update steps
   (checks.sequential_chain), one warm-up and 5 timed from copies of the
   state: finite, no host sync; the median with its spread, updates/s
   and a profile line of a chain's first 32 steps;
9c. the QR square-root session at capacity 1000 (D = 2003) for 32 ticks
   of the flagship run: finite state, landmarks mapped, ATE < 0.5 m, no
   host sync, one wall_search launch a tick and no other kernel, L lower
   triangular with diag ≥ 0 and its inactive rows exactly 0; the median
   tick, a profile line, and the tick's two QRs timed alone with their
   share of the tick;
10. the large-world campaign session at full width
   (experiments/chip_r5_world.py's, the one cut: the first 400 ticks of
   the route): floorplan_world(16, 16, seed=0), serpentine_waypoints,
   waypoint_controls(step=0.25), 1024 beams, odometry heading noise
   0.5°; checks.campaign_params(10000, float32, 'fused', 0.5) with
   tuned_params (bf16 P [20480²], SYRK, max_obs 24, guard 0.5 m, fitted
   R, NH = 192, a 20,000-entry table); SlamSession(control_source=
   'fused', ICP pairing 0.4 m, gates 200 inliers and 0.08 m RMS,
   maintain_merge_radius 0.4, collect_nis).  A sync census of three
   warm-up ticks (exactly one host sync a tick, maintenance's read), then
   the run with the counters set to 0 just before and read just after:
   one K1 and one wall_search launch a tick and no other, finite state,
   landmarks mapped, ICP taken on most ticks, aligned ATE (sim.world.
   align_se2) < 1.5 m; on every tick of it a host span (perf_counter)
   and a CUDA-event interval around ICP's control, the guard's snapshot
   and verdict, and maintenance, whose medians are each feature's cost
   a tick; it prints the median tick (CUDA events),
   map_accuracy against cluster_feet(true_feet(world), 0.5), the NIS
   mean, evictions and rejected ticks, a profile line, ICP's device
   operations and time a call, the guard's passes against their 6·|P|
   HBM bound and duplicate_mask's time; then the first 32 ticks again
   with every feature on, the guard off, maintenance off and odometry
   control, two runs each in turns, for what each feature costs a tick
   (resolved only where every run without the feature is faster than
   every run with all on);
10b. eviction at full width: checks.evict_case (bench.py's full state
   at K = 10000, all slots active, per-slot variances spread) with about
   a quarter of the slots dropped by prune_by_uncertainty and
   duplicate_mask: the dense eviction on f32 P [20003²] and bf16 P
   [20480²], its kept block bit-equal to the gather of the kept rows and
   columns and zero past them, timed against its HBM bound; the factored
   eviction on S [20067²] f32 (the state's Cholesky factor): one K6
   launch, the new factor finite and lower triangular with the freed
   rows 0, and the Gram of 64 of its kept rows within checks.gram_compare's
   limit of the f64 Gram of the old factor's kept rows;
11. the live operating path on phase 6's configuration (tuned_params at
   capacity 10000, bf16 P [20480²]): io/stream.StreamingSlamSession fed
   host numpy arrays a tick at a time, the flagship run's first 64
   ticks cycled twice (bench.py cycles its run 4 times; cut to 2 to keep
   the script inside its time limit with phase 13), window 16,
   max_pending 2.  11a: the stream against an offline run of a fresh
   session with the same seed on the card, with the counters set to 0
   just before the stream and read just after (one K1 and one
   wall_search launch a tick, no other) and PyTorch's sync debug mode
   over the whole run (no host sync but at the stream's event wait);
   poses and n_active bit-equal on every tick, or, where not, both runs
   again under torch.use_deterministic_algorithms (the ops without a
   deterministic version printed) with every decision (n_active, n_obs,
   the observations' validity and slots) still equal; then three runs
   each at window 16 and window 1, in turns, each checked the same way:
   the medians of StreamStats.summary() (ticks/s, latency p50, p99 and
   mean) with their spreads.  11b: the socket feed: the port's Python
   feeder (io/socket_feed.serve_trajectory) in a spawned process on
   localhost sends the 64 ticks, io/socket_feed.SocketScanSource
   receives them and the stream runs them, equal to the offline run's
   first 64 ticks; then the port's C++ codec writes them as a scan log
   (native=True, read back exactly) and the C++ feeder
   (native_feeder_path(), built with g++ into build/torch_native/)
   replays it over TCP, with the same check.  11c: filter_health on the
   10k state at the end of each window of a 128-tick stream, logged
   with MetricsLogger to a temporary JSONL file: finite on every window;
   the last window's asym, min_diag and trace printed;
12. the submap and fleet layer (ekf_slam_tpu_torch/parallel/), after
   phases 6-11 freed their tensors.  12a: FleetSlamSession(n_sessions=4,
   seed=100) at phase 6's configuration (tuned_params at capacity 10000,
   P [4, 20480, 20480] bf16 stacked) on examples/fleet_mapping.py's
   trajectories (rectangle_room(4, 3), circle_controls(T, 0.04 + 0.01·i,
   2 + i), 1024 beams) for 32 fleet ticks, the counters set to 0 just
   before and read after every tick, PyTorch's sync debug mode over the
   run: exactly 4 K1 and 4 wall_search launches every fleet tick and no
   other, no host sync, the bytes copied back into the stacked carry a
   tick (fewer than one robot's P: P is updated in its slice), ATE per
   robot < 0.5 m; each robot's poses, n_active, x and P bit-equal to a
   solo SlamSession of seed 100 + i on the same inputs on the card; the
   median fleet tick (CUDA events) beside the solo sessions' and phase
   6's, and a profile line.  12b: robot_map_from_carry for each robot
   (its first scan, guesses at the origin) and merge_maps with the
   example's gates (60 inliers, 0.25 m RMS) on the card in f32, against
   the CPU's f64 merge of the same maps: the same scan-match edges and
   landmark counts, anchors and landmarks within MERGE_TOL_M and
   MERGE_TOL_DEG (the CPU's own f32 gap printed beside); its time.  12c:
   experiments/chip_r5_world.py:179-216's submap pipeline on phase 10's
   route (the one cut: its first 2,000 ticks, five 400-tick submaps, the
   least multiple of 400 from 1,600 whose run accepts a loop closure on
   the card; the closures of the first 1,600 ticks, counted by the
   detector over the run's first four submaps, are printed; 2,400 where
   2,000 accept none): campaign_params(192, f32, 'fused', 0.5) with a 512-entry
   table, fused control, the campaign's ICP gates and maintenance,
   keyframes every 40 ticks; segment 0 bit-equal to a plain session over
   its 400 ticks; one wall_search launch a tick and no other; every tick
   exactly one host sync (maintenance's read), the segment boundaries'
   syncs counted; detect_loop_closures_traj(radius 10, RMS 0.16, 120
   inliers, 2 a pair, within 3 m and 5°) accepting at least one closure,
   optimize(iters=30) True, every global pose and landmark finite, no
   frozen P sharing storage with another or the guard's snapshot; the
   aligned ATE (sim.world.align_se2) before and after the optimisation,
   map_accuracy against cluster_feet(true_feet(world), 0.5) and the
   wall-line score, the median segment tick and the seconds of closure
   detection and optimize, with no accuracy threshold.  12d:
   ParallelSubmapSlam(n_submaps=4) at 12c's filter and extractor
   (odometry control) on the route's first 128 ticks with draws made on
   the card: each segment's poses, x and P bit-equal to SubmapSlam in
   32-tick segments given the same draws, 4 submaps, 5 graph nodes, one
   wall_search launch a segment tick, a ragged T raising ValueError.
   ``--phase12-only`` runs the build and phase 12 alone (development; no
   result line);
13. checkpoints and crash recovery (utils/checkpointing.py,
   utils/recovery.py, the stream's heartbeats), after phase 12 freed its
   tensors, on phase 6's configuration (tuned_params at capacity 10000,
   bf16 P [20480²]) over the flagship run's first 160 ticks, drawing from
   the session's generator; every checkpoint under a temporary directory
   deleted once its sub-phase is checked, with its size and the seconds
   of each save, write and load printed.  An uninterrupted run keeps its
   carry and generator state on the card after every checkpoint tick.
   13a: run_with_checkpoints(every=32) killed at tick 100 (HostCrash),
   resume_latest in a fresh session from tick 96, with the counters set
   to 0 just before it (one K1 and one wall_search launch a tick, no
   other): every leaf of the carry (x, P, n_active, the table, ...), the
   generator's state and the poses of ticks 96-159 bit-equal to the
   uninterrupted run, or, where not, both runs again under
   torch.use_deterministic_algorithms (the ops without a deterministic
   version printed) with every decision equal.  13b: the same crash run in
   a spawned process reporting each tick on a pipe, SIGKILLed once past
   tick 100; latest_step_dir names step_00000096; the resume checked as
   13a.  13c: drive_ticks(every=32) killed before the step of tick 100,
   resume_latest_ticks, checked as 13a; then the stream at window 16,
   max_pending 2, checkpoint_every 2 (heartbeats at ticks 32, 64, ...,
   160), under PyTorch's sync debug mode (no host sync outside the event
   wait and the heartbeat's write), its outputs bit-equal to the
   uninterrupted run's and each heartbeat equal to its carry after exactly
   the labelled tick; three runs with heartbeats and three without, in
   turns, for ticks/s and latency p50/p99 (medians and spreads); a stream
   abandoned after 100 ticks and a fresh stream restored from its newest
   heartbeat before the first push, its ticks and final carry bit-equal.
   13d: phase 5's srekf_fast session (capacity 256, pair gather, a
   16-column noise buffer) for 80 ticks, run_with_checkpoints(every=20)
   killed at 47, resumed from 40 with sr_tick 40, recompressing after
   ticks 48, 64 and 80 (one K6 each, one K5 a tick), bit-equal to the
   uninterrupted run.  ``--phase13-only`` runs the build and phase 13
   alone (development; no result line).

Every log line starts with the seconds since the script started.  The
last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  A kernel's `launches` in the JSON is its
count from its path's run.  K1's entry (R = 16, phase 6's count) also has
`wide_rank`: K1 at R = 1024, D = 20480, with its launches counted in
phase 6c's timed and warm-up batches, its time beside the plain
version's, torch.addmm's and its bound.  The parent kernel's times
(K1_BEFORE_MS, constants from an earlier run) appear in the phase-8 log
only, not in the JSON, as are the earlier K6's time and K6's f32 CUDA-core
bound (K6's `bound_ms` is by 3xTF32 operations at the TF32 rate).  K6's
`launches` is phase 7b's count, with `on_path: true`.  score_lines's
entry has `on_path: false` and `side_call_launches`, since its scoring
now runs inside wall_search on every path (its side calls are phase
3's).  Every entry also has
`launch_floor_ms`, `floor_bound_ms` and `floor_bound_by` ("launch" where
the floor is the larger): the bound raised to the launch floor, beside
`bound_ms`.  K1's and wall_search's entries also carry
`campaign_launches` (phase 10's counts), `stream_launches` (phase
11a's) and `fleet_launches` (phase 12a's), wall_search's also
`submap_launches` (phases 12c and 12d together), K6's
`eviction_launches` (phase 10b's); K1's and wall_search's
`recovery_launches` are phase 13a's resume's counts, K5's and K6's phase
13d's.  This script imports nothing of JAX or of ekf_slam_tpu.
"""
import copy
import dataclasses
import json
import math
import multiprocessing
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, dense bf16 tensor
# rate, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
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
# the parent's K6 (f32 FMAs on CUDA cores) on the recompression's factor,
# and the recompression tick with the plain Gram: phase 8 and 7b on NVIDIA
# H100 80GB HBM3, 700.00 W (PERF.md §5-6)
K6_BEFORE_MS = 289.8155
RECOMPRESSION_TICK_BEFORE_MS = 452.857

# phase 12b's tolerance on the card's f32 map merge (ICP and the device
# Gauss-Newton, whose sums run on atomics in no fixed order) against the
# CPU's f64 merge of the same maps: anchors and merged landmarks within
# 1e-3 m, anchor headings within 1e-2 degrees.  The CPU's own f32 merge of
# examples/fleet_mapping.py's maps at capacity 2001 is 1.2e-5 m and
# 1.8e-4 degrees off its f64 merge; this leaves two orders of magnitude for
# the card's other summation orders, and stays two orders under the 0.3 m
# landmark merge radius
MERGE_TOL_M = 1e-3
MERGE_TOL_DEG = 1e-2

# device symbols of the port's kernels, as torch.profiler names them
KERNEL_SYMBOLS = ("syrk_downdate_kernel", "gate_costs_kernel",
                  "score_lines_kernel", "wall_search_kernel",
                  "cov_update_kernel", "pair_gather_kernel",
                  "syrk_gram_kernel")


_START = time.perf_counter()


def log(msg):
    """One line of the log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _START:7.1f} s] {msg}", flush=True)


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


def syncs_of(caught):
    """file:line of each host sync PyTorch's sync-debug mode reported
    among the recorded warnings ``caught``."""
    return [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
            for w in caught if "synchroniz" in str(w.message)]


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


def ptxas_report(text):
    """Each kernel's figures from nvcc's `-Xptxas -v` output: {symbol:
    dict(registers, stack, spill_stores, spill_loads, smem)}, None where
    a figure is missing (dynamic shared memory is not in the report)."""
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", chunk)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", chunk)
        smem = re.search(r"(\d+) bytes smem", chunk)
        out[chunk.split("'")[0]] = dict(
            registers=int(regs[1]) if regs else None,
            stack=int(frame[1]) if frame else None,
            spill_stores=int(frame[2]) if frame else None,
            spill_loads=int(frame[3]) if frame else None,
            smem=int(smem[1]) if smem else 0)
    return out


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
    units = ({"batch": "batches"}.get(unit, f"{unit}s") if n > 1
             else unit)
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
    syncs = syncs_of(caught)
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
    return dict(sess=sess, carry=carry, launches=launches, summary=summary,
                tick_median=statistics.median(tick_ms))


# phase 12's sizes: the fleet of four at phase 6's configuration
# (capacity 10000); the campaign route in 400-tick submaps at the
# campaign's per-submap capacity of 192, cut to its first 2,000 ticks: the
# least multiple of 400 from 1,600 whose run accepts a loop closure on the
# card (1,600 ticks accepted none: NVIDIA H100 80GB HBM3, 700.00 W, in a
# run of phase 12 alone; each run rechecks it on its first four
# submaps), with 2,400 where 2,000 accept none; 128 ticks of concurrent
# submaps.  The fleet's ticks and the concurrent submaps' are half of
# what they once were, to keep the script inside its time limit
PHASE12 = dict(capacity=10000, robots=4, fleet_ticks=32, prof_ticks=4,
               beams=1024, route_first=1600, route_ticks=2000,
               route_max=2400, segment=400, sub_capacity=192, table=512,
               parallel_ticks=128)


def tick_census(torch, fn):
    """Wrap a session's ``step`` so that every call records a CUDA-event
    interval and the host syncs PyTorch's sync-debug mode reports inside
    it (with the mode on around the caller).  Returns the wrapper and its
    records: [(start event, end event, [file:line, ...])]."""
    recs = []

    def inner(*a, **k):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            e0.record()
            out = fn(*a, **k)
            e1.record()
        recs.append((e0, e1, syncs_of(caught)))
        return out
    return inner, recs


def angle_gap(a, b):
    return np.abs((np.asarray(a) - np.asarray(b) + 180.0) % 360.0 - 180.0)


def fleet_and_submaps(torch, tp, W, counted, dev, card, tick6_ms, size):
    """Phase 12: the submap and fleet layer (ekf_slam_tpu_torch/parallel/)
    at full width.  Returns the kernels' launch counts for the JSON."""
    from ekf_slam_tpu_torch.checks import (CAMPAIGN_SESSION, campaign_params,
                                           campaign_route)
    from ekf_slam_tpu_torch.parallel.fleet_merge import (merge_maps,
                                                         robot_map_from_carry)
    from ekf_slam_tpu_torch.parallel.multi import FleetSlamSession, tree_map
    from ekf_slam_tpu_torch.parallel.parallel_submaps import (
        ParallelSubmapSlam)
    from ekf_slam_tpu_torch.parallel.submaps import SubmapSlam
    from ekf_slam_tpu_torch.utils.schedule import tuned_params

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counted.items()}

    def only(**want):
        return {k: want.get(k, 0) for k in counted}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 12 start: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated on the card after phases 1-11 freed theirs")

    # -- 12a. the fleet: four robots of the tuned 10k session -----------------
    # examples/fleet_mapping.py's trajectories: robot i drives
    # circle_controls(T, 0.04 + 0.01·i, 2 + i) in rectangle_room(4, 3),
    # simulated from generator seed i; FleetSlamSession(seed=100), so robot
    # i draws from a generator seeded 100 + i
    N, T, TP_ = size["robots"], size["fleet_ticks"], size["prof_ticks"]
    ep, rp = slice_params(torch, size["capacity"])
    ep = tuned_params(ep, batch=ep.max_obs)
    cfg = tp.SimConfig(n_beams=size["beams"], max_range=12.0)
    room = W.rectangle_room(4.0, 3.0, device=dev)
    trajs = []
    for i in range(N):
        g_ = torch.Generator(device=dev)
        g_.manual_seed(i)
        trajs.append(W.simulate(room, W.circle_controls(
            T + TP_, 0.04 + 0.01 * i, 2.0 + i, device=dev), cfg, g_))
    odom = torch.stack([t_.odom for t_ in trajs], 1)             # [T,N,3]
    ranges = torch.stack([t_.ranges for t_ in trajs], 1)         # [T,N,B]
    beams = trajs[0].beam_angles
    fleet = FleetSlamSession(n_sessions=N, ekf_params=ep, ransac_params=rp,
                             seed=100, device=dev)
    warm = fleet.init_carry(first_odoms=odom[0])
    for t in range(2):
        warm, _ = fleet.step(warm, odom[t], ranges[t], beams)
    del warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    carry = fleet.init_carry(first_odoms=odom[0])
    p_bytes = carry.filt.P[0].numel() * carry.filt.P.element_size()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(T + 1)]
    outs, per_tick, copied = [], [], []
    zero()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            w0 = time.perf_counter()
            ev[0].record()
            for t in range(T):
                before = read()
                carry, o = fleet.step(carry, odom[t], ranges[t], beams)
                ev[t + 1].record()
                now = read()
                per_tick.append({k: now[k] - before[k] for k in now})
                copied.append(fleet.copied_bytes)
                outs.append(o)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3 / T
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = syncs_of(caught)
    launches12a = read()
    fticks = [ev[t].elapsed_time(ev[t + 1]) for t in range(T)]
    fo = tree_map(lambda *xs: torch.stack(xs), *outs)              # [T,N,...]
    want_tick = only(syrk_downdate=N, wall_search=N)
    bad = [t for t, c in enumerate(per_tick) if c != want_tick]
    check(not bad, f"fleet: ticks {bad[:5]} launched {per_tick[bad[0]] if bad else None}, expected {want_tick} a fleet tick")
    check(launches12a == only(syrk_downdate=N * T, wall_search=N * T),
          f"fleet launches {launches12a}")
    check(not syncs, f"fleet: {len(syncs)} host syncs in {T} fleet ticks "
          f"at {sorted(set(syncs))[:8]}")
    check(carry.filt.P.shape[0] == N
          and carry.filt.P.dtype == torch.bfloat16
          and carry.filt.P.shape[1] % 512 == 0,
          f"fleet P is {tuple(carry.filt.P.shape)} {carry.filt.P.dtype}")
    check(max(copied) < p_bytes, f"fleet: {max(copied)} bytes copied back "
          f"in a tick, a robot's P is {p_bytes}: P was not updated in place")
    ates = []
    for i in range(N):
        check(bool(torch.isfinite(carry.filt.x[i]).all())
              and bool(torch.isfinite(carry.filt.P[i]).all()),
              f"fleet robot {i}: state not finite")
        check(int(fo.n_active[-1, i].item()) > 0,
              f"fleet robot {i}: no landmark mapped")
        ates.append(W.ate_rmse(fo.pose[:, i, :2],
                               trajs[i].truth[:T, :2]).item())
    check(max(ates) < 0.5, f"fleet: ATE {ates} m against the truth")
    # each robot against a solo session of seed 100 + i on its inputs
    solo_ticks = []
    for i in range(N):
        s_ = tp.SlamSession(ekf_params=ep, ransac_params=rp, seed=100 + i,
                            device=dev)
        c_ = s_.init_carry(first_odom=odom[0, i])
        ev_ = [torch.cuda.Event(enable_timing=True) for _ in range(T + 1)]
        po_, na_ = [], []
        ev_[0].record()
        for t in range(T):
            c_, o_ = s_.step(c_, odom[t, i], ranges[t, i], beams)
            ev_[t + 1].record()
            po_.append(o_.pose)
            na_.append(o_.n_active)
        torch.cuda.synchronize()
        solo_ticks += [ev_[t].elapsed_time(ev_[t + 1]) for t in range(T)]
        check(torch.equal(torch.stack(po_), fo.pose[:, i])
              and torch.equal(torch.stack(na_), fo.n_active[:, i]),
              f"fleet robot {i}: poses or n_active differ from the solo "
              f"session's")
        check(torch.equal(c_.filt.P, carry.filt.P[i])
              and torch.equal(c_.filt.x, carry.filt.x[i]),
              f"fleet robot {i}: P or x differ from the solo session's")
        del s_, c_
        torch.cuda.empty_cache()

    def more_ticks():
        c_ = carry
        for t in range(T, T + TP_):
            c_, _ = fleet.step(c_, odom[t], ranges[t], beams)
    # the carry is done with after the merge's maps; profile after them
    maps = [robot_map_from_carry(tree_map(lambda a, i=i: a[i], carry),
                                 ranges[0, i], beams, np.zeros(3))
            for i in range(N)]
    prof12 = profile_device(torch, more_ticks, TP_, "fleet tick")[0]
    fmed, smed = statistics.median(fticks), statistics.median(solo_ticks)
    log(f"phase 12a fleet ok: {N} robots of the tuned session (capacity "
        f"{ep.capacity}, P {tuple(carry.filt.P.shape)} bf16 stacked, "
        f"{size['beams']} beams, examples/fleet_mapping.py's circles), {T} "
        f"fleet ticks; each robot's poses, n_active, x and P bit-equal to "
        f"a solo SlamSession of seed 100 + i on the card; launches "
        f"{launches12a} ({want_tick['syrk_downdate']} K1 and "
        f"{want_tick['wall_search']} wall_search every fleet tick, no other"
        f"); {len(syncs)} host syncs in the run; bytes copied back into the "
        f"stacked carry a fleet tick: median {statistics.median(copied):.0f},"
        f" max {max(copied)} (a robot's P is {p_bytes}); ATE per robot "
        f"{[round(a, 4) for a in ates]} m; n_active "
        f"{fo.n_active[-1].tolist()}; fleet tick median {fmed:.3f} ms "
        f"(CUDA events; wall {wall:.3f} ms), solo tick median {smed:.3f} "
        f"ms over the four solo runs ({fmed / smed:.2f}×), phase 6's tick "
        + (f"median {tick6_ms:.3f} ms ({fmed / tick6_ms:.2f}×)"
           if tick6_ms is not None else "not run in this call")
        + f"; card: {card}")
    log(f"phase 12a profile: {prof12}")

    # -- 12b. the fleet map merge ---------------------------------------------
    # examples/fleet_mapping.py's merge: every robot's map from its slice of
    # the fleet carry and its first scan, deployment guesses at the origin,
    # gates 60 inliers and 0.25 m RMS; on the card in f32 (the scans'
    # dtype), against the same maps merged on the CPU in f64 and f32
    kw_m = dict(icp_min_inliers=60, icp_max_rmse=0.25)
    merge_s = []
    for _ in range(2):
        m0 = time.perf_counter()
        res = merge_maps(maps, device=dev, **kw_m)
        torch.cuda.synchronize()
        merge_s.append(time.perf_counter() - m0)
    ref64 = merge_maps(maps, dtype=torch.float64, device="cpu", **kw_m)
    ref32 = merge_maps(maps, dtype=torch.float32, device="cpu", **kw_m)

    def gaps(a, b):
        if a.landmarks.shape != b.landmarks.shape:
            lm = float("inf")
        else:
            lm = float(np.abs(a.landmarks - b.landmarks).max(initial=0.0))
        return (float(np.abs(a.anchors[:, :2] - b.anchors[:, :2]).max()),
                float(angle_gap(a.anchors[:, 2], b.anchors[:, 2]).max()), lm)
    g_card, g_32 = gaps(res, ref64), gaps(ref32, ref64)
    check(res.graph.nodes.dtype == torch.float32
          and res.graph.nodes.device.type == torch.device(dev).type,
          f"merge ran in {res.graph.nodes.dtype} on {res.graph.nodes.device}")
    check(res.n_icp_edges == ref64.n_icp_edges
          and res.landmarks.shape == ref64.landmarks.shape
          and res.n_before_merge == ref64.n_before_merge,
          f"merge: card {res.n_icp_edges} scan-match edges, "
          f"{res.landmarks.shape[0]} of {res.n_before_merge} landmarks; CPU "
          f"f64 {ref64.n_icp_edges}, {ref64.landmarks.shape[0]} of "
          f"{ref64.n_before_merge}")
    check(g_card[0] <= MERGE_TOL_M and g_card[1] <= MERGE_TOL_DEG
          and g_card[2] <= MERGE_TOL_M,
          f"merge: card against CPU f64 anchors {g_card[0]:.3e} m, "
          f"{g_card[1]:.3e}°, landmarks {g_card[2]:.3e} m, over the "
          f"tolerance ({MERGE_TOL_M} m, {MERGE_TOL_DEG}°)")
    log(f"phase 12b merge ok: {N} robot maps, {res.n_icp_edges} scan-match "
        f"edges (CPU f64: {ref64.n_icp_edges}), {res.landmarks.shape[0]} "
        f"merged landmarks of {res.n_before_merge}; card (f32, ICP and the "
        f"device Gauss-Newton) against the CPU's f64 merge of the same "
        f"maps: anchors {g_card[0]:.3e} m and {g_card[1]:.3e}°, landmarks "
        f"{g_card[2]:.3e} m (tolerance {MERGE_TOL_M} m, {MERGE_TOL_DEG}°; the "
        f"CPU's own f32 merge: {g_32[0]:.3e} m, {g_32[1]:.3e}°, "
        f"{g_32[2]:.3e} m); anchors {np.round(res.anchors, 4).tolist()}; "
        f"merge {merge_s[0]:.3f} s first call, {merge_s[1]:.3f} s second "
        f"(host clock, synchronised); card: {card}")
    del fleet, carry, outs, fo, maps, trajs, odom, ranges
    torch.cuda.empty_cache()

    # -- 12c. the large-world submap pipeline -----------------------------------
    # experiments/chip_r5_world.py:179-216 on phase 10's route: floorplan
    # 16 × 16, 1024 beams, heading noise 0.5°; campaign_params(192, f32,
    # 'fused', 0.5) with a 512-entry table, in 400-tick submaps with a
    # keyframe scan every 40 ticks; the one cut: the first 1,600 ticks
    worldc, ctrlc, startc = campaign_route(16, size["route_max"])
    worldc = W.World(worldc.segments.to(dev, torch.float32))
    cfgc = tp.SimConfig(n_beams=size["beams"], max_range=10.0,
                        range_noise_std=0.01, odom_xy_noise_std=0.004,
                        odom_theta_noise_std=0.5)
    gc_ = torch.Generator(device=dev)
    gc_.manual_seed(0)
    trc = W.simulate(worldc, torch.tensor(ctrlc, dtype=torch.float32,
                                          device=dev), cfgc, gc_,
                     start_pose=tuple(startc))
    epc, rpc = campaign_params(size["sub_capacity"], torch.float32, "fused",
                               0.5)
    rpc = dataclasses.replace(rpc, table_capacity=size["table"])
    check((epc.pht_mode, epc.cov_dtype, epc.correction, epc.use_pallas,
           rpc.n_hypotheses, rpc.wall_search_timeout)
          == ("dense", None, "gemm", False, 192, 9),
          f"submap configuration changed: {epc}, {rpc}")
    skw = dict(control_source="fused", **CAMPAIGN_SESSION)
    L = size["segment"]

    # segment 0 against a plain session of the same configuration from
    # the same initial carry (the submap's frame: no init_pose)
    plain = tp.SlamSession(ekf_params=epc, ransac_params=rpc, seed=1,
                           device=dev, **skw)
    pc, po = plain.run(trc.odom[:L], trc.ranges[:L], trc.beam_angles)
    torch.cuda.synchronize()

    def pipeline(Tn):
        sm = SubmapSlam(ekf_params=epc, ransac_params=rpc, seed=1,
                        ticks_per_submap=L, kf_every=40, session_kwargs=skw,
                        start_pose=startc, device=dev)
        sm.session.step, recs = tick_census(torch, sm.session.step)
        zero()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r0 = time.perf_counter()
                pre = sm.run(trc.odom[:Tn], trc.ranges[:Tn],
                             trc.beam_angles)
                run_s = time.perf_counter() - r0
        finally:
            torch.cuda.set_sync_debug_mode(0)
        del sm.session.step                  # the class's own again
        launches = read()
        # the closures a run of the first route_first ticks accepts: the
        # detector over this run's first submaps, which are that run's
        # (each segment starts from a fresh carry), on a shallow copy
        k = size["route_first"] // L
        first = copy.copy(sm)
        first.submaps, first._segment_local = (sm.submaps[:k],
                                               sm._segment_local[:k])
        n_first = first.detect_loop_closures_traj(
            trc.ranges[:k * L], trc.beam_angles, **lc_kw)
        d0 = time.perf_counter()
        n_lc = sm.detect_loop_closures_traj(trc.ranges[:Tn],
                                            trc.beam_angles, **lc_kw)
        det_s = time.perf_counter() - d0
        return dict(sm=sm, pre=pre, recs=recs, boundary=syncs_of(caught),
                    launches=launches, n_lc=n_lc, run_s=run_s, det_s=det_s,
                    first=(k * L, n_first))

    lc_kw = dict(radius=10.0, min_separation=1, icp_max_rmse=0.16,
                 icp_min_inliers=120, max_per_pair=2, max_corr_xy=3.0,
                 max_corr_deg=5.0)
    Tc = size["route_ticks"]
    got = pipeline(Tc)
    tried = [got["first"], (Tc, got["n_lc"])]
    while got["n_lc"] == 0 and Tc + L <= size["route_max"]:
        Tc += L
        del got
        torch.cuda.empty_cache()
        got = pipeline(Tc)
        tried.append((Tc, got["n_lc"]))
    sm = got["sm"]
    check(got["n_lc"] >= 1, f"submaps: no loop closure accepted in "
          f"{tried} (ticks, closures)")
    check(got["launches"] == only(wall_search=Tc),
          f"submaps: launches {got['launches']}, expected {Tc} wall_search "
          f"and no other")
    tick_syncs = [r[2] for r in got["recs"]]
    check(len(tick_syncs) == Tc and all(
        len(s_) == 1 and "models/maintenance.py" in s_[0]
        for s_ in tick_syncs),
          f"submaps: the ticks' host syncs are not maintenance's one a tick: "
          f"{[s_ for s_ in tick_syncs if len(s_) != 1][:3]}")
    n_seg = len(sm.submaps)
    check(n_seg == Tc // L, f"submaps: {n_seg} submaps in {Tc} ticks")
    check(np.array_equal(sm._segment_local[0],
                         po.pose.cpu().numpy())
          and torch.equal(sm.submaps[0].carry.filt.P, pc.filt.P)
          and torch.equal(sm.submaps[0].carry.filt.x, pc.filt.x),
          "submaps: segment 0 differs from a plain session over its ticks")
    snap = sm.session._snap
    check(all(s_.carry.filt.P.untyped_storage().data_ptr()
              != snap.untyped_storage().data_ptr() for s_ in sm.submaps)
          and len({s_.carry.filt.P.untyped_storage().data_ptr()
                   for s_ in sm.submaps}) == n_seg,
          "submaps: a frozen P shares storage with another or with the "
          "guard's snapshot")
    o0 = time.perf_counter()
    opt_ok = sm.optimize(iters=30)
    opt_s = time.perf_counter() - o0
    check(opt_ok, "submaps: optimize returned False (non-finite nodes)")
    post = sm.global_poses()
    lmg = sm.global_landmarks()
    check(np.isfinite(post).all() and np.isfinite(lmg).all()
          and lmg.shape[0] > 0, "submaps: global poses or landmarks not "
          "finite, or no landmark")
    truth = trc.truth[:Tc].double().cpu().numpy()

    def ate(est):
        Rg, tg = W.align_se2(est[:, :2], truth[:, :2])
        al = est[:, :2] @ Rg.T + tg
        return (float(np.sqrt(np.mean(np.sum((al - truth[:, :2]) ** 2, -1)))),
                float(np.sqrt(np.mean(np.sum((est[:, :2] - truth[:, :2]) ** 2,
                                             -1)))))
    ate_pre, ate_post = ate(got["pre"]), ate(post)
    gt = W.cluster_feet(W.true_feet(worldc), 0.5)
    acc = W.map_accuracy(lmg, gt, tol=0.6)
    acc_lines = W.map_accuracy_lines(W.cluster_feet(lmg, 0.5), worldc,
                                     tol=0.5)
    tick_ms = [r[0].elapsed_time(r[1]) for r in got["recs"]]
    bsync = got["boundary"]
    log(f"phase 12c submap pipeline ok: the campaign route's first {Tc} "
        f"ticks ((ticks, closures accepted): {tried}; the full route is "
        f"8,247) "
        f"in {n_seg} submaps of {L} ticks, capacity {epc.capacity} f32 dense"
        f" (P [{sm.submaps[0].carry.filt.P.shape[0]}²]), NH = 192, a "
        f"{rpc.table_capacity}-entry table, fused control, guard 0.5 m, "
        f"maintenance at 0.4 m; segment 0 bit-equal to a plain session over"
        f" its {L} ticks (poses, x, P); launches {got['launches']}; host "
        f"syncs: exactly one a tick (models/maintenance.py), and "
        f"{len(bsync)} outside the ticks ({len(bsync) / n_seg:.1f} a "
        f"segment boundary, at {sorted(set(bsync))[:6]}); {got['n_lc']} "
        f"loop closures accepted ({sm.graph.n_edges} edges, "
        f"{sm.graph.n_nodes} nodes), optimize True; aligned ATE "
        f"{ate_pre[0]:.4f} m before optimisation, {ate_post[0]:.4f} after "
        f"(world frame {ate_pre[1]:.4f}, {ate_post[1]:.4f}); "
        f"{lmg.shape[0]} global landmarks, map_accuracy against "
        f"cluster_feet(true_feet(world), 0.5) at 0.6 m {acc} (the submaps' "
        f"feet are taken from each submap's origin, so chip_r5_world.py "
        f"scores them against the wall lines: map_accuracy_lines {acc_lines}"
        f"); segment tick median {statistics.median(tick_ms):.3f} ms (CUDA "
        f"events around each step), run {got['run_s']:.3f} s, closure "
        f"detection {got['det_s']:.3f} s, optimize {opt_s:.4f} s (host f64); "
        f"card: {card}")
    launches12c = got["launches"]
    del got, sm, plain, pc, po
    torch.cuda.empty_cache()

    # -- 12d. concurrent submaps -------------------------------------------------
    # ParallelSubmapSlam(n_submaps=4) at 12c's filter and extractor (the
    # fleet takes no session options: odometry control, no maintenance)
    # on the route's first 128 ticks, against SubmapSlam in 32-tick
    # segments given the same draws a tick
    Tp = size["parallel_ticks"]
    gd = torch.Generator(device=dev)
    gd.manual_seed(12)
    draws = [(torch.rand((rpc.n_hypotheses, size["beams"]), generator=gd,
                         device=dev),
              torch.rand((rpc.n_hypotheses, size["beams"]), generator=gd,
                         device=dev)) for _ in range(Tp)]
    ps = ParallelSubmapSlam(ekf_params=epc, ransac_params=rpc, seed=1,
                            n_submaps=4, start_pose=startc, device=dev)
    zero()
    q0 = time.perf_counter()
    pp = ps.run(trc.odom[:Tp], trc.ranges[:Tp], trc.beam_angles, draws=draws)
    par_s = time.perf_counter() - q0
    launches12d = read()
    ser = SubmapSlam(ekf_params=epc, ransac_params=rpc, seed=1,
                     ticks_per_submap=Tp // 4, start_pose=startc,
                     device=dev)
    q0 = time.perf_counter()
    sp = ser.run(trc.odom[:Tp], trc.ranges[:Tp], trc.beam_angles,
                 draws=draws)
    ser_s = time.perf_counter() - q0
    check(launches12d == only(wall_search=Tp),
          f"concurrent submaps: launches {launches12d}")
    check(len(ps.submaps) == 4 and ps.graph.n_nodes == 5,
          f"concurrent submaps: {len(ps.submaps)} submaps, "
          f"{ps.graph.n_nodes} nodes")
    check(np.array_equal(pp, sp) and all(
        torch.equal(a.carry.filt.x, b.carry.filt.x)
        and torch.equal(a.carry.filt.P, b.carry.filt.P)
        for a, b in zip(ps.submaps, ser.submaps)),
          "concurrent submaps: a segment differs from SubmapSlam's")
    try:
        ps.run(trc.odom[:Tp - 1], trc.ranges[:Tp - 1], trc.beam_angles)
        ragged = "no error"
    except ValueError as e_:
        ragged = f"ValueError ({e_})"
    check(ragged.startswith("ValueError"), f"ragged T: {ragged}")
    log(f"phase 12d concurrent submaps ok: {Tp} ticks in 4 segments as one "
        f"fleet of 4 ({Tp // 4} fleet ticks), each segment's poses, x and P "
        f"bit-equal to SubmapSlam(ticks_per_submap={Tp // 4})'s given the "
        f"same draws; 4 submaps, 5 graph nodes; launches {launches12d}; "
        f"ragged T: {ragged}; wall {par_s:.3f} s concurrent, {ser_s:.3f} s "
        f"serial (host clock); card: {card}")
    del ps, ser, draws, trc
    torch.cuda.empty_cache()
    return dict(fleet=launches12a, submaps=launches12c, parallel=launches12d)


# phase 13's sizes: phase 6's configuration (tuned_params at capacity
# 10000) on the flagship run's first 160 ticks, checkpoints every 32 ticks,
# killed past tick 100; the stream at window 16, two windows in flight, a
# heartbeat every 2 windows, three timed runs with and three without;
# phase 5's square-root session (capacity 256, a 16-column noise buffer)
# for 80 ticks, checkpoints every 20, killed at tick 47
PHASE13 = dict(capacity=10000, beams=1024, ticks=160, every=32, die=100,
               window=16, pending=2, beat_every=2, runs=3, sr_capacity=256,
               sr_buffer=16, sr_ticks=80, sr_every=20, sr_die=47)

# the leaves that record the filter's decisions (which landmarks exist,
# which candidates were promoted), held equal where the floats are not
DECISION_LEAVES = ("filt.n_active", "filt.active", "table.observe",
                   "table.index", "table.fresh", "table.used")


def leaf_names(carry, prefix=""):
    """The dotted field names of a carry's leaves, in
    utils/checkpointing.carry_leaves's order."""
    out = []
    for name, v in zip(carry._fields, carry):
        if isinstance(v, tuple):
            out.extend(leaf_names(v, f"{prefix}{name}."))
        else:
            out.append(prefix + name)
    return out


def _crash_child(size, device, odom, ranges, beams, ckdir, conn):
    """Phase 13b's crash run, in a spawned process: phase 6's session
    checkpointed by run_with_checkpoints every ``size['every']`` ticks,
    each tick's number sent on ``conn`` once its step is enqueued, until
    the parent kills the process."""
    import torch
    sys.path.insert(0, HERE)
    import ekf_slam_tpu_torch as tp
    from ekf_slam_tpu_torch.utils import recovery as RC
    from ekf_slam_tpu_torch.utils.schedule import tuned_params
    ep, rp = slice_params(torch, size["capacity"])
    sess = tp.SlamSession(ekf_params=tuned_params(ep, batch=ep.max_obs),
                          ransac_params=rp, seed=1, device=device)
    step, done = sess.step, [0]

    def reporting(*a, **k):
        out = step(*a, **k)
        done[0] += 1
        conn.send(done[0])
        return out
    sess.step = reporting
    RC.run_with_checkpoints(sess, odom, ranges, beams, ckdir,
                            every=size["every"])
    conn.send(-1)


def recovery_phase(torch, tp, W, counted, dev, card, size):
    """Phase 13: checkpoints and crash recovery (utils/checkpointing.py,
    utils/recovery.py and the stream's heartbeat checkpoints) at full
    width, with every save, write and load timed on the host clock beside
    the size of its file (a save is the host copy of every leaf and the
    write).  Returns the kernels' launch counts for the JSON."""
    from ekf_slam_tpu_torch.utils import checkpointing as CK
    io_log = []
    plain_io = {n_: getattr(CK, n_) for n_ in
                ("save_checkpoint", "write_checkpoint", "load_checkpoint")}

    def timed(name):
        def inner(path, *a, **k):
            t0 = time.perf_counter()
            out = plain_io[name](path, *a, **k)
            where = out if name != "load_checkpoint" else path
            io_log.append((name, time.perf_counter() - t0, os.path.getsize(
                os.path.join(where, CK.CARRY_FILE))))
            return out
        return inner

    for n_ in plain_io:
        setattr(CK, n_, timed(n_))
    try:
        return _recovery_runs(torch, tp, W, counted, dev, card, size,
                              io_log)
    finally:
        for n_, fn in plain_io.items():
            setattr(CK, n_, fn)


def _recovery_runs(torch, tp, W, counted, dev, card, size, io_log):
    """Phase 13's runs; ``io_log`` collects (function, seconds, bytes) of
    every checkpoint save, write and load (recovery_phase)."""
    from ekf_slam_tpu_torch import session as session_mod
    from ekf_slam_tpu_torch.checks import session_inputs
    from ekf_slam_tpu_torch.io import stream as ST
    from ekf_slam_tpu_torch.utils import checkpointing as CK
    from ekf_slam_tpu_torch.utils import recovery as RC
    from ekf_slam_tpu_torch.utils.schedule import tuned_params

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counted.items()}

    def only(**want):
        return {k: want.get(k, 0) for k in counted}

    def io_summary(since):
        """The saves, writes and loads logged from index ``since``."""
        parts = []
        for name in ("save_checkpoint", "write_checkpoint",
                     "load_checkpoint"):
            rec = [r for r in io_log[since:] if r[0] == name]
            if rec:
                parts.append(
                    f"{len(rec)} {name.split('_')[0]}s of "
                    f"{sorted({r[2] for r in rec})} B, "
                    + ", ".join(f"{r[1]:.3f}" for r in rec) + " s")
        return "; ".join(parts)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 13 start: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated on the card after the earlier phases freed theirs")
    T, E, DIE = size["ticks"], size["every"], size["die"]
    WIN, BE = size["window"], size["beat_every"]
    cfg = tp.SimConfig(n_beams=size["beams"], max_range=12.0)
    gs = torch.Generator(device=dev)
    gs.manual_seed(0)
    traj = W.simulate(W.rectangle_room(4.0, 3.0, device=dev),
                      W.circle_controls(T, 0.05, 3.0, device=dev), cfg, gs)
    odom, ranges, beams = traj.odom, traj.ranges, traj.beam_angles
    odom_np, rng_np = odom.cpu().numpy(), ranges.cpu().numpy()
    ep, rp = slice_params(torch, size["capacity"])
    ep = tuned_params(ep, batch=ep.max_obs)

    def fresh():
        return tp.SlamSession(ekf_params=ep, ransac_params=rp, seed=1,
                              device=dev)

    # the crash runs checkpoint at the multiples of E up to DIE, the
    # resumes from the last of them at the later multiples and at T
    START = DIE // E * E
    crashed = list(range(E, START + 1, E))
    resumed = crashed + list(range(START + E, T, E)) + [T]
    ckpt_ticks = sorted(set(range(E, T + 1, E))
                        | set(range(WIN * BE, T + 1, WIN * BE)))

    # the uninterrupted run: its carry (device clones: the next tick
    # updates P in place) and generator state after each checkpoint tick
    ref = fresh()
    carry = ref.init_carry(first_odom=odom[0])
    at, outs = {}, []
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for t in range(T):
        carry, o = ref.step(carry, odom[t], ranges[t], beams)
        outs.append(o)
        if t + 1 in ckpt_ticks:
            at[t + 1] = ([v.clone() if isinstance(v, torch.Tensor) else v
                          for v in CK.carry_leaves(carry)],
                         ref.generator.get_state())
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - w0
    names = leaf_names(carry)
    ref_out = session_mod.stack_outputs(outs)
    ref_poses = ref_out.pose
    n_end = int(carry.filt.n_active.item())
    check(n_end > 0, "phase 13: no landmark mapped")
    Pd = carry.filt.P
    p_desc = (f"{str(Pd.dtype)[6:]} P [{Pd.shape[0]}²], "
              f"{Pd.numel() * Pd.element_size():,} B")
    del carry, outs, o, Pd
    log(f"phase 13 uninterrupted run: capacity {ep.capacity}, {p_desc}, "
        f"{T} ticks in {ref_s:.3f} s, n_active {n_end}; its carry kept on "
        f"the card after ticks {ckpt_ticks}; card: {card}")

    def differs(carry_, gen_state, tick):
        """The leaves (and 'generator') that differ from the
        uninterrupted run's after ``tick``."""
        leaves, want_gen = at[tick]
        bad = [nm for nm, a, b in zip(names, CK.carry_leaves(carry_), leaves)
               if not (a is b is None or (
                   isinstance(b, torch.Tensor) and a.dtype == b.dtype
                   and torch.equal(a, b)) or (
                   not isinstance(b, torch.Tensor) and a == b))]
        if gen_state is not None and not torch.equal(gen_state, want_gen):
            bad.append("generator")
        return bad

    def end_differs(final_, sess_, tail_, start_):
        bad = differs(final_, sess_.generator.get_state(), T)
        if not torch.equal(tail_, ref_poses[start_:]):
            bad.append("poses")
        return bad

    bit = {"equal": True}

    def hold(what, bad):
        """Bit-equality; after 13a's fallback, every decision."""
        if bit["equal"]:
            check(not bad, f"{what}: differs from the uninterrupted run in "
                  f"{bad}")
        else:
            dec = [b_ for b_ in bad if b_ in DECISION_LEAVES]
            check(not dec, f"{what}: a decision differs: {dec}")

    def crash(fn, ck, *a, **k):
        try:
            fn(*a, **k)
        except RC.HostCrash:
            return sorted(os.listdir(ck))
        check(False, f"{fn.__name__} did not crash at {k.get('die_at_tick')}")

    def steps(*ticks):
        return [f"step_{k:08d}" for k in ticks]

    def resume_fresh(fn, ck, what):
        """A fresh session resumes the newest checkpoint under ``ck`` with
        ``fn`` (resume_latest or resume_latest_ticks), the counters set to
        0 just before: its first tick, its checkpoints and its launches
        (one K1 and one wall_search a tick) checked.  Returns what differs
        from the uninterrupted run, the launches and the resume's
        seconds."""
        sess = fresh()
        zero()
        w0 = time.perf_counter()
        final, tail, start = fn(sess, odom, ranges, beams, ck, every=E)
        torch.cuda.synchronize()
        secs = time.perf_counter() - w0
        got = read()
        done = [d for d in sorted(os.listdir(ck)) if d.startswith("step_")]
        check(start == START and done == steps(*resumed),
              f"{what}: resumed from {start}, checkpoints {done}")
        check(got == only(syrk_downdate=T - START, wall_search=T - START),
              f"{what}: launches in the resume {got}, expected one K1 and "
              f"one wall_search a tick")
        return end_differs(final, sess, tail, start), got, secs

    def outcome(bad):
        return ("bit-equal to the uninterrupted run (every leaf of the "
                "carry, the generator's state, the poses)" if not bad else
                f"every decision equal to the uninterrupted run's (differs "
                f"in {bad})")

    # -- 13a. kill and resume in one process ----------------------------------
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "13a")
        i0 = len(io_log)
        got = crash(RC.run_with_checkpoints, ck, fresh(), odom, ranges, beams,
                    ck, every=E, die_at_tick=DIE)
        check(got == steps(*crashed), f"13a checkpoints {got}")
        bad13a, launches13a, res_s = resume_fresh(RC.resume_latest, ck,
                                                  "13a")
        io13a = io_summary(i0)
    if bad13a:
        # not bit-equal: both runs again under PyTorch's deterministic
        # algorithms (warnings name the ops that have none), whose
        # decisions must be equal
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught_d, \
                tempfile.TemporaryDirectory() as td:
            warnings.simplefilter("always")
            want_d, _ = fresh().run(odom, ranges, beams)
            ck = os.path.join(td, "13a-det")
            crash(RC.run_with_checkpoints, ck, fresh(), odom, ranges, beams,
                  ck, every=E, die_at_tick=DIE)
            got_d, _, _ = RC.resume_latest(fresh(), odom, ranges, beams, ck,
                                           every=E)
        torch.use_deterministic_algorithms(False)
        nondet = sorted({str(w_.message).split(".")[0][:160]
                         for w_ in caught_d
                         if "determinis" in str(w_.message)})
        bad_d = [nm for nm, a, b in zip(names, CK.carry_leaves(got_d),
                                        CK.carry_leaves(want_d))
                 if isinstance(b, torch.Tensor) and not torch.equal(a, b)]
        log(f"phase 13a: the resume differs from the uninterrupted run in "
            f"{bad13a}; under torch.use_deterministic_algorithms in "
            f"{bad_d}; ops without a deterministic version: {nondet}")
        bit["equal"] = False
        check(not [b_ for b_ in bad_d if b_ in DECISION_LEAVES],
              f"13a deterministic rerun: a decision differs: {bad_d}")
        del want_d, got_d
    hold("13a", bad13a)
    log(f"phase 13a kill and resume ok: run_with_checkpoints(every={E}) "
        f"killed at tick {DIE} (checkpoints {steps(*crashed)}), "
        f"resume_latest in a fresh SlamSession from tick {START}: "
        f"{outcome(bad13a)}; launches in the resume {launches13a} (one K1 "
        f"and one wall_search a tick); resume {res_s:.3f} s for {T - START}"
        f" ticks and {len(resumed) - len(crashed)} saves; checkpoints: "
        f"{io13a}; card: {card}")
    torch.cuda.empty_cache()

    # -- 13b. a real kill ---------------------------------------------------
    # the crash run in a spawned process (the CUDA context must not be
    # forked), reporting each tick on a pipe; SIGKILL once it has passed
    # tick DIE; then the resume here
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "13b")
        rx, tx = ctx.Pipe(duplex=False)
        child = ctx.Process(target=_crash_child, args=(
            size, str(dev), odom_np, rng_np, beams.cpu().numpy(), ck, tx),
            daemon=True)
        w0 = time.perf_counter()
        child.start()
        tx.close()
        passed = 0
        try:
            while passed <= DIE:
                check(rx.poll(300), "13b: the crash run reported no tick "
                      "for 300 s")
                passed = rx.recv()
                check(passed != -1, "13b: the crash run ended unkilled")
            child.kill()
            child.join(60)
        finally:
            if child.is_alive():
                child.kill()
                child.join(10)
        kill_s = time.perf_counter() - w0
        check(child.exitcode == -9, f"13b: child exit code {child.exitcode}")
        left = sorted(os.listdir(ck))
        latest = CK.latest_step_dir(ck)
        check(latest is not None and os.path.basename(latest)
              == steps(START)[0], f"13b: newest checkpoint {latest} "
              f"(directory {left})")
        bad13b, launches13b, _ = resume_fresh(RC.resume_latest, ck, "13b")
    hold("13b", bad13b)
    log(f"phase 13b real kill ok: the crash run in a spawned process sent "
        f"SIGKILL once it had enqueued tick {passed} ({kill_s:.3f} s from "
        f"the spawn, its CUDA start-up included); its directory held {left};"
        f" latest_step_dir named {steps(START)[0]}; resume_latest in a fresh "
        f"session from tick {START}: {outcome(bad13b)}; launches "
        f"{launches13b}; card: {card}")
    torch.cuda.empty_cache()

    # -- 13c. the tick-by-tick driver, then the stream's heartbeats ---------
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "13c")
        i0 = len(io_log)
        got = crash(RC.drive_ticks, ck, fresh(), odom, ranges, beams, ck,
                    every=E, die_at_tick=DIE)
        check(got == steps(*crashed), f"13c checkpoints {got}")
        bad13c, launches13c, _ = resume_fresh(RC.resume_latest_ticks, ck,
                                              "13c")
        io13c = io_summary(i0)
    hold("13c drive_ticks", bad13c)
    log(f"phase 13c drive_ticks ok: killed before the step of tick {DIE}, "
        f"resume_latest_ticks from {START}: {outcome(bad13c)}; launches "
        f"{launches13c}; checkpoints: {io13c}; card: {card}")
    torch.cuda.empty_cache()

    stream_file = os.path.relpath(ST.__file__, HERE)
    with open(ST.__file__) as f_:
        wait_lines = {f"{stream_file}:{i + 1}" for i, line in enumerate(f_)
                      if "event.synchronize()" in line}
    check(len(wait_lines) == 1, f"stream.py's event waits: {wait_lines}")
    ck_file = os.path.relpath(CK.__file__, HERE)

    def stream13(ckdir, ticks=T, start=None, flush=True):
        """A fresh session's stream pushed host arrays a tick at a time
        (from the checkpoint ``start`` where given), heartbeats under
        ``ckdir`` (None: none); PyTorch's sync debug mode over the run.
        Returns the stream, its outputs, its first tick and the syncs
        outside the event wait and the heartbeat's write."""
        st_ = ST.StreamingSlamSession(fresh(), n_beams=size["beams"],
                                      beam_angles=beams, window=WIN,
                                      max_pending=size["pending"],
                                      checkpoint_dir=ckdir,
                                      checkpoint_every=BE,
                                      first_odom=odom_np[0])
        t0_ = 0
        if start is not None:
            st_.restore(start)
            t0_ = CK.step_of(start)
        torch.cuda.synchronize()
        got_ = []
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught_:
            warnings.simplefilter("always")
            for t_ in range(t0_, ticks):
                got_.extend(st_.push(odom_np[t_], rng_np[t_]))
            if flush:
                got_.extend(st_.flush())
        torch.cuda.set_sync_debug_mode(0)
        syncs_ = [f"{os.path.relpath(w_.filename, HERE)}:{w_.lineno}"
                  for w_ in caught_ if "synchroniz" in str(w_.message)]
        outside_ = [s_ for s_ in syncs_ if s_ not in wait_lines
                    and not s_.startswith(ck_file + ":")]
        return st_, got_, t0_, outside_

    def stream_differs(got_, t0_):
        """Ticks whose pose or n_active differ from the uninterrupted
        run's."""
        a_ = np.stack([o_.pose for o_ in got_])
        n_ = np.stack([o_.n_active for o_ in got_])
        want_p = ref_poses[t0_:t0_ + len(got_)].cpu().numpy()
        want_n = ref_out.n_active[t0_:t0_ + len(got_)].cpu().numpy()
        return sorted(set(np.nonzero((a_ != want_p).any(axis=1))[0].tolist())
                      | set(np.nonzero(n_ != want_n)[0].tolist()))

    beat_ticks = list(range(WIN * BE, T + 1, WIN * BE))
    sums = {True: [], False: []}
    tmpl_sess = fresh()
    for k_, beats in enumerate((True, False, False, True, True, False)):
        with tempfile.TemporaryDirectory() as td:
            ck = os.path.join(td, "hb") if beats else None
            i0 = len(io_log)
            st_, got_, _, outside_ = stream13(ck)
            check(not outside_, f"13c stream (heartbeats {beats}): host "
                  f"syncs outside the event wait and the heartbeat's write "
                  f"at {sorted(set(outside_))}")
            bad_ = stream_differs(got_, 0)
            check(len(got_) == T and (not bad_ or not bit["equal"]),
                  f"13c stream (heartbeats {beats}): ticks {bad_[:8]} "
                  f"differ from the uninterrupted run")
            sums[beats].append(st_.stats.summary())
            if beats and k_ == 0:
                # every heartbeat against the uninterrupted run's carry
                # after exactly the ticks of its label
                got = sorted(os.listdir(ck))
                check(got == steps(*beat_ticks), f"13c heartbeats {got}")
                io_hb = io_summary(i0)
                n_bufs = len(st_._free_bufs)
                for k in beat_ticks:
                    hb = CK.load_checkpoint(
                        os.path.join(ck, f"step_{k:08d}"),
                        tmpl_sess.init_carry(first_odom=odom[0]),
                        generator=tmpl_sess.generator)
                    hold(f"13c heartbeat step_{k:08d}", differs(
                        hb, tmpl_sess.generator.get_state(), k))
                    del hb
            del st_, got_
            torch.cuda.empty_cache()
    keys = ("ticks_per_sec", "latency_p50_ms", "latency_p99_ms",
            "latency_mean_ms")
    med = {b_: {k: statistics.median(s_[k] for s_ in v) for k in keys}
           for b_, v in sums.items()}
    spread = {b_: {k: 100 * (max(s_[k] for s_ in v) - min(s_[k] for s_ in v))
                   / med[b_][k] for k in keys} for b_, v in sums.items()}
    log(f"phase 13c stream heartbeats ok: window {WIN}, max_pending "
        f"{size['pending']}, checkpoint_every {BE}: heartbeats "
        f"{steps(*beat_ticks)}, each bit-equal to the uninterrupted run's "
        f"carry and generator after exactly its labelled tick; "
        f"{n_bufs} host buffer sets (pinned, allocated once); no host sync "
        f"outside the event wait and the heartbeat's write; heartbeat "
        f"writes: {io_hb}; card: {card}")
    for b_ in (True, False):
        m_ = med[b_]
        log(f"phase 13c stream {'with' if b_ else 'without'} heartbeats: "
            f"{m_['ticks_per_sec']:.3f} ticks/s, latency p50 "
            f"{m_['latency_p50_ms']:.3f} ms, p99 {m_['latency_p99_ms']:.3f} "
            f"ms, mean {m_['latency_mean_ms']:.3f} ms (medians of "
            f"{len(sums[b_])} runs of {T} ticks in turns with the other, "
            f"StreamStats.summary(); spreads "
            + ", ".join(f"{k} {spread[b_][k]:.1f}%" for k in keys)
            + "; runs " + "; ".join(
                f"{s_['ticks_per_sec']:.3f}/s p99 {s_['latency_p99_ms']:.3f}"
                for s_ in sums[b_]) + f"); card: {card}")

    # a stream abandoned after DIE ticks, and a fresh stream restored from
    # its newest heartbeat before its first push
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "hb")
        dead, _, _, _ = stream13(ck, ticks=DIE, flush=False)
        del dead
        latest = CK.latest_step_dir(ck)
        check(latest is not None, "13c: the abandoned stream wrote no "
              "heartbeat")
        st_, got_, t0_, outside_ = stream13(ck, start=latest)
        check(t0_ in beat_ticks and t0_ <= DIE and len(got_) == T - t0_,
              f"13c restored stream: from {t0_}, {len(got_)} ticks")
        check(not outside_, f"13c restored stream: host syncs at "
              f"{sorted(set(outside_))}")
        bad_r = (["poses"] if stream_differs(got_, t0_) else []) + differs(
            st_.carry, st_.session.generator.get_state(), T)
        hold("13c restored stream", bad_r)
        left = sorted(os.listdir(ck))
        del st_, got_
    log(f"phase 13c stream restore ok: a stream abandoned after {DIE} "
        f"ticks left {left[:left.index(os.path.basename(latest)) + 1]}; a "
        f"fresh stream restored {os.path.basename(latest)} before its first "
        f"push and ran ticks {t0_}-{T - 1}, its outputs and final carry "
        f"{outcome(bad_r)}; card: {card}")
    del at, ref_out, ref_poses, tmpl_sess
    torch.cuda.empty_cache()

    # -- 13d. the square-root path across a recompression -------------------
    TS, ES, DS = size["sr_ticks"], size["sr_every"], size["sr_die"]
    ep_sr, rp_sr = slice_params(torch, size["sr_capacity"],
                                update_mode="srekf_fast",
                                rows_gather="pallas",
                                sr_noise_buffer=size["sr_buffer"])
    od_sr, rg_sr, bm_sr, _ = session_inputs(rp_sr, TS, size["beams"])
    od_sr, rg_sr, bm_sr = od_sr.to(dev), rg_sr.to(dev), bm_sr.to(dev)

    def fresh_sr():
        return tp.SlamSession(ekf_params=ep_sr, ransac_params=rp_sr, seed=1,
                              device=dev)
    start_sr = DS // ES * ES
    want_rec = list(range(start_sr + size["sr_buffer"]
                          - start_sr % size["sr_buffer"], TS + 1,
                          size["sr_buffer"]))
    ref_sr = fresh_sr()
    want_sr, out_sr = ref_sr.run(od_sr, rg_sr, bm_sr)
    rec_at = []
    plain_rec = session_mod.sr_recompress

    def recorded(filt):
        # the tick that recompresses: one K5 launch a tick of the resume
        rec_at.append(start_sr + read()["pair_gather"])
        return plain_rec(filt)
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "13d")
        got = crash(RC.run_with_checkpoints, ck, fresh_sr(), od_sr, rg_sr,
                    bm_sr, ck, every=ES, die_at_tick=DS)
        check(got == steps(*range(ES, start_sr + 1, ES)),
              f"13d checkpoints {got}")
        sess = fresh_sr()
        snap = CK.load_checkpoint(CK.latest_step_dir(ck),
                                  sess.init_carry(first_odom=od_sr[0]))
        check(snap.sr_tick == start_sr and type(snap.sr_tick) is int,
              f"13d: the newest checkpoint holds sr_tick {snap.sr_tick!r}")
        del snap
        zero()
        session_mod.sr_recompress = recorded
        try:
            final, tail, start = RC.resume_latest(sess, od_sr, rg_sr, bm_sr,
                                                  ck, every=ES)
        finally:
            session_mod.sr_recompress = plain_rec
        torch.cuda.synchronize()
        launches13d = read()
    check(start == start_sr and rec_at == want_rec and final.sr_tick == TS,
          f"13d: resumed from {start}, recompressed after ticks {rec_at}")
    check(launches13d == only(pair_gather=TS - start, wall_search=TS - start,
                              syrk_gram=len(want_rec)),
          f"13d resume launches {launches13d}")
    bad = [nm for nm, a, b in zip(leaf_names(final),
                                  CK.carry_leaves(final),
                                  CK.carry_leaves(want_sr))
           if isinstance(b, torch.Tensor) and not torch.equal(a, b)]
    if not torch.equal(sess.generator.get_state(),
                       ref_sr.generator.get_state()):
        bad.append("generator")
    if not torch.equal(tail, out_sr.pose[start:]):
        bad.append("poses")
    hold("13d", bad)
    log(f"phase 13d square-root resume ok: srekf_fast, capacity "
        f"{ep_sr.capacity}, S [{final.filt.P.shape[0]}²] f32, a "
        f"{size['sr_buffer']}-column noise buffer; run_with_checkpoints("
        f"every={ES}) killed at tick {DS}, resumed from {start} with sr_tick "
        f"{start} (a host int), recompressing after ticks {rec_at}; "
        f"{outcome(bad)}; launches in the resume {launches13d} "
        f"({TS - start} K5 and "
        f"{len(want_rec)} K6); card: {card}")
    del final, tail, sess, want_sr, out_sr, ref_sr
    torch.cuda.empty_cache()
    return dict(recovery=launches13a, sr=launches13d)


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
    from ekf_slam_tpu_torch.models import srekf_fast as srekf_fast_mod
    from ekf_slam_tpu_torch.checks import (CAMPAIGN_SESSION,
                                           bearing_gap_ulps, bench_batch,
                                           bench_params, bf16_ulps,
                                           campaign_params, campaign_route,
                                           decisions_differ, evict_case,
                                           full_f32_matmul,
                                           full_measurements, full_state,
                                           gate_case, gate_tolerance,
                                           gram_banded_case, gram_compare,
                                           gram_dense_case,
                                           gram_plain_errors,
                                           pair_starts, recompress_qr_case,
                                           record_syrk, score_lines_case,
                                           sequential_chain,
                                           sequential_params,
                                           session_inputs,
                                           session_on_devices, syrk_case,
                                           syrk_compare, syrk_gap_bound,
                                           tf32_single_pass,
                                           wall_search_case,
                                           wall_search_compare)
    from ekf_slam_tpu_torch.ops.ransac import wall_search_ref
    from ekf_slam_tpu_torch.ops.angles import _DEG2RAD, atan2d
    from ekf_slam_tpu_torch.ops.blocked_chol import chol_for_state
    from ekf_slam_tpu_torch.ops.icp import icp
    from ekf_slam_tpu_torch.ops.scan import scan_from_ranges, to_cartesian
    from ekf_slam_tpu_torch.models import maintenance as MT
    from ekf_slam_tpu_torch.state import FilterState
    from ekf_slam_tpu_torch.utils.faults import corrupt_odometry, guarded
    from ekf_slam_tpu_torch.utils.metrics import MetricsLogger, filter_health
    from ekf_slam_tpu_torch.io import scanlog as SL
    from ekf_slam_tpu_torch.io import socket_feed as SF
    from ekf_slam_tpu_torch.io import stream as ST
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
    # every kernel's launch counter, set to 0 before a path's run
    counted = {"syrk_downdate": K.syrk_downdate,
               "gate_costs": G.gate_costs_state,
               "score_lines": K.score_lines, "wall_search": K.wall_search,
               "cov_update": K.cov_update, "pair_gather": K.pair_gather,
               "syrk_gram": K.syrk_gram}
    if "--phase12-only" in sys.argv[1:]:
        # a development run of phase 12 alone: no result line
        fleet_and_submaps(torch, tp, W, counted, dev, card, None, PHASE12)
        log("chip_smoke: phase 12 only (--phase12-only): no result line")
        return 0
    if "--phase13-only" in sys.argv[1:]:
        # a development run of phase 13 alone: no result line
        recovery_phase(torch, tp, W, counted, dev, card, PHASE13)
        log("chip_smoke: phase 13 only (--phase13-only): no result line")
        return 0
    mma = sass_mma_counts(K.library_path("syrk_downdate"))
    mma_bf16 = {k: v for k, v in mma.items()
                if "syrk_downdate_kernel_bf16" in k}
    check(len(mma_bf16) == 2 and min(mma_bf16.values()) > 0,
          f"K1's bf16 kernel has no HMMA/HGMMA instruction: {mma}")
    log(f"phase 1 K1 SASS ok: tensor-core instructions (HMMA/HGMMA) per "
        f"kernel {mma}")
    mma6 = sass_mma_counts(K.library_path("syrk_gram"))
    mma_tf32 = {k: v for k, v in mma6.items() if "syrk_gram_kernel_tf32" in k}
    check(len(mma_tf32) == 1 and min(mma_tf32.values()) > 0,
          f"K6's f32 kernel has no HMMA/HGMMA instruction: {mma6}")
    ptx6 = ptxas_report(K.build_log("syrk_gram"))
    ptx_tf32 = [v for k, v in ptx6.items() if "syrk_gram_kernel_tf32" in k]
    check(len(ptx6) == 3 and len(ptx_tf32) == 1
          and ptx_tf32[0]["registers"] is not None,
          f"K6's -Xptxas -v report lacks its kernels: "
          f"{K.build_log('syrk_gram')}")
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0
              for v in ptx6.values()), f"K6 spills registers: {ptx6}")
    log(f"phase 1 K6 SASS ok: HMMA/HGMMA per kernel {mma6}; -Xptxas -v "
        f"(the f32 kernel's 110,592-byte ring is dynamic shared memory, "
        f"not in the report): {ptx6}")

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
    # K6: f32 (3xTF32 on the tensor cores) at the edge shapes of its tiles
    # and slabs, from numpy, and at the existing shapes; bf16 and f64
    edge6 = [(D, R) for D in (1, 127, 128, 129) for R in (1, 3, 31, 33)]
    notes6 = []
    for D6, R6, dt6 in ([(D, R, torch.float32) for D, R in edge6]
                        + [(20067, 20067, torch.float32),
                           (1003, 1500, torch.float32),
                           (517, 517, torch.bfloat16),
                           (517, 517, torch.float64)]):
        wide = dt6 == torch.float64
        edge = (D6, R6) in edge6
        if edge:
            S6 = gram_dense_case(D6, R6).to(dev)
        else:
            S6 = torch.randn((D6, R6), generator=g, device=dev,
                             dtype=torch.float64 if wide else torch.float32
                             ).to(dt6)
        # the plain version on the CPU, whose f32 sums are accurate: at
        # D = R = 20067 the card's (cuBLAS) is itself ~1e-5 of |G|max off
        # the f64 Gram, so against it the gap would be cuBLAS's error
        ref = K.syrk_gram_ref(S6.cpu())
        got = K.syrk_gram(S6, use_pallas=True)
        torch.cuda.synchronize()
        check(got.dtype == ref.dtype == (torch.float64 if wide
                                         else torch.float32),
              f"K6 {dt6} gave {got.dtype}, plain {ref.dtype}")
        rel = ((got.cpu() - ref).abs().max() / ref.abs().max()).item()
        del ref
        ref_card = K.syrk_gram_ref(S6)
        rel_card = ((got - ref_card).abs().max()
                    / ref_card.abs().max()).item()
        del ref_card
        tol = 1e-12 if wide else 1e-5
        label = f"K6 D={D6} R={R6} {str(dt6)[6:]}"
        check(rel <= tol, f"{label} relative error {rel} > {tol} against "
              f"the plain version on the CPU (on the card {rel_card})")
        check(torch.equal(got, got.T), f"{label} not bit-symmetric")
        line = (f"relative error {rel:.3e} of |G|max against the plain "
                f"version on the CPU ({rel_card:.3e} against it on the "
                f"card), bit-symmetric, {str(got.dtype)[6:]} out")
        if dt6 == torch.float32:
            plain6 = gram_plain_errors(S6)
            res = gram_compare(got, S6, plain6)
            del got
            ctrl = gram_compare(tf32_single_pass(S6), S6, plain6)
            check(res["ok"], f"{label} gram_compare: e {res['err']:.3e} > "
                  f"limit {res['limit']:.3e} (plain f32 Grams' e {plain6})")
            check(not (edge and ctrl["ok"]),
                  f"{label}: the single-TF32-pass control passed "
                  f"gram_compare (e {ctrl['err']:.3e}, limit "
                  f"{ctrl['limit']:.3e})")
            line += (f"; gram_compare e {res['err']:.3e} (limit "
                     f"{res['limit']:.3e}; plain f32 Grams' e "
                     + ", ".join(f"{k} {v:.3e}" for k, v in plain6.items())
                     + f"; the one-TF32-pass control {ctrl['err']:.3e}, "
                     f"{'fails' if not ctrl['ok'] else 'passes'})")
            if (D6, R6) == (20067, 20067):
                check(res["err"] <= 2 * plain6["card"],
                      f"{label}: e {res['err']:.3e} > 2 × the card's "
                      f"torch.matmul e {plain6['card']:.3e}")
                line += (f"; dense criterion: e ≤ 2 × the card's "
                         f"torch.matmul e {plain6['card']:.3e} "
                         f"(allow_tf32 False)")
        else:
            del got
        if edge:
            notes6.append(f"({D6},{R6}) e {res['err']:.2e}/limit "
                          f"{res['limit']:.2e}, control {ctrl['err']:.2e}")
        else:
            log(f"phase 4 {label} ok: {line}")
        del S6
    log(f"phase 4 K6 edge shapes f32 ok: each within 1e-5 of |G|max of "
        f"the plain version, bit-symmetric, through gram_compare, the "
        f"single-TF32-pass control failing it at every one: "
        + "; ".join(notes6))
    # a banded S at the full shape: every tile pair runs, no sum has more
    # than 256 nonzero terms, so the f32 Grams' accumulation error is
    # small and one TF32 pass must show
    Sb = gram_banded_case(g, 20067)
    Gb = K.syrk_gram(Sb, use_pallas=True)
    torch.cuda.synchronize()
    check(torch.equal(Gb, Gb.T), "K6 banded: not bit-symmetric")
    plain_b = gram_plain_errors(Sb)
    res_b = gram_compare(Gb, Sb, plain_b)
    del Gb
    ctrl_b = gram_compare(tf32_single_pass(Sb), Sb, plain_b)
    check(res_b["ok"], f"K6 banded: e {res_b['err']:.3e} > limit "
          f"{res_b['limit']:.3e} (plain f32 Grams' e {plain_b})")
    check(not ctrl_b["ok"], f"K6 banded: the single-TF32-pass control "
          f"passed (e {ctrl_b['err']:.3e}, limit {ctrl_b['limit']:.3e})")
    log(f"phase 4 K6 banded D=R=20067 f32 (≤ 256 nonzero terms a sum) ok: "
        f"bit-symmetric, gram_compare e {res_b['err']:.3e} (limit "
        f"{res_b['limit']:.3e}; plain f32 Grams' e "
        + ", ".join(f"{k} {v:.3e}" for k, v in plain_b.items())
        + f"); the one-TF32-pass control e {ctrl_b['err']:.3e} fails")
    del Sb
    torch.cuda.empty_cache()

    # -- 5. the session, card against CPU ---------------------------------------
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
        if path == "srekf_fast":        # one K6 launch a recompression
            want4["syrk_gram"] = T4 // ep4.sr_noise_buffer
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
            f"buffer {ep4.sr_noise_buffer}, card launches {got4}, "
            f"n_active equal (final "
            f"{int(na_h[-1])}), max position diff {dpos:.3e} m, heading "
            f"{dhead:.3e} rad ({math.degrees(dhead):.3e} deg, tick {worst}); "
            f"the CPU's f32 run against its f64 run: {fpos:.3e} m, "
            f"{fhead:.3e} rad ({math.degrees(fhead):.3e} deg, tick "
            f"{fworst})")
    # the sequential filter (the JAX package's default session: the
    # algorithm's preset as constructed, capacity 128, ref_compat=True,
    # and the one-seed wall search at tests/test_sim_session.py:29-32's
    # settings in f32) and the QR square-root filter: no kernel on their
    # paths but the QR session's wall_search.  Positions are held in
    # metres and headings in radians, as on the square-root path, beside
    # the CPU's own f32-against-f64 gap
    seq_rp = tp.RansacParams(line_consensus=60, bearing_window_deg=15.0,
                             wall_search_timeout=4, table_capacity=32,
                             promote_count=5, ref_compat=False)
    T5 = 32
    for path, ep5, rp5 in (
            ("sequential EKF_SLAM_UC", tp.ALGORITHMS["EKF_SLAM_UC"](),
             seq_rp),
            ("sequential EKF_SLAM", tp.ALGORITHMS["EKF_SLAM"](), seq_rp),
            ("srekf", tp.EKFParams(capacity=64, max_obs=8, ref_compat=False,
                                   update_mode="srekf"),
             slice_params(torch, 64)[1])):
        for fn in counted.values():
            fn.launches = 0
        outs5 = session_on_devices(ep5, rp5, T5, 1024, ("cuda", "cpu"))
        got5 = {k: fn.launches for k, fn in counted.items()}
        want5 = {k: T5 if (k == "wall_search" and rp5.n_hypotheses) else 0
                 for k in got5}
        check(got5 == want5, f"{path} session on the card launched {got5}, "
              f"expected {want5}")
        na_c, na_h = outs5["cuda"].n_active.cpu(), outs5["cpu"].n_active
        check(torch.equal(na_c, na_h),
              f"{path} session n_active differs: card {na_c.tolist()} "
              f"cpu {na_h.tolist()}")
        check(int(na_h[-1]) > 0, f"{path} session mapped no landmark")
        pose_64 = session_on_devices(
            *(dataclasses.replace(p_, dtype=torch.float64)
              for p_ in (ep5, rp5)), T5, 1024, ("cpu",))["cpu"].pose
        dpos, dhead, worst = pose_gaps(outs5["cuda"].pose.cpu(),
                                       outs5["cpu"].pose)
        fpos, fhead, fworst = pose_gaps(outs5["cpu"].pose, pose_64)
        check(dpos <= 1e-3 and dhead <= 1e-3,
              f"{path} session card/CPU pose differ by {dpos} m, {dhead} "
              f"rad (worst tick {worst}); the CPU's f32 run differs from "
              f"its f64 run by {fpos} m, {fhead} rad")
        log(f"phase 5 {path} session card vs CPU ok: {T5} ticks, capacity "
            f"{ep5.capacity}, ref_compat {ep5.ref_compat}, "
            f"n_hypotheses {rp5.n_hypotheses}, card launches "
            f"{ {k: v for k, v in got5.items() if v} }, n_active equal "
            f"(final {int(na_h[-1])}), max position diff {dpos:.3e} m, "
            f"heading {dhead:.3e} rad (tick {worst}); the CPU's f32 run "
            f"against its f64 run: {fpos:.3e} m, {fhead:.3e} rad")
    del outs5, pose_64

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

    # the control and robustness modes, card against CPU (capacity 256, f32,
    # 32 ticks, the same draws): ICP and fused control with the campaign's
    # ICP settings (the fused run with scans 12-16 blanked, so both choices
    # occur), the guard (3 cm) with the odometry of ticks 10 and 20 moved
    # 0.71 m by corrupt_odometry (injected once on the CPU, handed to both),
    # and maintenance (merge radius 4.9 m, trace cap 3.0) on the tuned path
    # and on srekf_fast; each run's decisions tick by tick must be equal
    ICP_KW = {k: v for k, v in CAMPAIGN_SESSION.items()
              if k.startswith("icp")}
    MAINT_KW = dict(maintain_merge_radius=4.9, maintain_max_trace=3.0)
    T5R = 32

    def blanked(traj_):
        r = traj_.ranges.clone()
        r[12:17] = float("nan")
        return traj_.odom, r

    def corrupted(traj_):
        hit = torch.zeros(T5R, dtype=torch.bool)
        hit[[10, 20]] = True
        noise = torch.zeros(T5R, 3)
        noise[10] = torch.tensor([0.5, -0.5, 0.0])
        noise[20] = torch.tensor([-0.5, 0.5, 0.0])
        return corrupt_odometry(traj_.odom, None, 0.0, magnitude=1.0,
                                hit=hit, noise=noise), traj_.ranges
    TUNED5 = dict(pht_mode="rows", correction="syrk")
    for name, kw, ekw, skw, edit in (
            ("icp", TUNED5, {}, dict(control_source="icp", **ICP_KW), None),
            ("fused", TUNED5, {}, dict(control_source="fused", **ICP_KW),
             blanked),
            ("guard", TUNED5, dict(guard_max_jump=0.03), {}, corrupted),
            ("maintenance tuned", TUNED5, {}, MAINT_KW, None),
            ("maintenance srekf_fast", dict(SR_PATH, sr_noise_buffer=16), {},
             MAINT_KW, None)):
        ep5r, rp5r = slice_params(torch, 256, **kw)
        ep5r = dataclasses.replace(ep5r, **ekw)
        for fn in counted.values():
            fn.launches = 0
        outs5r = session_on_devices(ep5r, rp5r, T5R, 1024, ("cuda", "cpu"),
                                    session_kw=skw, edit=edit)
        got5r = {k: fn.launches for k, fn in counted.items()}
        oc, oh = outs5r["cuda"], outs5r["cpu"]
        sr5 = ep5r.update_mode == "srekf_fast"
        want5r = {k: 0 for k in got5r}
        want5r["wall_search"] = T5R
        want5r["pair_gather" if sr5 else "syrk_downdate"] = T5R
        if sr5:     # the schedule's recompressions and each eviction's
            want5r["syrk_gram"] = (T5R // ep5r.sr_noise_buffer
                                   + int((oc.n_evicted > 0).sum()))
        check(got5r == want5r, f"{name} on the card launched {got5r}, "
              f"expected {want5r}")
        na_c, na_h = oc.n_active.cpu(), oh.n_active
        check(torch.equal(na_c, na_h), f"{name}: n_active differs: card "
              f"{na_c.tolist()} cpu {na_h.tolist()}")
        differ = decisions_differ(oc, oh)
        check(not any(differ.values()), f"{name}: the card and the CPU "
              f"decided differently at ticks {differ}")
        dpos, dhead, worst = pose_gaps(oc.pose.cpu(), oh.pose)
        check(dpos <= 1e-3 and dhead <= 1e-3, f"{name}: card/CPU pose "
              f"differ by {dpos} m, {dhead} rad (tick {worst})")
        if name == "icp":
            check(not oh.u[0].any() and not oc.u[0].any(),
                  "icp: the first tick's control is not 0")
            what = "first tick's u 0 on both"
        elif name == "fused":
            took = oh.icp_ok
            check(bool(took.any()) and not bool(took.all())
                  and not bool(took[12:18].any()),
                  f"fused: ICP taken on {took.int().tolist()}")
            what = (f"ICP taken on {int(took.sum())} of {T5R} ticks, the "
                    f"odometry on ticks "
                    f"{torch.nonzero(~took).flatten().tolist()}")
        elif name == "guard":
            rej = torch.nonzero(~oh.guard_ok).flatten().tolist()
            check(len(rej) > 0, "guard: no tick rejected")
            what = f"ticks rejected on both: {rej}"
        else:
            ev = oh.n_evicted
            check(bool((ev > 0).any()), f"{name}: nothing evicted")
            what = (f"{int(ev.sum())} landmarks evicted in "
                    f"{int((ev > 0).sum())} ticks, the same each tick")
        log(f"phase 5 {name} card vs CPU ok: {T5R} ticks, capacity 256, "
            f"{what}; decisions equal every tick, n_active equal (final "
            f"{int(na_h[-1])}), max position diff {dpos:.3e} m, heading "
            f"{dhead:.3e} rad (tick {worst}); card launches "
            f"{ {k: v for k, v in got5r.items() if v} }")
    del outs5r, oc, oh

    # sync census of maintenance, tick by tick, on the card, on the tuned
    # path and on srekf_fast: exactly one read at models/maintenance.py a
    # tick (the drop count), and on srekf_fast one at models/srekf_fast.py
    # (the recompression's finiteness flag) for each recompression the
    # tick runs, an eviction's and the schedule's every sr_noise_buffer
    # ticks; nothing else
    for name, kw in (("tuned", TUNED5),
                     ("srekf_fast", dict(SR_PATH, sr_noise_buffer=16))):
        ep5c, rp5c = slice_params(torch, 256, **kw)
        sr5 = ep5c.update_mode == "srekf_fast"
        odo5c, rng5c, ang5c, dr5c = session_inputs(rp5c, T5R, 1024)
        odo5c, rng5c, ang5c = (a_.to(dev) for a_ in (odo5c, rng5c, ang5c))
        dr5c = [(u.to(dev), s_.to(dev)) for u, s_ in dr5c]
        sess5c = tp.SlamSession(ekf_params=ep5c, ransac_params=rp5c,
                                **MAINT_KW)
        carry5c = sess5c.init_carry(first_odom=odo5c[0])
        torch.cuda.synchronize()
        census5c, ev5c = [], []
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for t in range(T5R):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    carry5c, o = sess5c.step(carry5c, odo5c[t], rng5c[t],
                                             ang5c, draws=dr5c[t])
                census5c.append(sorted(
                    w.filename.split("ekf_slam_tpu_torch/")[-1]
                    for w in caught if "synchroniz" in str(w.message)))
                ev5c.append(o.n_evicted)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ev5c = torch.stack(ev5c).cpu()
        n_rec = [int(sr5) * (int(ev5c[t] > 0)
                             + int((t + 1) % ep5c.sr_noise_buffer == 0))
                 for t in range(T5R)]
        want5c = [["models/maintenance.py"]
                  + ["models/srekf_fast.py"] * n_rec[t] for t in range(T5R)]
        check(census5c == want5c, f"maintenance {name}: host syncs a tick "
              f"{census5c}, expected {want5c}")
        check(bool((ev5c > 0).any()), f"maintenance {name} census: nothing "
              f"evicted")
        log(f"phase 5 maintenance {name} sync census ok: {T5R} ticks, "
            f"{sum(map(len, census5c))} host syncs: one at "
            f"models/maintenance.py every tick"
            + (f", one at models/srekf_fast.py for each of the "
               f"{sum(n_rec)} recompressions (the "
               f"{int((ev5c > 0).sum())} evicting ticks' and the "
               f"{T5R // ep5c.sr_noise_buffer} scheduled)" if sr5 else "")
            + f"; {int((ev5c > 0).sum())} ticks evicted, no other sync")
        del sess5c, carry5c

    # -- 6. the tuned path at full width -------------------------------------------
    T = 64
    T_SR = 72                           # the square-root path's run (7b)
    # ticks profiled after each run (the profiler's post-processing grows
    # with the operations it records, and every phase shares the script's
    # time limit)
    T_PROF = 4
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
    tick6_ms = run6["tick_median"]      # beside the fleet's tick (12a)
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
        syncs6c = syncs_of(caught)
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
            syncs9.append(syncs_of(caught))
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
                   syrk_gram=T_SR // B9)
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
        f"{tick9[rec]:.3f} ms (CUDA events; with the plain Gram "
        f"{RECOMPRESSION_TICK_BEFORE_MS} ms, a constant from an earlier "
        f"run, PERF.md §5)")
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

    # K6 on the factor the recompression was handed (a comparison launch,
    # after the path's counts were read): its Gram against the plain
    # versions and the f64 Gram, the control, and the session's factor
    # against the Cholesky of the library Gram
    S_h, na_h, L_sess = handed["S"], handed["n_active"], handed.pop("L")
    G6 = K.syrk_gram(S_h, use_pallas=True)
    with full_f32_matmul():
        G_lib = torch.matmul(S_h, S_h.T)
    err_k6 = (G6 - G_lib).abs().max().item()
    rel6 = err_k6 / G_lib.abs().max().item()
    check(rel6 <= 1e-5, f"K6 on the path: relative error {rel6} > 1e-5")
    check(torch.equal(G6, G6.T), "K6 on the path: G not bit-symmetric")
    plain_h = gram_plain_errors(S_h)
    res_h = gram_compare(G6, S_h, plain_h)
    ctrl_h = gram_compare(tf32_single_pass(S_h), S_h, plain_h)
    check(res_h["ok"], f"K6 on the handed factor: e {res_h['err']:.3e} > "
          f"limit {res_h['limit']:.3e} (plain f32 Grams' e {plain_h})")
    check(not ctrl_h["ok"], f"the single-TF32-pass control passed on the "
          f"handed factor (e {ctrl_h['err']:.3e}, limit "
          f"{ctrl_h['limit']:.3e})")
    L_lib = chol_for_state(G_lib, na_h)
    del G_lib
    d_act = 3 + 2 * int(na_h.item())
    Ls, Ll = L_sess[:d_act, :d_act], L_lib[:d_act, :d_act]
    rel_l = ((Ls - Ll).abs().max() / Ll.abs().max()).item()
    check(rel_l <= 1e-3, f"the session's recompressed factor differs from "
          f"the Cholesky of torch.matmul(S, S.T) by {rel_l} of its largest "
          f"entry")
    n_zero = int((S_h == 0).all(dim=1).sum())
    log(f"phase 7b K6 on the handed factor ok: S ({D9}, {D9}) f32, "
        f"{n_zero} zero rows; relative error {rel6:.3e} of |S·Sᵀ|max "
        f"against torch.matmul, bit-symmetric; gram_compare e "
        f"{res_h['err']:.3e} (limit {res_h['limit']:.3e}; plain f32 Grams' "
        f"e " + ", ".join(f"{k} {v:.3e}" for k, v in plain_h.items())
        + f"); the one-TF32-pass control e {ctrl_h['err']:.3e} fails; the "
        f"session's factor (K6 on its path) is within {rel_l:.3e} of the "
        f"Cholesky of torch.matmul(S, S.T) on the active {d_act}×{d_act} "
        f"block")
    del L_lib, L_sess

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
    # D(D+1)/2 dot products of length R = D, each product three TF32 ones
    ops6 = D9 * (D9 + 1) * D9              # 2 flops per multiply-add
    entry("syrk_gram", "syrk_gram.cu",
          "ekf_slam_tpu/ops/pallas/kernels.py:413",
          launches9["syrk_gram"], err_k6,
          event_ms(torch, lambda: K.syrk_gram(S_h, use_pallas=True)),
          event_ms(torch, lambda: K.syrk_gram_ref(S_h)),
          D9 * D9 * 4 + D9 * D9 * 4,       # read S, write G
          3 * ops6, TF32_FLOPS,
          event_ms(torch, lambda: torch.matmul(S_h, S_h.T)))
    kernels["syrk_gram"]["on_path"] = True
    k6 = kernels["syrk_gram"]
    # the same on a dense S of phase 4's shape; and cuBLAS's single TF32
    # pass, a different function (one TF32 product, not f32-accurate),
    # for the tensor-core rate cuBLAS reaches
    Sd = torch.randn((D9, D9), generator=g, device=dev)
    k6_dense = event_ms(torch, lambda: K.syrk_gram(Sd, use_pallas=True))
    lib_dense = event_ms(torch, lambda: torch.matmul(Sd, Sd.T))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_dense = event_ms(torch, lambda: torch.matmul(Sd, Sd.T))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del Sd
    chol_ms = event_ms(torch, lambda: chol_for_state(G6, na_h))
    del G6
    state_h = FilterState(
        x=torch.zeros((D9,), device=dev), P=S_h,
        sig=torch.zeros((ep9.capacity,), device=dev),
        active=torch.zeros((ep9.capacity,), dtype=torch.bool, device=dev),
        n_active=na_h)

    def recompress_plain_gram():
        # the recompression with the flag-less, plain Gram
        srekf_fast_mod.syrk_gram = lambda S, use_pallas=None: K.syrk_gram(S)
        try:
            return real_recompress(state_h)
        finally:
            srekf_fast_mod.syrk_gram = K.syrk_gram

    rec_runs = {"plain": [], "K6": []}
    for which in ("plain", "K6", "K6", "plain"):
        rec_runs[which].append(event_ms(
            torch, recompress_plain_gram if which == "plain"
            else lambda: real_recompress(state_h), iters=2))
    rec_ms = statistics.mean(rec_runs["K6"])
    rec_plain_ms = statistics.mean(rec_runs["plain"])
    del S_h, state_h
    check(rec_plain_ms - rec_ms >= 0.8 * (k6["library_ms"] - k6["ms"]),
          f"the recompression with K6 ({rec_runs['K6']} ms) is not faster "
          f"than with the plain Gram ({rec_runs['plain']} ms) by 0.8 × "
          f"(torch.matmul {k6['library_ms']:.3f} − K6 {k6['ms']:.3f} ms)")
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
    log(f"phase 8 syrk_gram at D=R={D9} f32: {k6['ms']:.4f} ms on the "
        f"handed factor, {k6_dense:.4f} ms on a dense S; "
        f"{100 * k6['bound_ms'] / k6['ms']:.1f}% of its 3xTF32 bound "
        f"{k6['bound_ms']:.2f} ms ({3 * ops6:.4g} FLOP at 495 TFLOP/s), "
        f"{100 * ops6 / F32_FLOPS * 1e3 / k6['ms']:.1f}% of its f32 "
        f"CUDA-core bound {ops6 / F32_FLOPS * 1e3:.2f} ms (67 TFLOP/s); "
        f"torch.matmul(S, S.T) {k6['library_ms']:.4f} ms on the handed "
        f"factor ({k6['ms'] / k6['library_ms']:.3f}x of it), {lib_dense:.4f}"
        f" ms on the dense S ({k6_dense / lib_dense:.3f}x); the parent's "
        f"K6 (f32 FMAs on CUDA cores) {K6_BEFORE_MS} ms, a constant from an "
        f"earlier run; card: {card}")
    log(f"phase 8 a different function, for the rate only: torch.matmul "
        f"with allow_tf32 True (one TF32 pass, not f32-accurate) on the "
        f"dense S {tf32_dense:.4f} ms, "
        f"{100 * 2 * D9 ** 3 / TF32_FLOPS * 1e3 / tf32_dense:.1f}% of the "
        f"TF32 rate for its {2 * D9 ** 3:.4g} FLOP (the full product)")
    log(f"phase 8 square-root recompression at D={D9} f32: the blocked "
        f"Cholesky (chol_for_state) {chol_ms:.3f} ms; the whole "
        f"sr_recompress (Gram + Cholesky + one host read) with K6 (its "
        f"path) {rec_ms:.3f} ms, with the plain Gram {rec_plain_ms:.3f} ms "
        f"(in turns, plain, K6, K6, plain: {rec_runs}): "
        f"{rec_plain_ms - rec_ms:.3f} ms faster, against 0.8 × "
        f"(torch.matmul − K6) = "
        f"{0.8 * (k6['library_ms'] - k6['ms']):.3f} ms")

    torch.cuda.empty_cache()

    # -- 9. the sequential session at full width ---------------------------
    # the flagship run and extractor with the one-seed wall search
    # (n_hypotheses 0), EKF_SLAM_UC, EKFParams(capacity=10000, max_obs=8,
    # ref_compat=False): P [20003²] f32, unpadded.  Every observation row
    # runs its masked rank-2 update, so a tick makes max_obs passes over P;
    # JAX launches no Pallas kernel on this path, and neither may the port
    T9 = 32
    ep9s, rp9s = slice_params(torch, 10000, update_mode="sequential")
    rp9s = dataclasses.replace(rp9s, n_hypotheses=0)
    run9s = full_width_run(torch, tp, W, counted, ep9s, rp9s, traj, T9)
    filt9s = run9s["carry"].filt
    D9s = ep9s.dim
    check(filt9s.P.shape == (D9s, D9s) and filt9s.P.dtype == torch.float32,
          f"sequential P is {tuple(filt9s.P.shape)} {filt9s.P.dtype}")
    check(not any(run9s["launches"].values()),
          f"the sequential path launched {run9s['launches']}, expected no "
          f"kernel")
    log(f"phase 9 sequential session full width ok: capacity "
        f"{ep9s.capacity}, max_obs {ep9s.max_obs}, D={D9s} f32, the "
        f"one-seed wall search, " + run9s["summary"])
    prof9s, ops9s = profile_ticks(torch, run9s["sess"], run9s["carry"], traj,
                                  T9, T_PROF)
    log(f"phase 9 profile: {prof9s}")
    # the rank-2 update alone at the path's shape, P.addmm_(Kg, HP,
    # alpha=-1) as ekf._correct issues it: CUDA-graph replays
    g9 = torch.Generator(device=dev).manual_seed(9)
    Kg9 = torch.randn((D9s, 2), generator=g9, device=dev) * 1e-6
    HP9 = torch.randn((2, D9s), generator=g9, device=dev) * 1e-6
    P9s = filt9s.P
    upd9_ms = cuda_ms(torch, lambda: P9s.addmm_(Kg9, HP9, alpha=-1), 10,
                      warmup=2)
    upd9_bound = (2 * D9s * D9s + 4 * D9s) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"phase 9 rank-2 update: P.addmm_ at D={D9s} f32 {upd9_ms:.4f} ms "
        f"(CUDA-graph replays) against its HBM bound {upd9_bound:.4f} ms "
        f"(P read and written once at 3.35 TB/s): "
        f"{100 * upd9_bound / upd9_ms:.1f}%; {ep9s.max_obs} a tick = "
        f"{ep9s.max_obs * upd9_ms:.3f} ms of the tick median "
        f"{run9s['tick_median']:.3f} ms; card: {card}")
    del run9s, filt9s, P9s, Kg9, HP9
    torch.cuda.empty_cache()

    # -- 9b. bench.py's sequential metric ------------------------------------
    # bench.py:195-208: a full state of 1,000 landmarks (checks.full_state,
    # D = 2003, f32 P), ML association with s_cost 1e6 and s_thresh 1e12,
    # and 256 gate + update steps in a row, each gated against the state
    # the previous one left; one warm-up and 5 timed repetitions, each from
    # a copy of the same state (the JAX chain is a pure function of it)
    ep9b = sequential_params(1000)
    st9b = full_state(ep9b, 1000, seed=0, device=dev)
    N9B, REPS9B = 256, 5
    zs9b = torch.tensor(full_measurements(st9b.x, 1000, N9B, seed=1),
                        dtype=torch.float32, device=dev)

    # steps profiled: a whole chain is ~127,000 device operations, whose
    # post-processing by the profiler took most of the phase
    N9B_PROF = 32

    def chain9b():
        return sequential_chain(FilterState(*(v.clone() for v in st9b)),
                                zs9b[:N9B_PROF], ep9b)
    rep_ms, syncs9b = [], []
    for r in range(1 + REPS9B):
        ev9 = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        st_r = FilterState(*(v.clone() for v in st9b))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ev9[0].record()
                st_r = sequential_chain(st_r, zs9b, ep9b)
                ev9[1].record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs9b += syncs_of(caught)
        check(bool(torch.isfinite(st_r.P).all())
              and bool(torch.isfinite(st_r.x).all()),
              f"phase 9b repetition {r}: state not finite")
        if r:
            rep_ms.append(ev9[0].elapsed_time(ev9[1]))
    check(not syncs9b, f"the sequential chain synchronised with the host "
          f"at {syncs9b}")
    med9b = statistics.median(rep_ms)
    spread9b = 100 * (max(rep_ms) - min(rep_ms)) / med9b
    prof9b = profile_device(torch, chain9b, N9B_PROF, "step")
    log(f"phase 9b bench.py's sequential metric ok: 1000 landmarks, D="
        f"{ep9b.dim} f32, {N9B} gate + update steps a chain, median of "
        f"{REPS9B} {med9b:.3f} ms (each {[round(v, 3) for v in rep_ms]}; "
        f"spread {spread9b:.1f}%), {N9B / med9b * 1e3:.1f} updates/s, no "
        f"host sync; card: {card}")
    log(f"phase 9b profile: {prof9b[0]}")
    del st9b, st_r, zs9b
    torch.cuda.empty_cache()

    # -- 9c. the QR square-root filter --------------------------------------
    # update_mode='srekf' at capacity 1000 (D = 2003; the JAX package calls
    # it a small-capacity mode, config.py:123-125) on the flagship run and
    # extractor: each tick QRs a (D+1)×D and a (2M+D)² pre-array
    T9C = 32
    ep9c, rp9c = slice_params(torch, 1000, update_mode="srekf")
    run9c = full_width_run(torch, tp, W, counted, ep9c, rp9c, traj, T9C)
    L9c = run9c["carry"].filt.P
    n9c = int(run9c["carry"].filt.n_active.item())
    D9c, M9c = ep9c.dim, ep9c.max_obs
    check(L9c.shape == (D9c, D9c) and L9c.dtype == torch.float32,
          f"QR factor is {tuple(L9c.shape)} {L9c.dtype}")
    check(torch.equal(L9c, L9c.tril()), "QR factor not lower triangular")
    check(bool((torch.diagonal(L9c) >= 0).all()), "QR factor diag < 0")
    check(not bool(L9c[3 + 2 * n9c:].any()),
          "QR factor's inactive rows not exactly 0")
    expect9c = {k: T9C if k == "wall_search" else 0 for k in counted}
    check(run9c["launches"] == expect9c,
          f"QR path launches {run9c['launches']}, expected {expect9c}")
    log(f"phase 9c QR square-root session ok: capacity {ep9c.capacity}, "
        f"L ({D9c}, {D9c}) f32 lower triangular, diag ≥ 0, inactive rows "
        f"0, " + run9c["summary"])
    prof9c, ops9c = profile_ticks(torch, run9c["sess"], run9c["carry"], traj,
                                  T9C, T_PROF)
    log(f"phase 9c profile: {prof9c}")
    pre_p = torch.randn((D9c + 1, D9c), generator=g9, device=dev)
    pre_u = torch.randn((2 * M9c + D9c, 2 * M9c + D9c), generator=g9,
                        device=dev)
    qr_ms = [event_ms(torch, lambda a=a: torch.linalg.qr(a, mode="r"),
                      iters=5) for a in (pre_p, pre_u)]
    log(f"phase 9c the tick's two QRs: torch.linalg.qr(mode='r') of the "
        f"({D9c + 1}, {D9c}) predict pre-array {qr_ms[0]:.3f} ms and the "
        f"({2 * M9c + D9c})² update pre-array {qr_ms[1]:.3f} ms (CUDA "
        f"events): {100 * sum(qr_ms) / run9c['tick_median']:.1f}% of the "
        f"tick median {run9c['tick_median']:.3f} ms; card: {card}")
    del run9c, L9c, pre_p, pre_u
    torch.cuda.empty_cache()

    # -- 10. the large-world campaign session at full width -----------------
    # experiments/chip_r5_world.py's session at capacity 10000: the 16 × 16
    # room floorplan (~2,000 walls), its serpentine route at 0.25 m a tick,
    # 1024 beams, odometry heading noise 0.5°, checks.campaign_params with
    # tuned_params (bf16 P [20480²], SYRK, max_obs 24, guard 0.5 m, the
    # fitted R, NH = 192, a 20,000-entry table), fused control with the
    # campaign's ICP gates and maintenance with merge radius 0.4.  One cut:
    # the first 400 ticks of the route
    T10, T10W = 400, 32
    world10, ctrl10, start10 = campaign_route(16, T10 + T_PROF)
    world10 = W.World(world10.segments.to(dev, torch.float32))
    cfg10 = tp.SimConfig(n_beams=1024, max_range=10.0, range_noise_std=0.01,
                         odom_xy_noise_std=0.004, odom_theta_noise_std=0.5)
    g10 = torch.Generator(device=dev)
    g10.manual_seed(0)
    traj10 = W.simulate(world10, torch.tensor(ctrl10, dtype=torch.float32,
                                              device=dev),
                        cfg10, g10, start_pose=tuple(start10))
    ep10, rp10 = campaign_params(10000, torch.float32, "fused", 0.5)
    check((ep10.pht_mode, ep10.cov_dtype, ep10.correction, ep10.max_obs,
           ep10.guard_max_jump, ep10.noise_model, rp10.n_hypotheses,
           rp10.table_capacity)
          == ("rows", torch.bfloat16, "syrk", 24, 0.5, "fit", 192, 20000),
          f"campaign configuration changed: {ep10}, {rp10}")
    sess_kw10 = dict(control_source="fused", collect_nis=True,
                     **CAMPAIGN_SESSION)

    def campaign_run(ep_, T_, hook=None, **kw_):
        """T_ ticks of the route from its start through a fresh session
        (handed to ``hook`` first, if given); the per-tick CUDA-event
        times and stacked outputs."""
        skw = dict(sess_kw10, **kw_)
        s_ = tp.SlamSession(ekf_params=ep_, ransac_params=rp10, seed=1,
                            **skw)
        if hook is not None:
            hook(s_)
        c_ = s_.init_carry(first_odom=traj10.odom[0], init_pose=start10,
                           n_beams=(1024 if skw["control_source"] != "odometry"
                                    else None))
        ev_ = [torch.cuda.Event(enable_timing=True) for _ in range(T_ + 1)]
        o_ = []
        ev_[0].record()
        for t_ in range(T_):
            c_, out_ = s_.step(c_, traj10.odom[t_], traj10.ranges[t_],
                               traj10.beam_angles)
            ev_[t_ + 1].record()
            o_.append(out_)
        torch.cuda.synchronize()
        return s_, c_, session_mod.stack_outputs(o_), [
            ev_[t_].elapsed_time(ev_[t_ + 1]) for t_ in range(T_)]

    # warm-up and a sync census of three ticks on a first carry
    sess10 = tp.SlamSession(ekf_params=ep10, ransac_params=rp10, seed=1,
                            **sess_kw10)
    warm = sess10.init_carry(first_odom=traj10.odom[0], init_pose=start10,
                             n_beams=1024)
    for t in range(3):
        warm, _ = sess10.step(warm, traj10.odom[t], traj10.ranges[t],
                              traj10.beam_angles)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for t in range(3, 6):
            warm, _ = sess10.step(warm, traj10.odom[t], traj10.ranges[t],
                                  traj10.beam_angles)
    torch.cuda.set_sync_debug_mode(0)
    syncs10 = syncs_of(caught)
    del warm, sess10
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(len(syncs10) == 3 and all("models/maintenance.py" in w
                                    for w in syncs10),
          f"campaign: {len(syncs10)} host syncs in 3 ticks at {syncs10}, "
          f"expected exactly one a tick, maintenance's read")

    # each feature's share of every tick of the run: a host span
    # (perf_counter) and a CUDA-event interval around the session's ICP
    # control, the guard's snapshot and verdict, and maintenance
    spans10 = {"ICP": [], "the guard": [], "maintenance": []}

    def spanned(key, fn):
        def inner(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            h0 = time.perf_counter()
            out = fn(*a, **k)
            h1 = time.perf_counter()
            e1.record()
            spans10[key].append(((h1 - h0) * 1e3, e0, e1))
            return out
        return inner

    def instrument(s_):
        s_._icp_control = spanned("ICP", s_._icp_control)
        s_._snapshot = spanned("the guard", s_._snapshot)
    real_guarded, real_maintain = session_mod.guarded, session_mod.maintain
    session_mod.guarded = spanned("the guard", real_guarded)
    session_mod.maintain = spanned("maintenance", real_maintain)
    for fn in counted.values():
        fn.launches = 0
    w0 = time.perf_counter()
    try:
        sess10, carry10, outs10, ticks10 = campaign_run(ep10, T10,
                                                        hook=instrument)
    finally:
        session_mod.guarded, session_mod.maintain = (real_guarded,
                                                     real_maintain)
    wall10 = (time.perf_counter() - w0) * 1e3 / T10
    del sess10._icp_control, sess10._snapshot      # the class's own again
    # per tick: the guard's two calls summed; then the median over ticks
    span_host10, span_dev10 = {}, {}
    for key, sp in spans10.items():
        per = len(sp) // T10
        check(len(sp) == per * T10 and per in (1, 2),
              f"campaign: {len(sp)} {key} spans in {T10} ticks")
        span_host10[key] = statistics.median(
            sum(x[0] for x in sp[t * per:(t + 1) * per]) for t in range(T10))
        span_dev10[key] = statistics.median(
            sum(x[1].elapsed_time(x[2]) for x in sp[t * per:(t + 1) * per])
            for t in range(T10))
    launches10 = {k: fn.launches for k, fn in counted.items()}
    filt10 = carry10.filt
    check(filt10.P.shape == (20480, 20480)
          and filt10.P.dtype == torch.bfloat16,
          f"campaign P is {tuple(filt10.P.shape)} {filt10.P.dtype}")
    check(launches10 == dict(syrk_downdate=T10, gate_costs=0, score_lines=0,
                             wall_search=T10, cov_update=0, pair_gather=0,
                             syrk_gram=0),
          f"campaign launches {launches10}, expected {T10} syrk_downdate, "
          f"{T10} wall_search and no other")
    check(bool(torch.isfinite(filt10.x).all())
          and bool(torch.isfinite(filt10.P).all()), "campaign: state not "
          "finite")
    n10 = int(filt10.n_active.item())
    check(n10 > 0, "campaign: no landmark mapped")
    n_icp = int(outs10.icp_ok.sum())
    check(n_icp > T10 // 2, f"campaign: ICP taken on {n_icp} of {T10} ticks")
    est10 = outs10.pose.double().cpu().numpy()
    tru10 = traj10.truth[:T10].double().cpu().numpy()
    Rg, tg = W.align_se2(est10[:, :2], tru10[:, :2])
    al10 = est10[:, :2] @ Rg.T + tg
    ate10 = float(np.sqrt(np.mean(np.sum((al10 - tru10[:, :2]) ** 2, -1))))
    raw10 = float(np.sqrt(np.mean(np.sum((est10[:, :2] - tru10[:, :2]) ** 2,
                                         -1))))
    odo10 = traj10.odom[:T10, :2].double().cpu().numpy()
    ate_odo10 = float(np.sqrt(np.mean(np.sum((odo10 - tru10[:, :2]) ** 2,
                                             -1))))
    check(ate10 < 1.5, f"campaign: aligned ATE {ate10} m (raw {raw10})")
    lm10 = filt10.x[3:3 + 2 * n10].double().cpu().numpy().reshape(n10, 2)
    gt10 = W.cluster_feet(W.true_feet(world10), 0.5)
    map10 = W.map_accuracy(lm10, gt10, tol=0.6)
    map10a = W.map_accuracy(lm10 @ Rg.T + tg, gt10, tol=0.6)
    nis10 = outs10.nis.double().cpu().numpy()
    fin10 = np.isfinite(nis10)
    ev10 = outs10.n_evicted.cpu()
    rej10 = torch.nonzero(~outs10.guard_ok.cpu()).flatten().tolist()
    med10 = statistics.median(ticks10)
    log(f"phase 10 campaign session full width ok: 16 × 16 rooms, "
        f"{world10.segments.shape[0]} walls, {len(gt10)} effective ground-"
        f"truth landmarks; capacity 10000, D=20480 bf16, {T10} ticks, "
        f"n_active {n10}, aligned ATE {ate10:.4f} m (raw {raw10:.4f}, "
        f"odometry {ate_odo10:.4f}), ICP taken on {n_icp} of {T10} ticks, "
        f"{int(ev10.sum())} landmarks evicted in {int((ev10 > 0).sum())} "
        f"ticks, {len(rej10)} ticks rejected by the guard {rej10[:20]}, "
        f"map {map10}, map aligned {map10a}, NIS mean "
        f"{float(nis10[fin10].mean()) if fin10.any() else float('nan'):.4f} "
        f"over {int(fin10.sum())} observations; launches {launches10}; host "
        f"syncs {len(syncs10)} in 3 ticks at {sorted(set(syncs10))}; tick "
        f"median {med10:.3f} ms (CUDA events), wall {wall10:.3f} ms/tick; "
        f"card: {card}")
    log(f"phase 10 feature spans inside the run (median over its {T10} "
        f"ticks; host perf_counter, and the CUDA-event interval on the "
        f"device's timeline, which is the host's time where the device "
        f"waits on it): "
        + "; ".join(f"{k} host {span_host10[k]:.3f} ms, events "
                    f"{span_dev10[k]:.3f} ms ({100 * span_host10[k] / med10:.1f}% "
                    f"of the tick)" for k in span_host10)
        + f"; tick median {med10:.3f} ms; maintenance's span includes the "
        f"wait at its one host read for the device to drain the tick's "
        f"queued work; card: {card}")
    prof10, ops10 = profile_ticks(torch, sess10, carry10, traj10, T10,
                                  T_PROF)
    log(f"phase 10 profile: {prof10}")
    # ICP alone at the campaign's shapes: two consecutive scans' points
    sc_a = scan_from_ranges(traj10.ranges[9], traj10.beam_angles)
    sc_b = scan_from_ranges(traj10.ranges[10], traj10.beam_angles)
    pa, pb = to_cartesian(sc_a), to_cartesian(sc_b)

    def icp_once():
        return icp(pb, sc_b.valid, pa, sc_a.valid, iters=sess10.icp_iters,
                   max_pair_dist=sess10.icp_max_pair_dist)
    icp_prof = profile_device(torch, icp_once, 1, "call")
    icp_ms = event_ms(torch, icp_once, iters=10, warmup=2)
    # the guard's passes on the run's P: the pre-measure copy, then the
    # verdict (isfinite over P, the diagonal) and the masked select back
    # into P; their bound is 6·|P| bytes (the copy reads and writes P, the
    # verdict reads it, the select reads P and the copy and writes P)
    snap_ms = event_ms(torch, lambda: sess10._snapshot(filt10), iters=10)
    before10 = sess10._snapshot(filt10)
    guard_ms = event_ms(torch, lambda: guarded(before10, filt10, 0.5),
                        iters=10)
    p_bytes = filt10.P.numel() * filt10.P.element_size()
    guard_bound = 6 * p_bytes / HBM_BYTES_PER_S * 1e3
    del before10
    dup_ms = event_ms(torch, lambda: MT.duplicate_mask(filt10, 0.4),
                      iters=10)
    # the blocked mask's torch ops write and read ~16 [K,K] planes: five
    # f32 (Δx, Δy, their squares, the sum) and eleven bool, ~62 bytes a
    # pair in all
    dup_bytes = 10000 * 10000 * 62
    log(f"phase 10 profile: busy and operations above; ICP one call "
        f"{icp_ms:.3f} ms (CUDA events), {icp_prof[1]} device operations "
        f"({sess10.icp_iters} iterations); the guard's passes: copy "
        f"{snap_ms:.4f} ms + verdict and select {guard_ms:.4f} ms = "
        f"{snap_ms + guard_ms:.4f} ms against their bound {guard_bound:.4f} "
        f"ms (6 × {p_bytes / 1e6:.1f} MB at 3.35 TB/s; "
        f"{100 * guard_bound / (snap_ms + guard_ms):.1f}%); duplicate_mask "
        f"over 10000 slots {dup_ms:.4f} ms (its [K,K] planes, ~62 bytes a "
        f"pair read and written by its torch ops: ~{dup_bytes / 1e9:.1f} "
        f"GB, {dup_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM rate); ICP profile: {icp_prof[0]}; card: {card}")
    del sess10, carry10, filt10, outs10
    torch.cuda.empty_cache()
    # what each feature costs a tick: the first T10W ticks through fresh
    # sessions with every feature on, the guard off, maintenance off and
    # odometry control, in turns (A B C D D C B A; once, to leave time
    # for phase 12), since the
    # host-bound tick moves between runs; per run the median of ticks 8
    # on, per variant the median of its runs.  A cost is resolved only
    # where every run without the feature is faster than every run with
    # all of them on
    variants10 = (
        ("all on", ep10, {}),
        ("guard off", dataclasses.replace(ep10, guard_max_jump=None), {}),
        ("maintenance off", ep10, dict(maintain_merge_radius=0.0)),
        ("odometry control", ep10, dict(control_source="odometry")))
    cost10 = {label: [] for label, _, _ in variants10}
    for label, ep_, kw_ in variants10 + variants10[::-1]:
        s_, c_, o_, tk_ = campaign_run(ep_, T10W, **kw_)
        cost10[label].append(statistics.median(tk_[8:]))
        del s_, c_, o_
        torch.cuda.empty_cache()
    med_cost = {k: statistics.median(v) for k, v in cost10.items()}
    base10 = med_cost["all on"]
    feats10 = {"the guard": "guard off", "maintenance": "maintenance off",
               "ICP (fused against odometry control)": "odometry control"}
    log(f"phase 10 feature cost: median tick of ticks 8-{T10W - 1}, two "
        f"runs each in turns (A B C D D C B A): "
        + "; ".join(f"{k} {[round(x, 3) for x in v]} ms (median "
                    f"{med_cost[k]:.3f})" for k, v in cost10.items())
        + "; so " + ", ".join(
            f"{name} {base10 - med_cost[off]:.3f} ms a tick"
            + ("" if max(cost10[off]) < min(cost10["all on"])
               else " (not resolved: the runs overlap)")
            for name, off in feats10.items())
        + f"; card: {card}")

    # -- 10b. eviction at full width -----------------------------------------
    # checks.evict_case: bench.py's full state at K = 10000 (all slots
    # active) with per-slot variances spread, a quarter of the slots
    # dropped by prune_by_uncertainty (a cut at the 0.77 quantile of the
    # traces) and duplicate_mask (radius 0.15 m)
    def drop_for(st_, factored):
        tr_ = MT._slot_traces(st_, factored).float()
        cut_ = float(torch.quantile(tr_, 0.77))
        return (MT.duplicate_mask(st_, 0.15, factored)
                | MT.prune_by_uncertainty(st_, cut_, factored))
    evict10b = {}
    for label, ep_ in (("f32", bench_params(10000, cov_dtype=None,
                                            correction="gemm")),
                       ("bf16", bench_params(10000))):
        st_ = evict_case(ep_, seed=0, device=dev)
        D_ = st_.P.shape[0]
        drop_ = drop_for(st_, False)
        nd_ = int(drop_.sum())
        k_ = 3 + 2 * (10000 - nd_)
        rp_ = MT._row_permutation(MT._slot_permutation(drop_, st_.n_active),
                                  D_)[:k_]
        want_ = st_.P[rp_][:, rp_]
        P0_ = st_.P
        ms_ = []
        for r in range(3):
            Pc_ = P0_.clone()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out_ = MT.evict_landmarks(st_._replace(P=Pc_), drop_, ep_)
            e1.record()
            torch.cuda.synchronize()
            ms_.append(e0.elapsed_time(e1))
            if r == 0:
                check(torch.equal(out_.P[:k_, :k_], want_),
                      f"10b {label}: the kept block is not the gather")
                check(not bool(out_.P[k_:].any())
                      and not bool(out_.P[:k_, k_:].any()),
                      f"10b {label}: P not zero past 3 + 2·n_kept")
                check(int(out_.n_active) == 10000 - nd_,
                      f"10b {label}: n_active {int(out_.n_active)}")
            del out_, Pc_
        isz = P0_.element_size()
        bound_ = (k_ * k_ + D_ * D_) * isz / HBM_BYTES_PER_S * 1e3
        evict10b[label] = statistics.median(ms_)
        log(f"phase 10b dense eviction {label} ok: P [{D_}²], {nd_} of "
            f"10000 slots dropped ({100 * nd_ / 10000:.1f}%), the kept "
            f"{k_}² block bit-equal to the gather of the kept rows and "
            f"columns, zeros past; {evict10b[label]:.4f} ms (median of 3, "
            f"CUDA events; {[round(v, 4) for v in ms_]}) against its HBM "
            f"bound {bound_:.4f} ms (the kept block read, P written: "
            f"{100 * bound_ / evict10b[label]:.1f}%); card: {card}")
        del st_, want_, P0_, drop_, rp_
        torch.cuda.empty_cache()
    # the factored eviction: S [20067²] f32 (the Cholesky factor of the
    # same state, 64 zero noise-buffer columns), the kept rows of S, then
    # the recompression (one K6 launch)
    ep_f = bench_params(10000, cov_dtype=None, correction="gemm")
    st_ = evict_case(ep_f, seed=0, device=dev)
    D_ = ep_f.dim + 64
    S_ = torch.zeros((D_, D_), dtype=torch.float32, device=dev)
    S_[:ep_f.dim, :ep_f.dim] = chol_for_state(st_.P, st_.n_active)
    x_ = torch.cat([st_.x, torch.zeros(64, dtype=st_.x.dtype, device=dev)])
    st_ = FilterState(x=x_, P=S_, sig=st_.sig, active=st_.active,
                      n_active=st_.n_active)
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(S_).all()), "10b: the factor is not finite")
    drop_ = drop_for(st_, True)
    nd_ = int(drop_.sum())
    k_ = 3 + 2 * (10000 - nd_)
    rp_ = MT._row_permutation(MT._slot_permutation(drop_, st_.n_active),
                              D_)[:k_]
    S_kept = S_[rp_]                    # the old factor's kept rows [k, D]
    rows_ = torch.linspace(0, k_ - 1, 64, device=dev).round().long()
    plain_ = gram_plain_errors(S_kept, rows=rows_)
    for fn in counted.values():
        fn.launches = 0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    out_ = MT.evict_landmarks_factored(st_, drop_, ep_f)
    e1.record()
    torch.cuda.synchronize()
    fact_ms = e0.elapsed_time(e1)
    launches10b = {k: fn.launches for k, fn in counted.items()}
    check(launches10b == dict(syrk_downdate=0, gate_costs=0, score_lines=0,
                              wall_search=0, cov_update=0, pair_gather=0,
                              syrk_gram=1),
          f"10b factored eviction launched {launches10b}, expected one K6")
    S2 = out_.P
    check(bool(torch.isfinite(S2).all()), "10b: new factor not finite")
    check(torch.equal(S2, S2.tril()), "10b: new factor not triangular")
    check(not bool(S2[k_:].any()), "10b: rows past 3 + 2·n_kept not 0")
    S2k = S2[:k_].double()
    G_rows = S2k[rows_] @ S2k.T
    del S2k
    res_ = gram_compare(G_rows, S_kept, plain_, rows=rows_)
    check(res_["ok"], f"10b: the new factor's Gram on 64 kept rows against "
          f"the f64 Gram of the old kept rows: e {res_['err']} over the "
          f"limit {res_['limit']} (plain f32 Grams' e {plain_})")
    log(f"phase 10b factored eviction ok: S ({D_}, {D_}) f32, {nd_} of "
        f"10000 slots dropped, {launches10b['syrk_gram']} K6 launch (the "
        f"recompression), the new factor finite, lower triangular, zero "
        f"past row {k_}; its Gram on 64 kept rows against the f64 Gram of "
        f"the old factor's kept rows: e {res_['err']:.3e} (limit "
        f"{res_['limit']:.3e}, checks.gram_compare; plain f32 Grams' e "
        + ", ".join(f"{k} {v:.3e}" for k, v in plain_.items())
        + f"); {fact_ms:.3f} ms (CUDA events, one call); card: {card}")
    del st_, S_, S_kept, out_, S2, G_rows, x_
    torch.cuda.empty_cache()
    # -- 11. the live operating path: the stream and the socket feed ---------
    # phase 6's configuration (tuned_params at capacity 10000, bf16 P
    # [20480²], K1 at R = 16, one wall_search a tick) driven through
    # StreamingSlamSession, fed from host numpy arrays as a live robot's
    # feed arrives: the flagship run's first 64 ticks cycled twice
    # (bench.py:434-489 cycles its run 4 times), window 16, max_pending 2
    T11, C11, W11 = 64, 2, 16
    ep11, rp11 = slice_params(torch, 10000)
    ep11 = tuned_params(ep11, batch=ep11.max_obs)
    odom64 = traj.odom[:T11].cpu().numpy()
    rng64 = traj.ranges[:T11].cpu().numpy()
    cyc11 = np.arange(C11 * T11) % T11
    odom11, rng11 = odom64[cyc11], rng64[cyc11]
    stream_file = os.path.relpath(ST.__file__, HERE)
    with open(ST.__file__) as f_:
        wait_lines = {f"{stream_file}:{i + 1}" for i, line in enumerate(f_)
                      if "event.synchronize()" in line}
    check(len(wait_lines) == 1, f"stream.py's event waits: {wait_lines}")

    def fresh11():
        return tp.SlamSession(ekf_params=ep11, ransac_params=rp11, seed=1)

    def stream11(window, ticks=None, per_window=None):
        """A fresh session's stream over ``ticks`` (odometry, ranges),
        pushed one tick at a time, then flushed; ``per_window(stream, w)``
        after each full window's dispatch.  The stream, its outputs and
        the syncs the run made (PyTorch's sync debug mode)."""
        od_, rg_ = ticks if ticks is not None else (odom11, rng11)
        st_ = ST.StreamingSlamSession(fresh11(), n_beams=rg_.shape[1],
                                      beam_angles=traj.beam_angles,
                                      window=window, max_pending=2,
                                      first_odom=od_[0])
        torch.cuda.synchronize()
        got_ = []
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught_:
            warnings.simplefilter("always")
            for t_ in range(od_.shape[0]):
                got_.extend(st_.push(od_[t_], rg_[t_]))
                if per_window is not None and (t_ + 1) % window == 0:
                    per_window(st_, (t_ + 1) // window)
            got_.extend(st_.flush())
        torch.cuda.set_sync_debug_mode(0)
        syncs_ = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}"
                  for w in caught_ if "synchroniz" in str(w.message)]
        check(len(got_) == od_.shape[0] and not st_._pending,
              f"stream: {len(got_)} of {od_.shape[0]} ticks handed back")
        return st_, got_, syncs_

    def same_run(got_, want_, decisions_only=False):
        """The ticks whose outputs differ from the offline run's (poses
        and n_active bit for bit, or only the decisions: n_active, n_obs,
        the observations' validity and slots)."""
        fields = ([("n_active",), ("n_obs",), ("obs", "valid"),
                   ("obs", "index")] if decisions_only
                  else [("pose",), ("n_active",)])
        bad = set()
        for path in fields:
            a = np.stack([o._asdict()[path[0]] if len(path) == 1
                          else getattr(o.obs, path[1]) for o in got_])
            w_ = getattr(want_, path[0]) if len(path) == 1 else getattr(
                want_.obs, path[1])
            w_ = w_[:a.shape[0]].cpu().numpy()
            bad |= set(np.nonzero((a != w_).reshape(a.shape[0], -1)
                                  .any(axis=1))[0].tolist())
        return sorted(bad)

    # 11a: the offline run on the card, then the stream against it
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    carry11, off11 = fresh11().run(odom11, rng11, traj.beam_angles)
    torch.cuda.synchronize()
    off_tps11 = C11 * T11 / (time.perf_counter() - w0)
    P11 = f"{ep11.cov_dt} P [{carry11.filt.P.shape[0]}²]".replace("torch.", "")
    del carry11
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for fn in counted.values():
        fn.launches = 0
    st11, got11, syncs11 = stream11(W11)
    launches11 = {k: fn.launches for k, fn in counted.items()}
    del st11
    torch.cuda.empty_cache()
    n_ticks11 = C11 * T11
    check(launches11 == dict(syrk_downdate=n_ticks11, gate_costs=0,
                             score_lines=0, wall_search=n_ticks11,
                             cov_update=0, pair_gather=0, syrk_gram=0),
          f"stream launches {launches11}, expected {n_ticks11} "
          f"syrk_downdate, {n_ticks11} wall_search and no other")
    outside11 = [s_ for s_ in syncs11 if s_ not in wait_lines]
    check(not outside11, f"stream: {len(outside11)} host syncs outside the "
          f"event waits, at {sorted(set(outside11))}")
    differ11 = same_run(got11, off11)
    nondet11 = None
    if differ11:
        # not bit-equal: both again with PyTorch's deterministic algorithms
        # (warnings name the ops that have none), and every decision must
        # still be equal
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught_d:
            warnings.simplefilter("always")
            _, off_d = fresh11().run(odom11, rng11, traj.beam_angles)
            _, got_d, _ = stream11(W11)
        torch.use_deterministic_algorithms(False)
        nondet11 = sorted({str(w.message).split(".")[0][:160]
                           for w in caught_d
                           if "determinis" in str(w.message)})
        log(f"phase 11 stream against the offline run: poses or n_active "
            f"differ on {len(differ11)} ticks (first {differ11[:8]}); under "
            f"torch.use_deterministic_algorithms they differ on "
            f"{len(same_run(got_d, off_d))}; ops without a deterministic "
            f"version: {nondet11}")
        check(not same_run(got11, off11, True)
              and not same_run(got_d, off_d, True),
              "stream against the offline run: a decision differs")
        del off_d, got_d
    pose_gap11 = max(float(np.abs(o.pose - off11.pose[i].cpu().numpy())
                           .max()) for i, o in enumerate(got11))
    n11 = int(off11.n_active[-1])
    check(n11 > 0, "stream: no landmark mapped")
    log(f"phase 11 stream against the offline run ok: capacity "
        f"{ep11.capacity}, {P11}, {n_ticks11} ticks ({T11} "
        f"cycled {C11} times), window {W11}, max_pending 2, "
        f"{'bit-equal poses and n_active on every tick' if not differ11 else f'decisions equal, pose gap {pose_gap11:.3e}'}"
        f", n_active {n11}; launches {launches11} (one K1 and one "
        f"wall_search a tick); host syncs in the whole run: "
        f"{len(outside11)} outside the event waits, {len(syncs11)} in all "
        f"({len(syncs11) / (n_ticks11 / W11):.2f} a window, at "
        f"{sorted(set(syncs11))}); the offline run itself "
        f"{off_tps11:.3f} ticks/s (wall clock, the session's construction "
        f"and the upload of the inputs included); card: {card}")

    # the stream's throughput and latency: three runs a window size in
    # turns (16, 1, 1, 16, 16, 1), each a fresh session, each checked
    # against the offline run
    sums11 = {W11: [], 1: []}
    for w_ in (W11, 1, 1, W11, W11, 1):
        st_, got_, _ = stream11(w_)
        bad_ = same_run(got_, off11, decisions_only=bool(differ11))
        check(not bad_, f"stream at window {w_}: ticks {bad_[:8]} differ "
              f"from the offline run")
        sums11[w_].append(st_.stats.summary())
        del st_, got_
        torch.cuda.empty_cache()
    keys11 = ("ticks_per_sec", "latency_p50_ms", "latency_p99_ms",
              "latency_mean_ms")
    med11 = {w_: {k: statistics.median(s_[k] for s_ in v)
                  for k in keys11} for w_, v in sums11.items()}
    spread11 = {w_: {k: 100 * (max(s_[k] for s_ in v)
                               - min(s_[k] for s_ in v)) / med11[w_][k]
                     for k in keys11} for w_, v in sums11.items()}
    for w_ in (W11, 1):
        m_ = med11[w_]
        log(f"phase 11 stream window {w_}: {m_['ticks_per_sec']:.3f} "
            f"ticks/s, latency p50 {m_['latency_p50_ms']:.3f} ms, p99 "
            f"{m_['latency_p99_ms']:.3f} ms, mean "
            f"{m_['latency_mean_ms']:.3f} ms (medians of 3 runs of "
            f"{n_ticks11} ticks, StreamStats.summary(); spreads "
            + ", ".join(f"{k} {spread11[w_][k]:.1f}%" for k in keys11)
            + "; runs " + "; ".join(
                f"{s_['ticks_per_sec']:.3f}/s p50 {s_['latency_p50_ms']:.3f}"
                for s_ in sums11[w_])
            + f"); card: {card}")

    # 11b: the socket feed.  A spawned process (the CUDA context must not
    # be forked) runs the port's Python feeder on localhost; the stream
    # consumes the feed at window 16 and must give the offline run's first
    # 64 ticks
    def free_port():
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            return s_.getsockname()[1]

    def consume(port_, connect_s, retry=None):
        """Connect (retrying until ``retry`` says stop) and stream the
        feed through a fresh session: the outputs and the syncs."""
        t_end = time.monotonic() + connect_s
        while True:
            try:
                src_ = SF.SocketScanSource("127.0.0.1", port_,
                                           connect_timeout=10.0,
                                           timeout=120.0)
                break
            except ConnectionRefusedError:
                check(time.monotonic() < t_end and (retry is None
                                                    or retry()),
                      f"no scan feed came up on port {port_}")
                time.sleep(0.05)
        check(src_.n_beams == 1024 and src_.dtype == np.float32,
              f"feed header: {src_.n_beams} beams, {src_.dtype}")
        frames_ = list(src_)
        check(len(frames_) == T11, f"feed sent {len(frames_)} ticks")
        od_ = np.stack([o for o, _ in frames_])
        rg_ = np.stack([r for _, r in frames_])
        check(np.array_equal(od_, odom64)
              and np.array_equal(rg_, rng64, equal_nan=True),
              "the feed's frames differ from the arrays fed")
        return stream11(W11, ticks=(od_, rg_))

    ctx11 = multiprocessing.get_context("spawn")
    port11 = free_port()
    ready11 = ctx11.Event()
    feeder = ctx11.Process(target=SF.serve_trajectory,
                           args=(port11, odom64, rng64),
                           kwargs=dict(ready_event=ready11, timeout=120.0),
                           daemon=True)
    w0 = time.perf_counter()
    feeder.start()
    try:
        check(ready11.wait(120), "the Python feeder never came up")
        _, got_py, syncs_py = consume(port11, 60.0)
        feeder.join(60)
        check(feeder.exitcode == 0, f"feeder exit code {feeder.exitcode}")
    finally:
        if feeder.is_alive():
            feeder.terminate()
            feeder.join(10)
    py_s = time.perf_counter() - w0
    bad_py = same_run(got_py, off11, decisions_only=bool(differ11))
    check(not bad_py, f"socket feed (Python feeder): ticks {bad_py[:8]} "
          f"differ from the offline run")
    # the native path: the port's C++ codec writes the 64 ticks as a scan
    # log, the C++ feeder replays it over the same protocol
    with tempfile.TemporaryDirectory() as td11:
        log_path = os.path.join(td11, "flagship.ekslog")
        SL.write(log_path, odom64, rng64, native=True)
        lo_, lr_ = SL.read(log_path, native=True)
        check(np.array_equal(lo_, odom64)
              and np.array_equal(lr_, rng64, equal_nan=True),
              "scan log round trip (C++ codec)")
        binary11 = SF.native_feeder_path()
        check(binary11 is not None, "native_feeder_path() built no feeder "
              "(no g++?)")
        port11 = free_port()
        w0 = time.perf_counter()
        proc11 = subprocess.Popen([binary11, log_path, str(port11)],
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.PIPE)
        try:
            _, got_nat, syncs_nat = consume(
                port11, 60.0, retry=lambda: proc11.poll() is None)
            err11 = proc11.communicate(timeout=60)[1].decode()
            check(proc11.returncode == 0, f"C++ feeder exit code "
                  f"{proc11.returncode}: {err11}")
        finally:
            if proc11.poll() is None:
                proc11.kill()
                proc11.wait(10)
        nat_s = time.perf_counter() - w0
    bad_nat = same_run(got_nat, off11, decisions_only=bool(differ11))
    check(not bad_nat, f"socket feed (C++ feeder): ticks {bad_nat[:8]} "
          f"differ from the offline run")
    for name_, sy_ in (("Python", syncs_py), ("C++", syncs_nat)):
        out_ = [s_ for s_ in sy_ if s_ not in wait_lines]
        check(not out_, f"socket feed ({name_} feeder): host syncs outside "
              f"the event waits at {sorted(set(out_))}")
    log(f"phase 11 socket feed ok: {T11} ticks over TCP on localhost into "
        f"the stream (capacity {ep11.capacity}, window {W11}), "
        f"{'bit-equal poses and n_active' if not differ11 else 'decisions equal'}"
        f" against the offline run, from the port's Python feeder in a "
        f"spawned process ({py_s:.3f} s with the process start) and from "
        f"the C++ feeder ({os.path.relpath(binary11, HERE)}) replaying a "
        f"scan log written by the port's C++ codec ({nat_s:.3f} s); no host "
        f"sync outside the event waits; card: {card}")

    # 11c: filter health at the end of each window, logged as JSONL
    with tempfile.TemporaryDirectory() as td11:
        jsonl = os.path.join(td11, "health.jsonl")
        logger11 = MetricsLogger(jsonl)

        def health(st_, w_):
            logger11.log(w_, **filter_health(st_.carry.filt)._asdict())
        try:
            st_, got_, _ = stream11(W11, per_window=health)
        finally:
            logger11.close()
        with open(jsonl) as f_:
            recs11 = [json.loads(line) for line in f_]
    bad_h = same_run(got_, off11, decisions_only=bool(differ11))
    check(not bad_h, f"stream with health logging: ticks {bad_h[:8]} differ")
    check(len(recs11) == n_ticks11 // W11
          and all(r["finite"] is True for r in recs11),
          f"filter health: {len(recs11)} records, finite "
          f"{[r['finite'] for r in recs11]}")
    last11 = recs11[-1]
    log(f"phase 11 filter health ok: {len(recs11)} windows logged "
        f"(MetricsLogger JSONL), finite on every one; last window (tick "
        f"{n_ticks11}, n_active {int(got_[-1].n_active)}): asym "
        f"{last11['asym']!r}, min_diag {last11['min_diag']!r}, trace "
        f"{last11['trace']!r} ({P11}, masked past 3 + 2·n_active); "
        f"card: {card}")
    del st_, got_, got11, got_py, got_nat, off11
    torch.cuda.empty_cache()

    # -- 12. the submap and fleet layer --------------------------------------
    launches12 = fleet_and_submaps(torch, tp, W, counted, dev, card,
                                   tick6_ms, PHASE12)

    # -- 13. checkpoints and crash recovery ----------------------------------
    launches13 = recovery_phase(torch, tp, W, counted, dev, card, PHASE13)

    kernels["syrk_downdate"]["campaign_launches"] = launches10["syrk_downdate"]
    kernels["wall_search"]["campaign_launches"] = launches10["wall_search"]
    kernels["syrk_gram"]["eviction_launches"] = launches10b["syrk_gram"]
    kernels["syrk_downdate"]["stream_launches"] = launches11["syrk_downdate"]
    kernels["wall_search"]["stream_launches"] = launches11["wall_search"]
    kernels["syrk_downdate"]["fleet_launches"] = (
        launches12["fleet"]["syrk_downdate"])
    kernels["wall_search"]["fleet_launches"] = launches12["fleet"]["wall_search"]
    kernels["wall_search"]["submap_launches"] = (
        launches12["submaps"]["wall_search"]
        + launches12["parallel"]["wall_search"])
    for name_, run_ in (("syrk_downdate", "recovery"),
                        ("wall_search", "recovery"), ("pair_gather", "sr"),
                        ("syrk_gram", "sr")):
        kernels[name_]["recovery_launches"] = launches13[run_][name_]

    print(json.dumps({"kernels": [dict(name=n, **k)
                                  for n, k in kernels.items()]}))
    print(gpu_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
