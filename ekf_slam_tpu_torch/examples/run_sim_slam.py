"""Live-session demo on the simulator (counterpart of
examples/run_sim_slam.py, the test_SLAM.m equivalent): the robot is the
deterministic simulator and the session runs tick by tick on the card;
pass --frames to also render reference-style plots (viz.py).

Usage:  python -m ekf_slam_tpu_torch.examples.run_sim_slam [--ticks 200]
            [--frames out_dir] [--device cpu]
"""
import argparse
import os

import torch

from ekf_slam_tpu_torch.config import (EKFParams, RansacParams, SimConfig,
                                       resolve_device)
from ekf_slam_tpu_torch.ops.observations import ObsBatch
from ekf_slam_tpu_torch.session import SlamSession
from ekf_slam_tpu_torch.sim import world as W
from ekf_slam_tpu_torch.utils.metrics import MetricsLogger, filter_health


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--frames", type=str, default=None,
                    help="directory for rendered frames")
    ap.add_argument("--algorithm", default="EKF_SLAM_UC",
                    choices=["EKF_SLAM", "EKF_SLAM_UC"])
    ap.add_argument("--batched", action="store_true",
                    help="use the joint batched-innovation update")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0, device=dev)
    controls = W.circle_controls(args.ticks, dD=0.05, dTh=3.0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    traj = W.simulate(room, controls, cfg, gen)

    ekf_params = EKFParams(
        capacity=32, max_obs=8, ref_compat=False,
        association="known" if args.algorithm == "EKF_SLAM" else "signature",
        update_mode="batched" if args.batched else "sequential",
        dtype=torch.float32)
    ransac_params = RansacParams(
        line_consensus=60, bearing_window_deg=15.0, wall_search_timeout=4,
        table_capacity=64, promote_count=5, ref_compat=False,
        dtype=torch.float32)

    sess = SlamSession(algorithm=args.algorithm, ekf_params=ekf_params,
                       ransac_params=ransac_params, seed=1, device=dev)
    carry, outs = sess.run(traj.odom, traj.ranges, traj.beam_angles)

    est, truth = outs.pose, traj.truth
    ate = float(W.ate_rmse(est[:, :2], truth[:, :2]))
    ate_odo = float(W.ate_rmse(traj.odom[:, :2], truth[:, :2]))
    h = filter_health(carry.filt)
    print(f"ticks={args.ticks}  landmarks={int(carry.filt.n_active)}  "
          f"observations={int(outs.n_obs.sum())}")
    print(f"ATE slam={ate:.4f} m   ATE odometry-only={ate_odo:.4f} m")
    print(f"P health: finite={bool(h.finite)} asym={float(h.asym):.2e} "
          f"min_diag={float(h.min_diag):.2e}")

    if args.metrics:
        n_active = outs.n_active.tolist()
        n_obs = outs.n_obs.tolist()
        err = torch.linalg.vector_norm(est[:, :2] - truth[:, :2],
                                       dim=-1).tolist()
        log = MetricsLogger(path=args.metrics)
        for t in range(args.ticks):
            log.log(t, n_active=int(n_active[t]), n_obs=int(n_obs[t]),
                    err=float(err[t]))
        log.close()
        print(f"metrics -> {args.metrics}")

    if args.frames:
        from ekf_slam_tpu_torch import viz
        from ekf_slam_tpu_torch.ops.scan import scan_from_ranges, scan_to_world
        os.makedirs(args.frames, exist_ok=True)
        last_obs = ObsBatch(*(None if a is None else a[-1]
                              for a in outs.obs))
        sw = scan_to_world(scan_from_ranges(traj.ranges[-1],
                                            traj.beam_angles), est[-1])
        p = viz.save_frame(os.path.join(args.frames, "final.png"),
                           carry.filt, table=carry.table, obs=last_obs,
                           scan_world=sw, truth=truth)
        print(f"frame -> {p}")
    return 0


if __name__ == "__main__":
    main()
