"""Occupancy-grid mapping from a live SLAM run (counterpart of
examples/occupancy_mapping.py): run the SLAM session (predict → RANSAC →
gate → update), then fuse every scan at its ESTIMATED pose into a
log-odds occupancy grid (ops/occupancy.py), one scan after another on the
session's device.

Usage:  python -m ekf_slam_tpu_torch.examples.occupancy_mapping
            [--ticks 200] [--out map.png] [--device cpu]
"""
import argparse

import numpy as np
import torch

from ekf_slam_tpu_torch.config import (EKFParams, RansacParams, SimConfig,
                                       resolve_device)
from ekf_slam_tpu_torch.ops.occupancy import (init_grid, map_session,
                                              occupancy_probability)
from ekf_slam_tpu_torch.session import SlamSession
from ekf_slam_tpu_torch.sim import world as W


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--resolution", type=float, default=0.1,
                    help="meters per grid cell")
    ap.add_argument("--out", type=str, default=None,
                    help="render the probability grid to this PNG")
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

    sess = SlamSession(
        ekf_params=EKFParams(capacity=32, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=torch.float32),
        ransac_params=RansacParams(
            line_consensus=60, bearing_window_deg=15.0,
            wall_search_timeout=4, table_capacity=64, promote_count=5,
            ref_compat=False, dtype=torch.float32),
        seed=1, device=dev)
    carry, outs = sess.run(traj.odom, traj.ranges, traj.beam_angles)

    # fuse every scan at its SLAM-estimated pose
    half = 8.0
    size = int(2 * half / args.resolution)
    grid = init_grid(size, size, args.resolution, origin=(-half, -half),
                     device=dev)
    grid = map_session(grid, outs.pose, traj.ranges, traj.beam_angles)

    prob = occupancy_probability(grid)
    occupied = int((prob > 0.7).sum())
    free = int((prob < 0.3).sum())
    unknown = prob.numel() - occupied - free
    print(f"grid {size}x{size} @ {args.resolution} m: "
          f"occupied={occupied} free={free} unknown={unknown}")
    # the simulated room's walls should be mapped as a closed loop of
    # occupied cells around a free interior
    assert occupied > 0 and free > occupied
    print(f"landmarks={int(carry.filt.n_active)}  "
          f"wall cells trace the {4.0 * 2}x{3.0 * 2} m room")

    if args.out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.imshow(prob.cpu().numpy(), origin="lower", cmap="gray_r",
                  extent=[-half, half, -half, half], vmin=0, vmax=1)
        est = outs.pose.double().cpu().numpy()
        ax.plot(est[:, 0], est[:, 1], "c-", lw=1.2, label="estimated path")
        lm = carry.filt.landmarks.double().cpu().numpy()
        act = carry.filt.active.cpu().numpy()
        if act.any():
            ax.plot(lm[act, 0], lm[act, 1], "r+", ms=10, label="landmarks")
        ax.set_title("occupancy grid from SLAM-estimated poses\n"
                     "(the working form of SLAM.m:118-124's dead path)")
        ax.legend(loc="upper right")
        fig.savefig(args.out, dpi=110, bbox_inches="tight")
        plt.close(fig)
        print(f"map -> {args.out}")
    return 0


if __name__ == "__main__":
    main()
