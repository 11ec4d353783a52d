"""Live SLAM display loop (counterpart of examples/live_view.py): drive
the session tick by tick and paint the reference's per-tick elements
(robot glyph, landmark markers, covariance ellipses, candidates, scan
scatter; EKF_SLAM.m:154-234 called from SLAM.m:131-139): an interactive
window where a GUI backend exists, an animated GIF (``--gif``)
everywhere else.

Run:  python -m ekf_slam_tpu_torch.examples.live_view --ticks 40
          --gif slam_live.gif [--device cpu]
"""
import argparse
import sys

import torch

from ekf_slam_tpu_torch import viz
from ekf_slam_tpu_torch.config import (EKFParams, RansacParams, SimConfig,
                                       resolve_device)
from ekf_slam_tpu_torch.ops.scan import (scan_from_ranges, to_cartesian,
                                         to_world)
from ekf_slam_tpu_torch.session import SlamSession
from ekf_slam_tpu_torch.sim import world as W


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--gif", default=None,
                    help="record the live view as an animated GIF "
                         "(the headless form of the window)")
    ap.add_argument("--every", type=int, default=1,
                    help="draw every Nth tick")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = SimConfig(n_beams=720, max_range=12.0)
    room = W.rectangle_room(4.0, 3.0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    traj = W.simulate(room, W.circle_controls(args.ticks, 0.05, 3.0,
                                              device=dev), cfg, gen,
                      start_pose=(0.0, 0.0, 0.0))

    sess = SlamSession(
        algorithm="EKF_SLAM_UC",
        ekf_params=EKFParams(capacity=32, max_obs=8, ref_compat=False,
                             update_mode="batched", dtype=torch.float32),
        ransac_params=RansacParams(
            line_consensus=60, bearing_window_deg=15.0,
            wall_search_timeout=4, table_capacity=32, promote_count=5,
            ref_compat=False, dtype=torch.float32),
        seed=1, device=dev)
    carry = sess.init_carry(first_odom=traj.odom[0])

    view = viz.LiveView(gif_path=args.gif)
    for t in range(args.ticks):
        carry, out = sess.step(carry, traj.odom[t], traj.ranges[t],
                               traj.beam_angles)
        if t % args.every:
            continue
        scan = scan_from_ranges(traj.ranges[t], traj.beam_angles)
        sw = to_world(to_cartesian(scan), carry.filt.x[:3])
        view.update(carry.filt, table=carry.table, obs=out.obs,
                    scan_world=sw[scan.valid], truth=traj.truth[:t + 1])
    view.close()
    mode = "window" if view.interactive else "headless"
    print(f"live view: {view.frames} frames ({mode})"
          + (f", gif -> {args.gif}" if args.gif else ""))
    print(f"landmarks mapped: {int(carry.filt.n_active)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
