"""Deterministic differential-drive simulator (counterpart of the subset
of ekf_slam_tpu/sim/world.py that the session's smoke run needs): a
wall-segment world, ray-cast range scans with noise, and dead-reckoned
odometry with drift.  Noise comes from an explicit ``torch.Generator``,
so a run is reproducible from its seed (it does not reproduce the JAX
package's threefry noise; parity tests feed both packages the same
arrays instead)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SimConfig, resolve_device
from ..ops.angles import cosd, sind, wrap_to_360


class World(NamedTuple):
    """Wall segments [S,4] as (x1, y1, x2, y2)."""
    segments: torch.Tensor


def rectangle_room(half_w: float = 4.0, half_h: float = 3.0,
                   dtype=torch.float32, device=None) -> World:
    w, h = half_w, half_h
    return World(segments=torch.tensor(
        [[-w, -h, w, -h], [w, -h, w, h], [w, h, -w, h], [-w, h, -w, -h]],
        dtype=dtype, device=resolve_device(device)))


def raycast(world: World, pose: torch.Tensor, beam_angles_deg: torch.Tensor,
            max_range: float) -> torch.Tensor:
    """Ranges per beam (NaN where nothing is hit within max_range): the
    beam × segment ray-segment intersection, min over segments."""
    th = pose[2]
    wa = beam_angles_deg + th
    d = torch.stack([cosd(wa), sind(wa)], dim=-1)            # [B,2]
    p1 = world.segments[:, :2]                               # [S,2]
    e = world.segments[:, 2:] - p1                           # [S,2]
    rel = p1 - pose[:2]                                      # [S,2]
    # solve t*d - s*e = rel per (beam, segment)
    det = d[:, None, 0] * (-e[None, :, 1]) - d[:, None, 1] * (-e[None, :, 0])
    det_safe = torch.where(torch.abs(det) < 1e-12, 1.0, det)
    t = (rel[None, :, 0] * (-e[None, :, 1])
         - rel[None, :, 1] * (-e[None, :, 0])) / det_safe     # [B,S]
    s = (d[:, None, 0] * rel[None, :, 1]
         - d[:, None, 1] * rel[None, :, 0]) / det_safe        # [B,S]
    hit = (torch.abs(det) >= 1e-12) & (t > 1e-9) & (s >= 0.0) & (s <= 1.0)
    rng = torch.where(hit, t, torch.inf).min(dim=1).values
    return torch.where(rng <= max_range, rng, torch.nan)


class Trajectory(NamedTuple):
    truth: torch.Tensor        # f[T,3] ground-truth poses (deg)
    odom: torch.Tensor         # f[T,3] dead-reckoned odometry poses (deg)
    ranges: torch.Tensor       # f[T,B] scans (NaN = no return)
    beam_angles: torch.Tensor  # f[B]


def unicycle_step(pose: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One kinematic step, matching EKF_SLAM.m:58-60."""
    dD, dTh = u[0], u[1]
    th = pose[2]
    return torch.stack([
        pose[0] + dD * cosd(th + dTh),
        pose[1] + dD * sind(th + dTh),
        wrap_to_360(th + dTh),
    ])


def simulate(world: World, controls: torch.Tensor, cfg: SimConfig,
             generator: torch.Generator, start_pose=(0.0, 0.0, 0.0)
             ) -> Trajectory:
    """Run controls [T,2] = (dD, dTheta) rows through the world.  Odometry
    is truth plus integrated noise on each delta (SLAM.m:84-93); ranges
    carry Gaussian noise."""
    dev, dt = controls.device, cfg.dtype
    T = controls.shape[0]
    controls = controls.to(dt)
    beam_angles = torch.arange(cfg.n_beams, dtype=dt, device=dev) * (
        cfg.fov_deg / cfg.n_beams)
    odo_noise = torch.randn((T, 2), generator=generator, dtype=dt,
                            device=dev) * torch.tensor(
        [cfg.odom_xy_noise_std, cfg.odom_theta_noise_std], dtype=dt,
        device=dev)
    rng_noise = torch.randn((T, cfg.n_beams), generator=generator, dtype=dt,
                            device=dev) * cfg.range_noise_std
    pose = odom = torch.as_tensor(start_pose, dtype=dt, device=dev)
    truth, odoms, ranges = [], [], []
    for k in range(T):
        pose = unicycle_step(pose, controls[k])
        odom = unicycle_step(odom, controls[k] + odo_noise[k])
        truth.append(pose)
        odoms.append(odom)
        ranges.append(raycast(world, pose, beam_angles, cfg.max_range)
                      + rng_noise[k])
    return Trajectory(truth=torch.stack(truth), odom=torch.stack(odoms),
                      ranges=torch.stack(ranges), beam_angles=beam_angles)


def circle_controls(T: int, dD: float = 0.05, dTh: float = 2.0,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """A gentle loop trajectory (closes after 180/dTh ticks)."""
    return torch.tensor([dD, dTh], dtype=dtype,
                        device=resolve_device(device)).repeat(T, 1)


def ate_rmse(est_xy: torch.Tensor, truth_xy: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error (RMSE over positions)."""
    err = est_xy - truth_xy
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))
