"""Deterministic differential-drive simulator (counterpart of
ekf_slam_tpu/sim/world.py): wall-segment worlds, ray-cast range scans with
noise, dead-reckoned odometry with drift, and the large-world campaign's
helpers (the multi-room floorplan, its coverage route and controls, the
ground-truth landmark feet, map accuracy and the SE(2) alignment).

Noise comes from an explicit ``torch.Generator``, so a run is
reproducible from its seed (it does not reproduce the JAX package's
threefry noise; parity tests feed both packages the same arrays instead).
The large-world helpers are host-side numpy in the JAX package and stay
numpy here, line for line, so they agree with it to the bit; only the
worlds they build are torch tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
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


def world_with_obstacles(half_w: float = 4.0, half_h: float = 3.0,
                         boxes: Tuple = (), dtype=torch.float32,
                         device=None) -> World:
    """Rectangular room plus axis-aligned box obstacles
    ((cx, cy, half_side), ...)."""
    segs = [[-half_w, -half_h, half_w, -half_h],
            [half_w, -half_h, half_w, half_h],
            [half_w, half_h, -half_w, half_h],
            [-half_w, half_h, -half_w, -half_h]]
    for (cx, cy, r) in boxes:
        segs += [[cx - r, cy - r, cx + r, cy - r],
                 [cx + r, cy - r, cx + r, cy + r],
                 [cx + r, cy + r, cx - r, cy + r],
                 [cx - r, cy + r, cx - r, cy - r]]
    return World(segments=torch.tensor(segs, dtype=dtype,
                                       device=resolve_device(device)))


def floorplan_world(nx: int, ny: int, seed: int = 0, room: float = 8.0,
                    door: float = 1.8, wall_jitter_deg: float = 4.0,
                    base_angle_deg: float = 45.0, boxes: bool = True,
                    box_half: float = 1.0, dtype=torch.float32,
                    device=None) -> World:
    """Large multi-room floorplan: an nx × ny grid of ``room``-sized rooms
    with a centred doorway in every interior wall and one box obstacle per
    room (``boxes``), centred on the world origin; a 16 × 16 grid carries
    ~2,000 wall segments.  Every segment is rotated about its midpoint by
    a small random jitter (collinear grid walls become distinct infinite
    lines, so distinct landmark feet), and the whole world by
    ``base_angle_deg`` (no near-vertical wall for the y = m·x + b fit).
    Deterministic in ``seed`` (numpy, as in the JAX package)."""
    rng = np.random.default_rng(seed)
    W, H = nx * room, ny * room
    x0, y0 = -W / 2.0, -H / 2.0
    segs = []

    def add_wall(xa, ya, xb, yb, with_door):
        if not with_door:
            segs.append((xa, ya, xb, yb))
            return
        # centred door gap of width ``door`` along the wall
        ex, ey = xb - xa, yb - ya
        L = float(np.hypot(ex, ey))
        f0 = (L - door) / (2 * L)
        f1 = (L + door) / (2 * L)
        segs.append((xa, ya, xa + f0 * ex, ya + f0 * ey))
        segs.append((xa + f1 * ex, ya + f1 * ey, xb, yb))

    # horizontal wall rows j=0..ny (interior rows get doors)
    for j in range(ny + 1):
        y = y0 + j * room
        for i in range(nx):
            add_wall(x0 + i * room, y, x0 + (i + 1) * room, y,
                     with_door=0 < j < ny)
    # vertical wall columns i=0..nx
    for i in range(nx + 1):
        x = x0 + i * room
        for j in range(ny):
            add_wall(x, y0 + j * room, x, y0 + (j + 1) * room,
                     with_door=0 < i < nx)
    # one box obstacle per room, jittered off-centre so it never blocks
    # the door axes through the room centre
    if boxes:
        for j in range(ny):
            for i in range(nx):
                cx = x0 + (i + 0.5) * room + rng.uniform(1.2, 2.0) * (
                    1 if rng.random() < 0.5 else -1)
                cy = y0 + (j + 0.5) * room + rng.uniform(1.2, 2.0) * (
                    1 if rng.random() < 0.5 else -1)
                r = box_half
                segs += [(cx - r, cy - r, cx + r, cy - r),
                         (cx + r, cy - r, cx + r, cy + r),
                         (cx + r, cy + r, cx - r, cy + r),
                         (cx - r, cy + r, cx - r, cy - r)]

    segs = np.asarray(segs, np.float64)                        # [S,4]
    # per-segment jitter rotation about the midpoint
    mid = 0.5 * (segs[:, :2] + segs[:, 2:])
    ang = np.deg2rad(rng.normal(0.0, wall_jitter_deg, len(segs)))
    ca, sa = np.cos(ang), np.sin(ang)

    def rot_about(p, c):
        d = p - c
        return np.stack([c[:, 0] + ca * d[:, 0] - sa * d[:, 1],
                         c[:, 1] + sa * d[:, 0] + ca * d[:, 1]], -1)

    p1 = rot_about(segs[:, :2], mid)
    p2 = rot_about(segs[:, 2:], mid)
    # global base rotation about the world origin
    b = np.deg2rad(base_angle_deg)
    Rb = np.array([[np.cos(b), -np.sin(b)], [np.sin(b), np.cos(b)]])
    p1, p2 = p1 @ Rb.T, p2 @ Rb.T
    return World(segments=torch.as_tensor(
        np.concatenate([p1, p2], -1), dtype=dtype,
        device=resolve_device(device)))


def _segments_f64(world: World) -> np.ndarray:
    return world.segments.detach().cpu().double().numpy()


def true_feet(world: World) -> np.ndarray:
    """Ground-truth landmark positions [S,2]: the perpendicular foot from
    the world origin to each segment's infinite line, the feature the
    extractor maps (RANSAC.m:220)."""
    segs = _segments_f64(world)
    p1, e = segs[:, :2], segs[:, 2:] - segs[:, :2]
    t = -np.sum(p1 * e, -1) / np.maximum(np.sum(e * e, -1), 1e-12)
    return p1 + t[:, None] * e


def cluster_feet(feet: np.ndarray, radius: float = 0.5) -> np.ndarray:
    """Greedy clustering of ground-truth feet: feet closer than
    ``radius`` are one effective landmark (the extractor's association
    radius cannot tell them apart).  Returns the [C,2] representatives."""
    reps = []
    left = feet.copy()
    while len(left):
        c = left[0]
        d = np.hypot(left[:, 0] - c[0], left[:, 1] - c[1])
        reps.append(left[d < radius].mean(axis=0))
        left = left[d >= radius]
    return np.asarray(reps)


def map_accuracy(est_landmarks: np.ndarray, gt_feet: np.ndarray,
                 tol: float = 0.5) -> dict:
    """Match estimated landmarks to ground-truth feet within ``tol``:
    {n_gt, n_est, n_matched (gt feet with ≥ 1 estimate in tol), mean_err
    (over matched nearest pairs), n_spurious (estimates with no gt foot
    within tol)}."""
    if len(est_landmarks) == 0:
        return {"n_gt": int(len(gt_feet)), "n_est": 0, "n_matched": 0,
                "mean_err": float("nan"), "n_spurious": 0}
    d = np.hypot(est_landmarks[:, None, 0] - gt_feet[None, :, 0],
                 est_landmarks[:, None, 1] - gt_feet[None, :, 1])  # [E,G]
    nearest = d.min(axis=0)                                       # per gt
    matched = nearest < tol
    spurious = d.min(axis=1) >= tol
    return {
        "n_gt": int(len(gt_feet)),
        "n_est": int(len(est_landmarks)),
        "n_matched": int(matched.sum()),
        "mean_err": float(nearest[matched].mean()) if matched.any()
        else float("nan"),
        "n_spurious": int(spurious.sum()),
    }


def map_accuracy_lines(est_landmarks: np.ndarray, world: World,
                       tol: float = 0.5, margin: float = 3.0) -> dict:
    """Frame-agnostic map accuracy: estimated landmarks matched to wall
    lines (within ``tol`` perpendicular, within ``margin`` beyond the
    segment's ends along the line) instead of to world-origin feet.
    Returns {n_walls, n_covered, n_est, n_spurious, mean_err}."""
    segs = _segments_f64(world)
    if len(est_landmarks) == 0:
        return {"n_walls": int(len(segs)), "n_covered": 0, "n_est": 0,
                "n_spurious": 0, "mean_err": float("nan")}
    p = np.asarray(est_landmarks, np.float64)
    a, b = segs[:, :2], segs[:, 2:]
    e = b - a
    L = np.maximum(np.hypot(e[:, 0], e[:, 1]), 1e-9)
    u = e / L[:, None]
    rel = p[:, None, :] - a[None, :, :]                     # [E,S,2]
    t = np.einsum("esk,sk->es", rel, u)                     # along-line
    perp = np.abs(rel[..., 0] * u[None, :, 1]
                  - rel[..., 1] * u[None, :, 0])            # [E,S]
    near = (perp < tol) & (t > -margin) & (t < L[None, :] + margin)
    covered = near.any(axis=0)
    spurious = ~near.any(axis=1)
    perr = np.where(near, perp, np.inf).min(axis=1)
    ok = np.isfinite(perr)
    return {
        "n_walls": int(len(segs)),
        "n_covered": int(covered.sum()),
        "n_est": int(len(p)),
        "n_spurious": int(spurious.sum()),
        "mean_err": float(perr[ok].mean()) if ok.any() else float("nan"),
    }


def serpentine_waypoints(nx: int, ny: int, room: float = 8.0,
                         base_angle_deg: float = 45.0) -> np.ndarray:
    """Coverage route for ``floorplan_world``: room centres in serpentine
    order with the shared door's midpoint between consecutive rooms,
    rotated by the world's base angle.  Returns waypoints [N,2]."""
    W, H = nx * room, ny * room
    x0, y0 = -W / 2.0, -H / 2.0
    centers = []
    for j in range(ny):
        cols = range(nx) if j % 2 == 0 else range(nx - 1, -1, -1)
        for i in cols:
            centers.append((x0 + (i + 0.5) * room, y0 + (j + 0.5) * room))
    pts = [centers[0]]
    for a, b in zip(centers[:-1], centers[1:]):
        pts.append(((a[0] + b[0]) / 2.0, (a[1] + b[1]) / 2.0))  # door
        pts.append(b)
    pts = np.asarray(pts, np.float64)
    rad = np.deg2rad(base_angle_deg)
    Rb = np.array([[np.cos(rad), -np.sin(rad)],
                   [np.sin(rad), np.cos(rad)]])
    return pts @ Rb.T


def waypoint_controls(waypoints: np.ndarray, step: float = 0.25,
                      max_turn_deg: float = 9.0, tol: float = 0.8,
                      max_ticks: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-pursuit control rows (dD, dTheta) [T,2] driving the unicycle
    (``unicycle_step`` kinematics, degrees) through ``waypoints``;
    ``max_ticks`` pads (stand-still) or truncates to a fixed T.  Also
    returns the start pose [3]."""
    wp = np.asarray(waypoints, np.float64)
    d0 = wp[1] - wp[0]
    pose = np.array([wp[0][0], wp[0][1],
                     np.rad2deg(np.arctan2(d0[1], d0[0]))])
    start = pose.copy()
    controls = []
    k = 1
    while k < len(wp):
        if max_ticks is not None and len(controls) >= max_ticks:
            break
        tgt = wp[k]
        dx, dy = tgt[0] - pose[0], tgt[1] - pose[1]
        dist = np.hypot(dx, dy)
        if dist < tol:
            k += 1
            continue
        want = np.rad2deg(np.arctan2(dy, dx))
        diff = (want - pose[2] + 180.0) % 360.0 - 180.0
        dTh = float(np.clip(diff, -max_turn_deg, max_turn_deg))
        # slow through sharp turns so the arc stays near the door line
        dD = float(min(step, dist) * (0.35 if abs(diff) > 25 else 1.0))
        controls.append((dD, dTh))
        th = pose[2] + dTh
        pose[0] += dD * np.cos(np.deg2rad(th))
        pose[1] += dD * np.sin(np.deg2rad(th))
        pose[2] = (th + 360.0) % 360.0
    if max_ticks is not None and len(controls) < max_ticks:
        controls += [(0.0, 0.0)] * (max_ticks - len(controls))
    return np.asarray(controls, np.float64), start


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


def align_se2(est_xy: np.ndarray, truth_xy: np.ndarray):
    """Best rigid SE(2) transform (R, t) aligning est → truth (Umeyama
    without scale): a SLAM estimate is defined up to a global gauge.
    Returns (R [2,2], t [2]); apply as ``p @ R.T + t``."""
    a = np.asarray(est_xy, np.float64)
    b = np.asarray(truth_xy, np.float64)
    ca, cb = a.mean(0), b.mean(0)
    H = (a - ca).T @ (b - cb)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ np.diag([1.0, d]) @ U.T
    return R, cb - R @ ca


def ate_rmse(est_xy: torch.Tensor, truth_xy: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error (RMSE over positions)."""
    err = est_xy - truth_xy
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1)))
