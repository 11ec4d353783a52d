"""Laser-scan geometry: polar beams → cartesian → world frame
(counterpart of ekf_slam_tpu/ops/scan.py; RANSAC.m:96-106)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .angles import cosd, sind


class Scan(NamedTuple):
    ranges: torch.Tensor      # f[B]
    angles_deg: torch.Tensor  # f[B]
    valid: torch.Tensor       # bool[B]


def scan_from_ranges(ranges: torch.Tensor, angles_deg: torch.Tensor) -> Scan:
    """Mask NaN/inf/non-positive returns (RANSAC.m:96-97)."""
    valid = torch.isfinite(ranges) & (ranges > 0)
    return Scan(ranges=torch.where(valid, ranges, torch.zeros_like(ranges)),
                angles_deg=angles_deg, valid=valid)


def to_cartesian(scan: Scan) -> torch.Tensor:
    """Robot-frame cartesian points [B,2]."""
    return torch.stack([scan.ranges * cosd(scan.angles_deg),
                        scan.ranges * sind(scan.angles_deg)], dim=-1)


def to_world(points_local: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """rot(theta_deg)·p + [x, y] (RANSAC.m:103-106)."""
    th = pose[2]
    c, s = cosd(th), sind(th)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    # jnp promotes mixed dtypes here; torch.matmul needs them equal
    dt = torch.promote_types(points_local.dtype, rot.dtype)
    return points_local.to(dt) @ rot.T.to(dt) + pose[:2]


def scan_to_world(scan: Scan, pose: torch.Tensor) -> torch.Tensor:
    return to_world(to_cartesian(scan), pose)
