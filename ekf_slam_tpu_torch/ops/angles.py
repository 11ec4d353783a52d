"""Degree-valued trigonometry (counterpart of ekf_slam_tpu/ops/angles.py).

The reference does all its angle math in degrees (cosd/sind/atan2d/
wrapTo360, e.g. EKF_SLAM.m:42-65).  The wraps are plain arithmetic and
agree bit for bit with the JAX package; the trig calls go to PyTorch's
own cos/sin/atan kernels, which may differ from XLA's in the last ulp.
"""
from __future__ import annotations

import math

import torch

_DEG2RAD = math.pi / 180.0


def cosd(x):
    return torch.cos(x * _DEG2RAD)


def sind(x):
    return torch.sin(x * _DEG2RAD)


def tand(x):
    return torch.tan(x * _DEG2RAD)


def atand(x):
    """Two-quadrant arctangent in degrees (RANSAC.m:160-166 quirk)."""
    return torch.atan(x) / _DEG2RAD


def atan2d(y, x):
    """Four-quadrant arctangent in degrees, range (-180, 180]."""
    return torch.atan2(y, x) / _DEG2RAD


def _mod(x, m: float):
    """Floored modulo with jnp.mod's exact definition: C fmod, shifted by
    ``m`` where the remainder's sign differs from the divisor's."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def wrap_to_360(x):
    """MATLAB wrapTo360: positive multiples of 360 map to 360, everything
    else mod-360 into [0, 360)."""
    w = _mod(x, 360.0)
    return torch.where((w == 0.0) & (x > 0.0), 360.0, w)


def wrap_to_180(x):
    """Wrap to [-180, 180) (the innovation wrap the reference omits,
    EKF_SLAM_UC.m:145)."""
    return _mod(x + 180.0, 360.0) - 180.0


def angdiff_deg(a, b):
    """MATLAB angdiff(a, b) in degrees: (b - a) wrapped to [-180, 180)
    (SLAM.m:106)."""
    return wrap_to_180(b - a)
