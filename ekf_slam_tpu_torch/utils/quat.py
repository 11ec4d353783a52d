"""Quaternion helpers for odometry ingestion (counterpart of
ekf_slam_tpu/utils/quat.py).

The reference converts ROS odometry quaternions to yaw with
``quat2eul([w x y z])`` (SLAM.m:88-90) and ships a quaternion inverse
(quatInv.m:1-3); these let a quaternion-valued odometry source feed the
session's [x, y, theta_deg] seam.  Quaternions are [..., 4] tensors in
[w, x, y, z] order.
"""
from __future__ import annotations

import torch


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Quaternion inverse q* / |q|² (quatInv.m:2)."""
    conj = torch.cat([q[..., :1], -q[..., 1:]], dim=-1)
    return conj / torch.sum(q * q, dim=-1, keepdim=True)


def quat_to_yaw_deg(q: torch.Tensor) -> torch.Tensor:
    """Yaw (the Z rotation) in degrees: the first Euler angle of MATLAB
    quat2eul's default ZYX convention (SLAM.m:89-90)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.rad2deg(yaw)


def odom_pose_from_quat(position_xy: torch.Tensor, q: torch.Tensor
                        ) -> torch.Tensor:
    """[x, y, wrapTo360(yaw_deg)] as the reference builds odomPose
    (SLAM.m:84-93)."""
    yaw = torch.remainder(quat_to_yaw_deg(q), 360.0)
    return torch.cat([position_xy[..., :2], yaw[..., None]], dim=-1)
