"""Scan matching: fixed-iteration 2-D point-to-point ICP (counterpart of
ekf_slam_tpu/ops/icp.py).

Given two scans' points in their own frames, a validity mask each and an
initial guess, estimate the rigid transform that carries ``src`` onto
``dst``.  As in the JAX module: a fixed iteration count, the brute-force
[N,M] nearest-neighbour distances (no KD tree, no data-dependent shape),
masked correspondence rejection and the closed-form 2-D Procrustes step
(the rotation angle is atan2(Σ cross, Σ dot) of the centred pairs).

The JAX ``lax.scan`` over the iterations becomes a Python loop of
``iters`` steps that reads nothing back to the host.  Every 2×2 rotation
is written out elementwise, so no matrix product (and on CUDA no TF32
path, whatever ``torch.backends.cuda.matmul.allow_tf32`` says) touches
the points.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .angles import cosd, sind, wrap_to_180


class ICPResult(NamedTuple):
    pose: torch.Tensor       # f[3] (tx, ty, theta_deg): dst ≈ R(theta)·src + t
    rmse: torch.Tensor       # f    inlier RMS distance after alignment
    n_inliers: torch.Tensor  # i32  matched pairs within the threshold


def _rotate(c, s, px, py):
    """R(θ)·p for R = [[c, −s], [s, c]], elementwise: the two entries of
    ``p @ R.T`` (JAX ops/icp.py:30-33), each one product pair."""
    return px * c - py * s, px * s + py * c


def _transform(pts: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    c, s = cosd(pose[2]), sind(pose[2])
    qx, qy = _rotate(c, s, pts[:, 0], pts[:, 1])
    return torch.stack([qx, qy], dim=-1) + pose[:2]


def _sq_dists(cur: torch.Tensor, dst: torch.Tensor,
              dst_valid: torch.Tensor, big: float) -> torch.Tensor:
    """[N,M] squared distances in the difference form, ``big`` where the
    destination point is invalid."""
    dx = cur[:, None, 0] - dst[None, :, 0]
    dy = cur[:, None, 1] - dst[None, :, 1]
    return torch.where(dst_valid[None, :], dx * dx + dy * dy, big)


def icp(src: torch.Tensor, src_valid: torch.Tensor, dst: torch.Tensor,
        dst_valid: torch.Tensor, init_pose=None, iters: int = 20,
        max_pair_dist: float = 0.75) -> ICPResult:
    """Align ``src`` onto ``dst``: returns the pose with dst ≈ T(pose)·src.

    src [N,2] / dst [M,2] with validity masks (fixed shapes, padded).
    With no valid destination point every distance is ``big``, the
    nearest index is 0 (the first minimum, as ``jnp.argmin``), no pair is
    kept and the pose stays at ``init_pose``."""
    dt, dev = src.dtype, src.device
    if init_pose is None:
        init_pose = torch.zeros((3,), dtype=dt, device=dev)
    pose = torch.as_tensor(init_pose, device=dev).to(dt)
    big = 1e9
    for _ in range(iters):
        cur = _transform(src, pose)                            # [N,2]
        d2 = _sq_dists(cur, dst, dst_valid, big)
        d2min, nn = d2.min(dim=1)                              # first min
        nnd = torch.sqrt(d2min)
        w = (src_valid & (nnd < max_pair_dist)).to(dt)         # [N]
        tgt = dst[nn]                                          # [N,2]

        n = torch.clamp(w.sum(), min=1.0)
        mu_s = (cur * w[:, None]).sum(dim=0) / n
        mu_t = (tgt * w[:, None]).sum(dim=0) / n
        cs = cur - mu_s
        ct = tgt - mu_t
        # optimal rotation: atan2 of the summed cross and dot products
        num = (w * (cs[:, 0] * ct[:, 1] - cs[:, 1] * ct[:, 0])).sum()
        den = (w * (cs[:, 0] * ct[:, 0] + cs[:, 1] * ct[:, 1])).sum()
        dth = torch.rad2deg(torch.atan2(num, den))
        c, s = cosd(dth), sind(dth)
        rx, ry = _rotate(c, s, mu_s[0], mu_s[1])
        tx, ty = mu_t[0] - rx, mu_t[1] - ry
        # compose the increment onto the running pose
        px, py = _rotate(c, s, pose[0], pose[1])
        pose = torch.stack([px + tx, py + ty,
                            wrap_to_180(pose[2] + dth)]).to(dt)

    # final inlier statistics
    cur = _transform(src, pose)
    d2 = _sq_dists(cur, dst, dst_valid, big)
    nnd = torch.sqrt(d2.amin(dim=1))
    inl = src_valid & (nnd < max_pair_dist)
    n_in = inl.sum()
    rmse = torch.sqrt(torch.where(inl, nnd * nnd, 0.0).sum()
                      / torch.clamp(n_in, min=1))
    return ICPResult(pose=pose, rmse=rmse, n_inliers=n_in.to(torch.int32))
