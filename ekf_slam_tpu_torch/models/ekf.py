"""EKF-SLAM filter core: predict / append / innovation
(counterpart of ekf_slam_tpu/models/ekf.py; EKF_SLAM.m, EKF_SLAM_UC.m).

* **predict** — F differs from I in two entries (EKF_SLAM.m:62-64), so
  F·P·Fᵀ is two row axpys and two column axpys: O(D), written in place.
* **append** — a masked write into the padded state at the device-side
  slot ``n_active``: O(D) row/column writes, no host round trip and no
  full-P select.

All angles are degrees.  ``params.ref_compat`` reproduces the reference's
numeric quirks.  P is updated in place (the JAX session donates its carry,
session.py:134-143): a state passed in is consumed.  Mixed dtypes follow
jnp's promotion (an f32 scalar times a bf16 row computes in f32), so every
product with a narrow P is cast to the compute dtype explicitly.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..config import EKFParams, rounded
from ..ops.angles import atan2d, cosd, sind, wrap_to_360
from ..state import FilterState

_DEG = math.pi / 180.0


def motion_model(pose: torch.Tensor, u: torch.Tensor, ref_compat: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differential-drive motion model + the two nonzero Jacobian entries
    (EKF_SLAM.m:56-65; ref_compat keeps the pre-increment, degree-unaware
    Jacobian)."""
    th, dD, dTh = pose[2], u[0], u[1]
    new_pose = torch.stack([
        pose[0] + dD * cosd(th + dTh),
        pose[1] + dD * sind(th + dTh),
        th + dTh,
    ])
    if ref_compat:
        f13 = -dD * sind(th)
        f23 = dD * cosd(th)
    else:
        f13 = -dD * sind(th + dTh) * _DEG
        f23 = dD * cosd(th + dTh) * _DEG
    return new_pose, f13, f23


def predict(state: FilterState, u: torch.Tensor, params: EKFParams
            ) -> FilterState:
    """``P ← F P Fᵀ + Q`` (EKF_SLAM.m:40-51), P updated in place.

    Rows 0/1 pick up f·(row 2) first; column 2 is then read from the
    UPDATED P before columns 0/1 pick up f·(col 2) — the JAX order
    (ekf.py:109-114)."""
    x, P = state.x, state.P
    ct = x.dtype
    th = x[2]
    dD, dTh = u[0], u[1]

    Wv = torch.stack([dD * cosd(th), dD * sind(th), dTh])
    # jnp.asarray(c_process, P.dtype) rounds c to P's storage dtype first
    Qb = rounded(params.c_process, P.dtype) * torch.outer(Wv, Wv)
    if any(q > 0 for q in params.q_floor):
        for i, q in enumerate(params.q_floor):
            Qb[i, i] += rounded(q, P.dtype)

    new_pose, f13, f23 = motion_model(x[:3], u, params.ref_compat)
    new_pose = torch.cat([new_pose[:2], wrap_to_360(new_pose[2:3])])
    x = torch.cat([new_pose.to(x.dtype), x[3:]])

    row2 = P[2].to(ct)
    if params.masked_writes:
        # full-plane where-selects (the sharded-P form, ekf.py:92-107):
        # every write is elementwise and untouched entries are selected,
        # not added to
        D = P.shape[0]
        ridx = torch.arange(D, device=P.device)
        r = ridx[:, None]
        cidx = ridx[None, :]
        P = torch.where(r == 0, P + (f13 * row2[None, :]).to(P.dtype), P)
        P = torch.where(r == 1, P + (f23 * row2[None, :]).to(P.dtype), P)
        col2 = P[:, 2].to(ct)
        P = torch.where(cidx == 0, P + (f13 * col2[:, None]).to(P.dtype), P)
        P = torch.where(cidx == 1, P + (f23 * col2[:, None]).to(P.dtype), P)
        Qb_full = torch.zeros_like(P)
        Qb_full[:3, :3] = Qb.to(P.dtype)
        P = torch.where((r < 3) & (cidx < 3), P + Qb_full, P)
    else:
        P[0] += (f13 * row2).to(P.dtype)
        P[1] += (f23 * row2).to(P.dtype)
        # column 2 after the row writes; the column writes below leave it
        # alone, so a view is safe to read
        col2 = P[:, 2].to(ct)
        P[:, 0] += (f13 * col2).to(P.dtype)
        P[:, 1] += (f23 * col2).to(P.dtype)
        P[:3, :3] += Qb.to(P.dtype)
    return state._replace(x=x, P=P)


def _jacobians(x: torch.Tensor, u: torch.Tensor, ct):
    """Append Jacobians jxr [2,3] and jz [2,2] (EKF_SLAM.m:84-88; jz
    from (dD, dTheta) as the reference builds it)."""
    th = x[2]
    dD, dTh = u[0], u[1]
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    jxr = torch.stack([
        torch.stack([one, zero, (-dD * sind(th)).to(ct)]),
        torch.stack([zero, one, (dD * cosd(th)).to(ct)])])
    jz = torch.stack([
        torch.stack([cosd(dTh), -dD * sind(dTh)]),
        torch.stack([sind(dTh), dD * cosd(dTh)]),
    ]).to(ct)
    return jxr, jz


def append(state: FilterState, u: torch.Tensor, R2: torch.Tensor,
           loc: torch.Tensor, signature, params: EKFParams,
           mask=None) -> FilterState:
    """Append a landmark into slot ``n_active`` (EKF_SLAM.m:84-97), a
    no-op when the state is full or ``mask`` (a device bool) is False.

    The JAX ``lax.cond`` becomes a select on the slot's own rows: the new
    values are blended with what the slot holds, then written back with
    index_copy_ — O(D) work at a device-side index, no host sync and no
    pass over P.  P is updated in place."""
    x, P, K = state.x, state.P, state.capacity
    ct = x.dtype
    dev = P.device
    ok = state.n_active < K
    if mask is not None:
        ok = ok & mask
    jxr, jz = _jacobians(x, u, ct)

    if params.masked_writes:
        jxr_pad = torch.zeros((2, P.shape[0]), dtype=ct, device=dev)
        jxr_pad[:, :3] = jxr
        cross = (jxr_pad @ P.to(ct)).to(P.dtype)                 # [2, D]
        diag = (cross[:, :3].to(ct) @ jxr.T
                + jz @ R2.to(ct) @ jz.T).to(P.dtype)
    else:
        cross = (jxr @ P[:3, :].to(ct)).to(P.dtype)              # [2, D]
        diag = (jxr @ P[:3, :3].to(ct) @ jxr.T
                + jz @ R2.to(ct) @ jz.T).to(P.dtype)

    slot = torch.clamp(state.n_active, max=K - 1).to(torch.int64)
    rows = 3 + 2 * slot + torch.arange(2, device=dev)            # [2]
    # row pair, then column pair, then the 2×2 diagonal block — the
    # dynamic_update_slice order of ekf.py:185-187 (the masked_writes
    # where-select form of the JAX package writes the same values)
    P.index_copy_(0, rows, torch.where(ok, cross, P.index_select(0, rows)))
    P.index_copy_(1, rows,
                  torch.where(ok, cross.T, P.index_select(1, rows)))
    flat = (rows[:, None] * P.shape[1] + rows[None, :]).reshape(4)
    Pf = P.view(-1)
    Pf.index_copy_(0, flat, torch.where(ok, diag.reshape(4),
                                        Pf.index_select(0, flat)))
    x = x.index_copy(0, rows, torch.where(ok, loc.to(x.dtype),
                                          x.index_select(0, rows)))
    one = slot.reshape(1)
    sig_new = torch.as_tensor(signature, dtype=state.sig.dtype, device=dev)
    sig = state.sig.index_copy(0, one, torch.where(
        ok, sig_new, state.sig.index_select(0, one)).reshape(1))
    active = state.active.index_copy(0, one, (
        ok | state.active.index_select(0, one)).reshape(1))
    return FilterState(x=x, P=P, sig=sig, active=active,
                       n_active=state.n_active + ok.to(torch.int32))


def innovation(x: torch.Tensor, slot
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Predicted measurement ẑ and the measurement Jacobian blocks
    (EKF_SLAM_UC.m:125-139): returns (ẑ [...,2], A [...,2,3] pose block,
    B [...,2,2] landmark block) for a slot tensor of any shape."""
    slot = torch.as_tensor(slot, device=x.device).to(torch.int64)
    th = x[2]
    lm = x[(3 + 2 * slot)[..., None] + torch.arange(2, device=x.device)]
    delta = lm - x[:2]
    q = (delta * delta).sum(-1)
    # q = 0 only for padded/empty slots: keep masked lanes finite
    q = torch.where(q == 0, torch.ones_like(q), q)
    sq = torch.sqrt(q)
    dx, dy = delta[..., 0], delta[..., 1]
    zhat = torch.stack([sq, wrap_to_360(atan2d(dy, dx) - th)], dim=-1)
    zero = torch.zeros_like(q)
    A = torch.stack([
        torch.stack([-sq * dx, -sq * dy, zero], dim=-1),
        torch.stack([dy, -dx, -q], dim=-1),
    ], dim=-2) / q[..., None, None]
    B = torch.stack([
        torch.stack([sq * dx, sq * dy], dim=-1),
        torch.stack([-dy, dx], dim=-1),
    ], dim=-2) / q[..., None, None]
    return zhat, A, B


def _rc_floor(params: EKFParams, device) -> torch.Tensor:
    """diag(rc0², rc1²), filled in place (no host-to-device copy)."""
    R = torch.zeros((2, 2), dtype=params.dtype, device=device)
    R[0, 0] = params.rc[0] ** 2
    R[1, 1] = params.rc[1] ** 2
    return R


def measurement_noise(z: torch.Tensor, params: EKFParams) -> torch.Tensor:
    """R [2,2] for one row z = [r, phi, ...] (EKF_SLAM_UC.m:110 when
    noise_model='scaled'; diag(rc0², rc1²) otherwise)."""
    return measurement_noise_batch(z[None], params)[0]


def measurement_noise_batch(zs: torch.Tensor, params: EKFParams
                            ) -> torch.Tensor:
    """``measurement_noise`` over an [M,·] batch → [M,2,2]."""
    dt = params.dtype
    if params.noise_model in ("constant", "fit"):
        # 'fit' without an ObsBatch covariance degrades to the floor
        return _rc_floor(params, zs.device).expand(zs.shape[0], 2, 2)
    rc0, rc1 = rounded(params.rc[0], dt), rounded(params.rc[1], dt)
    return torch.diag_embed(torch.stack([zs[:, 0] * rc0, zs[:, 1] * rc1],
                                        dim=-1)).to(dt)


def obs_noise_batch(obs, zs: torch.Tensor, params: EKFParams
                    ) -> torch.Tensor:
    """Per-observation noise [M,2,2]: the extractor-propagated R plus the
    diag(rc0², rc1²) floor under noise_model='fit', else
    ``measurement_noise_batch``."""
    if params.noise_model == "fit" and obs.R is not None:
        return obs.R.to(params.dtype) + _rc_floor(params, zs.device)[None]
    return measurement_noise_batch(zs, params)
