"""EKF-SLAM filter core: predict / append / innovation
(counterpart of ekf_slam_tpu/models/ekf.py; EKF_SLAM.m, EKF_SLAM_UC.m).

* **predict** — F differs from I in two entries (EKF_SLAM.m:62-64), so
  F·P·Fᵀ is two row axpys and two column axpys: O(D), written in place.
* **append** — a masked write into the padded state at the device-side
  slot ``n_active``: O(D) row/column writes, no host round trip and no
  full-P select.
* **update** — the rank-2 correction P −= K·(HP) on the five rows and
  columns the observation touches (EKF_SLAM_UC.m:125-146): one pass over
  P.
* **measure** — the reference's per-observation chain
  (EKF_SLAM_UC.m:109-150): each observation gates against the state the
  previous one updated.  The JAX ``lax.cond`` on validity and novelty
  becomes masks: every row runs a masked update and a masked append, so
  a tick issues the same ops whatever the scan held and reads nothing
  back to the host.

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

from ..config import ASSOC_KNOWN, EKFParams, rounded
from ..ops.angles import atan2d, cosd, sind, wrap_to_180, wrap_to_360
from ..ops.association import gate
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


def pair_rows(slot, D: int, device) -> torch.Tensor:
    """The rows [3+2·slot, 4+2·slot] of landmark ``slot`` (an int or a
    tensor of any shape → [..., 2]), the start clamped into [0, D−2] as
    ``lax.dynamic_slice`` clamps it (ekf.py:219, 255, 259, 272): a slot
    past the last one reads the state's last row pair.  An int slot is
    clamped on the host, so no scalar is copied to the device."""
    two = torch.arange(2, device=device)
    if isinstance(slot, torch.Tensor):
        start = torch.clamp(3 + 2 * slot.to(torch.int64), 0, D - 2)
        return start[..., None] + two
    return min(max(3 + 2 * int(slot), 0), D - 2) + two


def innovation(x: torch.Tensor, slot
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Predicted measurement ẑ and the measurement Jacobian blocks
    (EKF_SLAM_UC.m:125-139): returns (ẑ [...,2], A [...,2,3] pose block,
    B [...,2,2] landmark block) for an int slot or a slot tensor of any
    shape (``pair_rows`` clamps it)."""
    th = x[2]
    lm = x[pair_rows(slot, x.shape[0], x.device)]
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


# ---------------------------------------------------------------------------
# Measurement update
# ---------------------------------------------------------------------------

#: elements of one row band of the narrow-storage and Joseph corrections
#: (64 Mi: 256 MB of f32 a band, so no second D×D buffer appears)
_BAND_ELEMS = 1 << 26


def _inv2(S: torch.Tensor) -> torch.Tensor:
    """Closed-form 2×2 inverse (the reference's phi^-1, EKF_SLAM_UC.m:144)."""
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    return torch.stack([torch.stack([S[1, 1], -S[0, 1]]),
                        torch.stack([-S[1, 0], S[0, 0]])]) / det


def _correct(P: torch.Tensor, Kg: torch.Tensor, HP: torch.Tensor,
             S: torch.Tensor, params: EKFParams, mask) -> None:
    """P ← P − Kg·HP, or the Joseph form P − KB − KBᵀ + Kg·S·Kgᵀ with
    KB = Kg·HP (ekf.py:273-279), in place.

    With P stored in its own dtype the plain form is one in-place
    ``addmm_``.  With a narrower storage dtype, or the Joseph form, the
    products and differences are formed in the compute dtype and rounded
    once into P, as the JAX expression is, row band by row band: each
    band needs only its own rows of P (HP was read before), so no second
    D×D buffer appears.  A masked-off row leaves the band as it was."""
    if P.dtype == Kg.dtype and not params.joseph:
        # Kg and HP are exactly 0 on a masked-off row: P − 0·0 is P
        P.addmm_(Kg, HP, alpha=-1)
        return
    D = P.shape[0]
    step = max(1, _BAND_ELEMS // D)
    KS = Kg @ S if params.joseph else None
    for r0 in range(0, D, step):
        r1 = min(D, r0 + step)
        band = P[r0:r1].to(Kg.dtype)
        new = band - Kg[r0:r1] @ HP
        if params.joseph:
            new = new - HP[:, r0:r1].T @ Kg.T + KS[r0:r1] @ Kg.T
        if mask is not None:
            new = torch.where(mask, new, band)
        P[r0:r1] = new.to(P.dtype)


def update(state: FilterState, z: torch.Tensor, slot, R2: torch.Tensor,
           params: EKFParams, mask=None) -> FilterState:
    """Kalman update against landmark ``slot`` (EKF_SLAM_UC.m:125-146):
    PHᵀ from P's pose columns and the slot's column pair, K = PHᵀ·Φ⁻¹,
    P ← P − K·(HP), in place (one pass over P).

    ``mask`` (a device bool) makes it a no-op where False, for the
    masked chain of ``measure``: Kg, ν and HP are selected to 0 and x is
    selected back, so a masked row leaves x and P bit-for-bit as they
    were even where Φ is singular (an empty slot's inverse is inf/NaN).
    ``slot`` is clamped as ``lax.dynamic_slice`` clamps it."""
    x, P = state.x, state.P
    ct = x.dtype
    dev = x.device
    zhat, A, B = innovation(x, slot)
    Hs = torch.cat([A, B], dim=1)                               # [2,5]
    idx = torch.cat([torch.arange(3, device=dev),
                     pair_rows(slot, x.shape[0], dev)])         # [5]

    # PHᵀ and HP are both read before P is written
    PHt = P.index_select(1, idx).to(ct) @ Hs.T                  # [D,2]
    S = Hs @ PHt.index_select(0, idx) + R2.to(ct)               # [2,2]
    Kg = PHt @ _inv2(S)                                         # [D,2]
    nu = z[:2].to(ct) - zhat
    if not params.ref_compat:
        # the reference never re-wraps the bearing innovation
        # (EKF_SLAM_UC.m:145); the correct mode does
        nu = torch.stack([nu[0], wrap_to_180(nu[1])])
    HP = Hs @ P.index_select(0, idx).to(ct)                     # [2,D]
    if mask is not None:
        Kg = torch.where(mask, Kg, 0.0)
        nu = torch.where(mask, nu, 0.0)
        HP = torch.where(mask, HP, 0.0)

    x_new = x + Kg @ nu
    x = x_new if mask is None else torch.where(mask, x_new, x)
    _correct(P, Kg, HP, S, params, mask)
    if params.symmetrize:
        # out of place: P + Pᵀ in place would read entries it already
        # wrote
        sym = 0.5 * (P + P.T)
        P.copy_(sym if mask is None else torch.where(mask, sym, P))
    return state._replace(x=x, P=P)


def measure(state: FilterState, obs, u: torch.Tensor, params: EKFParams
            ) -> FilterState:
    """One tick's observations in order (EKF_SLAM_UC.m:109-150; JAX
    ekf.py:335-377): each row is gated against the state the previous row
    left, then updates its slot or appends a new landmark.

    The JAX ``lax.cond`` pair becomes masks: every row runs ``update``
    masked by valid & ~new and ``append`` masked by valid & new, so the
    loop over ``max_obs`` rows issues the same ops every tick and reads
    nothing back to the host.  Every row pays its pass over P."""
    zs = torch.stack([obs.rng, obs.bearing, obs.index.to(params.dtype)],
                     dim=-1)
    # R scales with the measured values in the default 'scaled' model;
    # 'fit' adds the extractor's propagated R to the floor (ekf.py:349-351)
    Rs = obs_noise_batch(obs, zs, params)                       # [M,2,2]
    for ii in range(zs.shape[0]):
        z, R2 = zs[ii], Rs[ii]
        if params.association == ASSOC_KNOWN:
            # EKF_SLAM.m:118: new iff the carried id exceeds the landmark
            # count; the update indexes by the loop counter (the
            # EKF_SLAM.m:123 quirk) or by the id in correct mode
            is_new = z[2] > state.n_active.to(z.dtype)
            slot = ii if params.ref_compat else obs.index[ii] - 1
        else:
            is_new, slot, _ = gate(state, z, R2, params)
        # the first landmark is appended unconditionally
        # (EKF_SLAM_UC.m:112-113)
        is_new = is_new | (state.n_active == 0)
        valid = obs.valid[ii]
        state = update(state, z, slot, R2, params, mask=valid & ~is_new)
        state = append(state, u, R2, obs.loc[ii], z[2], params,
                       mask=valid & is_new)
    return state
