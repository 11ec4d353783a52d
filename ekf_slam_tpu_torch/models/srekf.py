"""Square-root (factor) EKF-SLAM (counterpart of
ekf_slam_tpu/models/srekf.py): P = L·Lᵀ with the factor carried in the
state's P field, so P stays positive semi-definite at any precision.

Here: the dense ↔ factor conversions, the O(D) landmark append, the gate
strips read from the factor (also what the general-factor session,
models/srekf_fast.py, runs), and the QR filter (``update_mode='srekf'``):
``sr_predict`` and ``sr_update_batch`` re-triangularize by a Householder
QR of a (D+1)×D and a (2M+D)² pre-array every tick, O(D³), a
small-capacity mode (JAX config.py:123-125).  The QRs, the Cholesky of
the noise block and the triangular solve are library calls, as they are
XLA's in the JAX package; ``cholesky_ex`` does not read its info flag
back, so a tick does not sync.

QR's R is sign-ambiguous row by row: the new factor's columns are
sign-fixed (diag(L) ≥ 0, the canonical Cholesky factor), and the mean's
correction X₁₂ᵀ·X₁₁⁻ᵀν does not depend on the signs.

The factor is updated in place where the JAX package returns a new one
(``sr_append``): a state passed in is consumed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ASSOC_KNOWN, EKFParams
from ..ops.angles import cosd, sind, wrap_to_360
from ..ops.association import gate_batch
from ..ops.blocked_chol import chol_for_state
from ..ops.observations import ObsBatch
from ..state import FilterState
from . import ekf
from .batched import innovation_operator, noise_block
from .ekf import _jacobians


def factor_from_state(state: FilterState) -> FilterState:
    """Dense-P state → square-root state (P field holds L, P = L·Lᵀ) by
    the blocked Cholesky, inactive rows zero (srekf.py:54-65)."""
    return state._replace(P=chol_for_state(state.P, state.n_active))


def state_to_dense(state: FilterState) -> FilterState:
    """Square-root state → dense-P state (P = L·Lᵀ)."""
    return state._replace(P=state.P @ state.P.T)


def _retriangularize(pre: torch.Tensor, d: int) -> torch.Tensor:
    """Lower-triangular L [d,d] with L·Lᵀ = preᵀ·pre (``pre`` [n,d]) from
    the R of a QR, columns sign-fixed so diag(L) ≥ 0."""
    R = torch.linalg.qr(pre, mode="r")[1][:d, :]
    s = torch.where(torch.diagonal(R) < 0, -1.0, 1.0).to(R.dtype)
    return (R * s[:, None]).T


def _sign_fix(L: torch.Tensor) -> torch.Tensor:
    """Flip factor columns so diag(L) ≥ 0 (L·Lᵀ invariant)."""
    s = torch.where(torch.diagonal(L) < 0, -1.0, 1.0).to(L.dtype)
    return L * s[None, :]


def _chol2(Sym: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky of a 2×2 PSD matrix, guarded for the
    zero/degenerate case (masked lanes stay finite)."""
    tiny = torch.finfo(Sym.dtype).tiny
    l00 = torch.sqrt(torch.clamp(Sym[0, 0], min=tiny))
    l10 = Sym[1, 0] / l00
    l11 = torch.sqrt(torch.clamp(Sym[1, 1] - l10 * l10, min=tiny))
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z]), torch.stack([l10, l11])])


def sr_append(state: FilterState, u: torch.Tensor, R2: torch.Tensor,
              loc: torch.Tensor, signature, params: EKFParams,
              mask=None) -> FilterState:
    """Append a landmark into slot ``n_active`` of the factor (srekf.py:
    140-177): cross rows jxr·L[:3,:] and diagonal block chol₂ₓ₂(jz·R·jzᵀ).
    A no-op at capacity or where ``mask`` (a device bool) is False: the
    JAX ``lax.cond`` becomes a masked O(D) write at the device-side slot,
    as in models/ekf.append, with no host read.  L is updated in place."""
    x, L, K = state.x, state.P, state.capacity
    dt = L.dtype
    dev = L.device
    ok = state.n_active < K
    if mask is not None:
        ok = ok & mask
    jxr, jz = _jacobians(x, u, dt)
    Lr = jxr @ L[:3, :]                                  # [2, D] cross rows
    Ld = _chol2(jz @ R2.to(dt) @ jz.T)                   # [2, 2] diag factor

    slot = torch.clamp(state.n_active, max=K - 1).to(torch.int64)
    rows = 3 + 2 * slot + torch.arange(2, device=dev)    # [2]
    # the row pair, then the 2×2 diagonal block over it (srekf.py:167-168)
    L.index_copy_(0, rows, torch.where(ok, Lr, L.index_select(0, rows)))
    flat = (rows[:, None] * L.shape[1] + rows[None, :]).reshape(4)
    Lf = L.view(-1)
    Lf.index_copy_(0, flat, torch.where(ok, Ld.reshape(4),
                                        Lf.index_select(0, flat)))
    x = x.index_copy(0, rows, torch.where(ok, loc.to(x.dtype),
                                          x.index_select(0, rows)))
    one = slot.reshape(1)
    sig_new = torch.as_tensor(signature, dtype=state.sig.dtype, device=dev)
    sig = state.sig.index_copy(0, one, torch.where(
        ok, sig_new, state.sig.index_select(0, one)).reshape(1))
    active = state.active.index_copy(0, one, (
        ok | state.active.index_select(0, one)).reshape(1))
    return FilterState(x=x, P=L, sig=sig, active=active,
                       n_active=state.n_active + ok.to(torch.int32))


def sr_strips(L: torch.Tensor, K: int, triangular: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The P pieces the batched gate needs, read from the factor: (Prr
    [3,3], Prl [K,3,2], Pll [K,2,2]), no dense P.  ``triangular=False``:
    a general square root (models/srekf_fast.py), so the pose rows span all
    columns and the contractions run full width."""
    end = 3 + 2 * K
    w = 3 if triangular else L.shape[1]
    Lp = L[:3, :w]
    Prr = Lp @ Lp.T
    Prl = (Lp @ L[3:end, :w].T).reshape(3, K, 2).permute(1, 0, 2)
    d0 = (L * L).sum(dim=1)                              # diag of L·Lᵀ
    d1 = (L[:-1] * L[1:]).sum(dim=1)                     # first superdiagonal
    p00, p11 = d0[3:end:2], d0[4:end:2]
    p01 = d1[3:end:2]
    Pll = torch.stack([torch.stack([p00, p01], -1),
                       torch.stack([p01, p11], -1)], dim=1)
    return Prr, Prl, Pll


def _active_rows(state: FilterState, dt) -> torch.Tensor:
    """1 on the 3 + 2·n_active active rows, 0 below, as a [D,1] column."""
    D = state.x.shape[0]
    act = torch.arange(D, device=state.x.device) < 3 + 2 * state.n_active
    return act[:, None].to(dt)


def sr_predict(state: FilterState, u: torch.Tensor, params: EKFParams
               ) -> FilterState:
    """Square-root prediction (covariance math of EKF_SLAM.m:40-51; JAX
    srekf.py:95-128): P' = F·P·Fᵀ + c·W·Wᵀ, so L' is the re-triangularized
    QR of the (D+1)×D pre-array [(F·L)ᵀ; √c·Wᵀ], where F·L is L plus two
    row axpys.  Inactive rows of L' are multiplied by 0."""
    x, L = state.x, state.P
    dt = L.dtype
    th = x[2]
    dD, dTh = u[0], u[1]
    W = torch.stack([dD * cosd(th), dD * sind(th), dTh]).to(dt)
    # √c in L's dtype, as jnp.sqrt(jnp.asarray(c, dt)) rounds it; a
    # Python float, so no scalar goes to the device
    sqc = torch.tensor(params.c_process, dtype=dt).sqrt().item()
    wrow = torch.zeros((1, L.shape[0]), dtype=dt, device=L.device)
    wrow[0, :3] = sqc * W

    new_pose, f13, f23 = ekf.motion_model(x[:3], u, params.ref_compat)
    new_pose = torch.cat([new_pose[:2], wrap_to_360(new_pose[2:3])])
    x = torch.cat([new_pose.to(x.dtype), x[3:]])

    FL = L.clone()
    FL[0] += f13 * L[2]
    FL[1] += f23 * L[2]
    pre = torch.cat([FL.T, wrow], dim=0)                 # [(D+1), D]
    L = _retriangularize(pre, L.shape[0])
    return state._replace(x=x, P=L * _active_rows(state, dt))


def sr_update_batch(state: FilterState, zs: torch.Tensor,
                    slots: torch.Tensor, Rs: torch.Tensor,
                    valid: torch.Tensor, params: EKFParams) -> FilterState:
    """Joint square-root update of M observations (JAX srekf.py:184-224):
    the QR of the (2M+D)² pre-array [[chol(R)ᵀ, 0], [LᵀHᵀ, Lᵀ]] gives
    [[X₁₁, X₁₂], [0, L'ᵀ]] with X₁₁ᵀX₁₁ = HPHᵀ + R, X₁₂ᵀ = K·X₁₁ᵀ and
    L'L'ᵀ = P − K·S·Kᵀ; x += X₁₂ᵀ·(X₁₁⁻ᵀ·ν) without forming K.  Invalid
    rows have zero H columns, zero ν and an identity noise block."""
    x, L = state.x, state.P
    D = x.shape[0]
    M2 = 2 * zs.shape[0]
    dt = L.dtype

    Ht, nu = innovation_operator(x, zs, slots, valid, params, dt)
    # block-diagonal 2×2 noise: its Cholesky cannot fail on valid R
    sqR, _ = torch.linalg.cholesky_ex(noise_block(Rs, valid, dt))
    U = L.T @ Ht                                         # [D,2M] = (H·L)ᵀ
    pre = torch.cat([
        torch.cat([sqR.T, torch.zeros((M2, D), dtype=dt, device=L.device)],
                  dim=1),
        torch.cat([U, L.T], dim=1),
    ], dim=0)                                            # [(2M+D), (2M+D)]
    Rfac = torch.linalg.qr(pre, mode="r")[1]
    X11 = Rfac[:M2, :M2]                                 # upper, X11ᵀX11 = S
    X12 = Rfac[:M2, M2:]                                 # [2M, D]
    Lp = _sign_fix(Rfac[M2:, M2:].T)                     # lower, the new L
    y = torch.linalg.solve_triangular(X11.T, nu[:, None], upper=False)[:, 0]
    x = x + X12.T @ y
    return state._replace(x=x, P=Lp * _active_rows(state, dt))


def sr_measure_batched(state: FilterState, obs: ObsBatch, u: torch.Tensor,
                       params: EKFParams) -> FilterState:
    """Square-root counterpart of models/batched.measure_batched (JAX
    srekf.py:248-276): gate every observation against the prior factor's
    strips, one joint QR update, then the masked O(D) appends of the new
    landmarks in order.

    As in JAX, the gate returns no losers, so ``ml_losers='drop'`` is
    not honoured here: an ml_unique observation that loses its slot is
    appended as a new landmark (srekf_fast.sr_measure_fast drops it)."""
    zs = torch.stack([obs.rng, obs.bearing, obs.index.to(params.dtype)],
                     dim=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)
    if params.association == ASSOC_KNOWN:
        is_new = zs[:, 2] > state.n_active.to(params.dtype)
        slots = torch.clamp(obs.index - 1, 0, state.capacity - 1)
    else:
        is_new, slots = gate_batch(state, zs, Rs, params,
                                   strips=sr_strips(state.P,
                                                    state.capacity))
    is_new = is_new | (state.n_active == 0)

    state = sr_update_batch(state, zs, slots, Rs, obs.valid & ~is_new,
                            params)
    add = obs.valid & is_new
    for ii in range(zs.shape[0]):
        state = sr_append(state, u, Rs[ii], obs.loc[ii], zs[ii, 2], params,
                          mask=add[ii])
    return state
