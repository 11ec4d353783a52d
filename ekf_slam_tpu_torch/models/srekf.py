"""Square-root (factor) EKF-SLAM pieces (counterpart of
ekf_slam_tpu/models/srekf.py): P = L·Lᵀ with the factor carried in the
state's P field, so P stays positive semi-definite at any precision.

Ported so far: what the general-factor session (models/srekf_fast.py)
runs — the dense ↔ factor conversions, QR re-triangularization, the O(D)
landmark append and the gate strips read from the factor.  The QR filter
itself (``update_mode='srekf'``: ``sr_predict``, ``sr_update_batch``,
``sr_measure_batched``) QRs a (D+1)×D and a (2M+D)² pre-array every tick
and is a later slice; its functions raise NotImplementedError.

The factor is updated in place where the JAX package returns a new one
(``sr_append``): a state passed in is consumed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import EKFParams
from ..ops.blocked_chol import chol_for_state
from ..state import FilterState
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


def _qr_filter(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"srekf.{name} (the QR square-root filter, update_mode='srekf') is "
        "not ported to ekf_slam_tpu_torch yet: it is the next slice; "
        "update_mode='srekf_fast' runs the general-factor filter")


def sr_predict(state, u, params):
    raise _qr_filter("sr_predict")


def sr_update_batch(state, zs, slots, Rs, valid, params):
    raise _qr_filter("sr_update_batch")


def sr_measure_batched(state, obs, u, params):
    raise _qr_filter("sr_measure_batched")
