"""Batched data association, maximum-likelihood gating (counterpart of
ekf_slam_tpu/ops/association.py; Correspondence.m:49-87).

The gate is computed for all K landmark slots at once: Φ_k touches only
P's pose block, the pose↔landmark strip and the per-landmark 2×2 diagonal
blocks, so the whole [M,K] cost plane is a handful of elementwise passes
over [K]- and [M,K]-shaped tensors — one strip read of P.

``gate`` associates one measurement at a time (the sequential filter,
models/ekf.measure): O(K) elementwise work and the same strip reads.

``gate_batch(use_pallas=True)`` takes the cost plane from the fused gate
kernel instead (ops/gating.py, the JAX package's gating.gate_costs_pallas),
with that kernel's narrower contract: one launch that reads the state
itself.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ASSOC_ML, ASSOC_ML_UNIQUE, EKFParams, rounded
from .angles import atan2d, wrap_to_180, wrap_to_360
from .gating import gate_costs_state


def _exclusive(is_new: torch.Tensor, slot: torch.Tensor,
               best_cost: torch.Tensor, K: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """association='ml_unique': each slot accepts only its lowest-cost
    claimant (two scatter-mins; ties go to the lowest observation index).
    Returns (is_new, slot, losers)."""
    M = slot.shape[0]
    dev = slot.device
    idx = slot.to(torch.int64)
    claim = torch.where(is_new, float("inf"), best_cost)            # [M]
    claimed = torch.full((K,), float("inf"), dtype=best_cost.dtype,
                         device=dev).scatter_reduce(0, idx, claim, "amin")
    arange = torch.arange(M, device=dev, dtype=torch.int32)
    midx = torch.where(~is_new & (claim == claimed[idx]), arange, M)
    claimed_m = torch.full((K,), M, dtype=torch.int32,
                           device=dev).scatter_reduce(0, idx, midx, "amin")
    winner = ~is_new & (arange == claimed_m[idx])
    losers = ~is_new & ~winner
    return ~winner, slot, losers


def _lm_diag_blocks(P: torch.Tensor, K: int) -> torch.Tensor:
    """Per-landmark 2×2 diagonal blocks of P as [K,2,2], read from three
    diagonal strips."""
    end = 3 + 2 * K
    d0 = torch.diagonal(P)
    d1 = torch.diagonal(P, 1)
    dm = torch.diagonal(P, -1)
    p00, p11 = d0[3:end:2], d0[4:end:2]
    p01, p10 = d1[3:end:2], dm[3:end:2]
    return torch.stack([torch.stack([p00, p01], -1),
                        torch.stack([p10, p11], -1)], dim=1)


def _phi_base(A: torch.Tensor, B: torch.Tensor, Prr: torch.Tensor,
              Prl: torch.Tensor, Pll: torch.Tensor) -> torch.Tensor:
    """Φ0_k = A·Prr·Aᵀ + A·Prl·Bᵀ + B·Prlᵀ·Aᵀ + B·Pll·Bᵀ as [K,2,2],
    unrolled over the tiny (2,3) dims into [K]-vector mul-adds (same
    summation order as the JAX package)."""
    def accum(i, j):
        s = sum(A[:, i, p] * Prr[p, q] * A[:, j, q]
                for p in range(3) for q in range(3))
        s = s + sum(A[:, i, p] * Prl[:, p, q] * B[:, j, q]
                    for p in range(3) for q in range(2))
        s = s + sum(B[:, i, p] * Prl[:, q, p] * A[:, j, q]
                    for p in range(2) for q in range(3))
        s = s + sum(B[:, i, p] * Pll[:, p, q] * B[:, j, q]
                    for p in range(2) for q in range(2))
        return s

    return torch.stack([
        torch.stack([accum(0, 0), accum(0, 1)], dim=-1),
        torch.stack([accum(1, 0), accum(1, 1)], dim=-1),
    ], dim=1)


def _slot_geometry(state) -> Tuple[torch.Tensor, ...]:
    """Per-slot predicted measurement and Jacobian blocks, all K slots at
    once (Correspondence.m:49-63): (ẑ_r [K], ẑ_φ [K], A [K,2,3],
    B [K,2,2]); empty slots (q = 0) are guarded to stay finite."""
    x = state.x
    delta = state.landmarks - x[:2]
    q = (delta * delta).sum(-1)
    q = torch.where(q == 0, torch.ones_like(q), q)
    sq = torch.sqrt(q)
    dx, dy = delta[:, 0], delta[:, 1]
    zhat_phi = wrap_to_360(atan2d(dy, dx) - x[2])
    zero = torch.zeros_like(q)
    A = torch.stack([
        torch.stack([-sq * dx, -sq * dy, zero], dim=-1),
        torch.stack([dy, -dx, -q], dim=-1),
    ], dim=1) / q[:, None, None]
    B = torch.stack([
        torch.stack([sq * dx, sq * dy], dim=-1),
        torch.stack([-dy, dx], dim=-1),
    ], dim=1) / q[:, None, None]
    return sq, zhat_phi, A, B


def _strips(P: torch.Tensor, K: int):
    """(Prr [3,3], Prl [K,3,2], Pll [K,2,2]) read from a dense P."""
    end = 3 + 2 * K
    Prl = P[:3, 3:end].reshape(3, K, 2).permute(1, 0, 2)
    return P[:3, :3], Prl, _lm_diag_blocks(P, K)


def _chol_cost(s00, s10, s11, n0, n1, dt) -> torch.Tensor:
    """ν'Φ⁻¹ν = ‖L⁻¹ν‖² by 2×2 forward substitution: stable for the
    strongly anisotropic fit R, where the det form cancels in f32
    (association.py:147-157, 222-235)."""
    tiny = torch.finfo(dt).tiny
    l00 = torch.sqrt(torch.clamp(s00, min=tiny))
    l10 = s10 / l00
    l11 = torch.sqrt(torch.clamp(s11 - l10 * l10, min=tiny))
    y0 = n0 / l00
    y1 = (n1 - l10 * y0) / l11
    return y0 * y0 + y1 * y1


def gate_costs(state, z: torch.Tensor, R2: torch.Tensor, params: EKFParams
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot (position_cost [K], signature_cost [K]) of one
    measurement z = [r, φ, signature] with noise R2 [2,2]
    (Correspondence.m:49-75 over all K slots; JAX association.py:98-163).
    Inactive slots are left to the caller to mask."""
    x = state.x
    zhat_r, zhat_phi, A, B = _slot_geometry(state)
    n0 = z[0] - zhat_r
    n1 = z[1] - zhat_phi
    if not params.ref_compat:
        n1 = wrap_to_180(n1)
    Phi = (_phi_base(A, B, *_strips(state.P, state.capacity))
           + R2[None].to(x.dtype))                               # [K,2,2]
    if params.noise_model == "fit":
        position_cost = _chol_cost(Phi[:, 0, 0], Phi[:, 1, 0], Phi[:, 1, 1],
                                   n0, n1, x.dtype)
    else:
        # ν'Φ⁻¹ν through the explicit 2×2 inverse (Correspondence.m:69)
        det = Phi[:, 0, 0] * Phi[:, 1, 1] - Phi[:, 0, 1] * Phi[:, 1, 0]
        inv00, inv11 = Phi[:, 1, 1] / det, Phi[:, 0, 0] / det
        inv01, inv10 = -Phi[:, 0, 1] / det, -Phi[:, 1, 0] / det
        position_cost = (n0 * (inv00 * n0 + inv01 * n1)
                         + n1 * (inv10 * n0 + inv11 * n1))
    sc = rounded(params.s_cost, x.dtype)
    signature_cost = (z[2] - state.sig) ** 2 / sc                # :71
    return position_cost, signature_cost


def gate(state, z: torch.Tensor, R2: torch.Tensor, params: EKFParams
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Associate one measurement z: (is_new, slot, cost [K]), all on the
    device (Correspondence.m:78-86).  A slot associates iff its cost ≤
    s_thresh (held in the cost's dtype, as jnp.asarray holds it; an
    overflowed +inf cost never passes); among passing slots the first
    minimum wins, and with none passing the slot is 0 (torch.argmin, as
    jnp.argmin, returns the first minimum).  ml_unique's exclusion is a
    batch concept: one observation gates as under plain ML."""
    position_cost, signature_cost = gate_costs(state, z, R2, params)
    if params.association in (ASSOC_ML, ASSOC_ML_UNIQUE):
        # the intent the reference commented out (Correspondence.m:74)
        cost = position_cost + signature_cost
    else:
        cost = signature_cost                  # shipped behaviour (:75)
    inf = float("inf")
    cost = torch.where(state.active, cost, inf)
    passes = cost <= rounded(params.s_thresh, cost.dtype)
    is_new = ~passes.any()
    slot = torch.argmin(torch.where(passes, cost, inf)).to(torch.int32)
    return is_new, slot, cost


def batch_costs(state, zs: torch.Tensor, Rs: torch.Tensor,
                params: EKFParams, strips=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [M,K] gate cost planes (position_cost, signature_cost).

    position_cost[m,k] = ν'Φ⁻¹ν of observation m against slot k, with
    Φ_mk = Φ0_k + R_m: the P-dependent Φ0 is assembled once, each
    measurement adds its own R.  ``strips``: optional precomputed
    (Prr [3,3], Prl [K,3,2], Pll [K,2,2]) in place of reading P."""
    x = state.x
    zhat_r, zhat_phi, A, B = _slot_geometry(state)
    n0 = zs[:, 0:1] - zhat_r[None, :]                               # [M,K]
    n1 = zs[:, 1:2] - zhat_phi[None, :]                             # [M,K]
    if not params.ref_compat:
        n1 = wrap_to_180(n1)
    if strips is None:
        strips = _strips(state.P, state.capacity)
    Phi0 = _phi_base(A, B, *strips)                                 # [K,2,2]

    Rt = Rs.to(x.dtype)
    s00 = Phi0[None, :, 0, 0] + Rt[:, None, 0, 0]                   # [M,K]
    s11 = Phi0[None, :, 1, 1] + Rt[:, None, 1, 1]
    s01 = Phi0[None, :, 0, 1] + Rt[:, None, 0, 1]
    s10 = Phi0[None, :, 1, 0] + Rt[:, None, 1, 0]
    if params.noise_model == "fit":
        position_cost = _chol_cost(s00, s10, s11, n0, n1, x.dtype)
    else:
        det = s00 * s11 - s01 * s10
        position_cost = (n0 * (s11 * n0 - s01 * n1)
                         + n1 * (-s10 * n0 + s00 * n1)) / det       # [M,K]

    sc = rounded(params.s_cost, x.dtype)
    signature_cost = (zs[:, 2:3] - state.sig[None, :]) ** 2 / sc     # [M,K]
    return position_cost, signature_cost


def gate_batch(state, zs: torch.Tensor, Rs: torch.Tensor, params: EKFParams,
               use_pallas: bool = False, strips=None,
               return_losers: bool = False) -> Tuple[torch.Tensor, ...]:
    """Associate M measurements at once: (is_new [M], slot [M]) and, with
    ``return_losers``, the bool[M] mask of ml_unique observations that
    lost their slot to a lower-cost claimant (all-False otherwise).

    A slot associates iff its cost ≤ s_thresh; among passing slots the
    first minimum wins (torch.argmin returns the first occurrence, as
    jnp.argmin does, Correspondence.m:78-86).

    ``use_pallas``: the [M,K] costs come from the fused gate kernel
    (ops/gating.gate_costs_state: the kernel on CUDA tensors, its plain
    version on CPU tensors) instead of ``batch_costs``."""
    if use_pallas:
        # the fused gate kernel (ops/gating.py), held to the JAX branch
        # (association.py:273-294): position + signature cost whatever
        # params.association says, R's diagonal only, the det form,
        # +inf from the kernel in inactive slots; ``strips`` is ignored.
        # On CUDA one launch reads x, P, the landmark table and Rs as
        # they lie: no torch op between the state and the kernel.
        cost = gate_costs_state(state.x, state.P, state.landmarks,
                                state.sig, state.active, zs, Rs,
                                params.s_cost,
                                wrap_innovation=not params.ref_compat)
    else:
        position_cost, signature_cost = batch_costs(state, zs, Rs, params,
                                                    strips=strips)
        if params.association in (ASSOC_ML, ASSOC_ML_UNIQUE):
            cost = position_cost + signature_cost
        else:
            cost = signature_cost
        cost = torch.where(state.active[None, :], cost, float("inf"))
    return _decide(cost, state.capacity, params, return_losers)


def _decide(cost: torch.Tensor, K: int, params: EKFParams,
            return_losers: bool) -> Tuple[torch.Tensor, ...]:
    """Gate decisions from the [M,K] cost plane (+inf where inactive)."""
    inf = float("inf")
    passes = cost <= params.s_thresh
    is_new = ~passes.any(dim=1)
    slot = torch.argmin(torch.where(passes, cost, inf),
                        dim=1).to(torch.int32)
    if params.association == ASSOC_ML_UNIQUE:
        best = cost.gather(1, slot[:, None].to(torch.int64))[:, 0]
        out = _exclusive(is_new, slot, best, K)
        return out if return_losers else out[:2]
    if return_losers:
        return is_new, slot, torch.zeros_like(is_new)
    return is_new, slot

