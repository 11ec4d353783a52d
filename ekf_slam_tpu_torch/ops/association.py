"""Batched data association, maximum-likelihood gating (counterpart of
ekf_slam_tpu/ops/association.py; Correspondence.m:49-87).

The gate is computed for all K landmark slots at once: Φ_k touches only
P's pose block, the pose↔landmark strip and the per-landmark 2×2 diagonal
blocks, so the whole [M,K] cost plane is a handful of elementwise passes
over [K]- and [M,K]-shaped tensors — one strip read of P.

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


def batch_costs(state, zs: torch.Tensor, Rs: torch.Tensor,
                params: EKFParams, strips=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The [M,K] gate cost planes (position_cost, signature_cost).

    position_cost[m,k] = ν'Φ⁻¹ν of observation m against slot k, with
    Φ_mk = Φ0_k + R_m: the P-dependent Φ0 is assembled once, each
    measurement adds its own R.  ``strips``: optional precomputed
    (Prr [3,3], Prl [K,3,2], Pll [K,2,2]) in place of reading P."""
    x, P = state.x, state.P
    K = state.capacity
    th = x[2]

    lm = state.landmarks
    delta = lm - x[:2]
    q = (delta * delta).sum(-1)
    q = torch.where(q == 0, torch.ones_like(q), q)
    sq = torch.sqrt(q)
    dx, dy = delta[:, 0], delta[:, 1]

    zhat_r = sq
    zhat_phi = wrap_to_360(atan2d(dy, dx) - th)
    n0 = zs[:, 0:1] - zhat_r[None, :]                               # [M,K]
    n1 = zs[:, 1:2] - zhat_phi[None, :]                             # [M,K]
    if not params.ref_compat:
        n1 = wrap_to_180(n1)

    zero = torch.zeros_like(q)
    A = torch.stack([
        torch.stack([-sq * dx, -sq * dy, zero], dim=-1),
        torch.stack([dy, -dx, -q], dim=-1),
    ], dim=1) / q[:, None, None]
    B = torch.stack([
        torch.stack([sq * dx, sq * dy], dim=-1),
        torch.stack([-dy, dx], dim=-1),
    ], dim=1) / q[:, None, None]

    if strips is None:
        Prr = P[:3, :3]
        end = 3 + 2 * K
        Prl = P[:3, 3:end].reshape(3, K, 2).permute(1, 0, 2)
        Pll = _lm_diag_blocks(P, K)
    else:
        Prr, Prl, Pll = strips

    Phi0 = _phi_base(A, B, Prr, Prl, Pll)                           # [K,2,2]

    Rt = Rs.to(x.dtype)
    s00 = Phi0[None, :, 0, 0] + Rt[:, None, 0, 0]                   # [M,K]
    s11 = Phi0[None, :, 1, 1] + Rt[:, None, 1, 1]
    s01 = Phi0[None, :, 0, 1] + Rt[:, None, 0, 1]
    s10 = Phi0[None, :, 1, 0] + Rt[:, None, 1, 0]
    if params.noise_model == "fit":
        # Cholesky form: stable for the strongly anisotropic fit R, where
        # the det form cancels in f32 (association.py:222-235)
        tiny = torch.finfo(x.dtype).tiny
        l00 = torch.sqrt(torch.clamp(s00, min=tiny))
        l10 = s10 / l00
        l11 = torch.sqrt(torch.clamp(s11 - l10 * l10, min=tiny))
        y0 = n0 / l00
        y1 = (n1 - l10 * y0) / l11
        position_cost = y0 * y0 + y1 * y1
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

