"""Batched-innovation EKF update: M observations in one pass over P
(counterpart of ekf_slam_tpu/models/batched.py).

The reference applies observations strictly sequentially, one full pass
over the (3+2K)² covariance each (EKF_SLAM_UC.m:109-150).  The joint update
stacks the M measurement Jacobians into one [2M × D] model and applies a
single rank-2M correction

    S = H P Hᵀ + R   (2M×2M),  K = P Hᵀ S⁻¹  (D×2M),  P ← P − K·(P Hᵀ)ᵀ

touching P once.  Invalid observation slots contribute zero Jacobian rows
and an identity S block, making them exact no-ops, so every tick runs the
same ops on the same shapes whatever the data — no host round trip.

P is updated in place (the JAX SYRK aliases its P buffer,
kernels.py:350, and the session donates its carry).  On CUDA tensors the
hand-written kernels of ops/kernels run: ``correction='syrk'`` the SYRK
downdate; ``use_pallas`` with non-bf16 P and the gemm correction the
in-place ``cov_update``; ``rows_gather='pallas'`` the row-pair gather.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ASSOC_KNOWN, EKFParams
from ..models import ekf
from ..ops.angles import wrap_to_180
from ..ops.association import gate_batch
from ..ops.kernels import cov_update, gather_pairs, syrk_downdate
from ..ops.observations import ObsBatch
from ..state import FilterState


def _masked_blocks(x, zs, slots, valid, params: EKFParams, dt):
    """ẑ/A/B per observation with invalid rows zeroed, and the masked
    innovation ν [2M] (bearing wrapped unless ref_compat)."""
    M = zs.shape[0]
    zhat, A, B = ekf.innovation(x, slots)
    vmask = valid.to(dt)
    A = A * vmask[:, None, None]                                # [M,2,3]
    B = B * vmask[:, None, None]                                # [M,2,2]
    nu = zs[:, :2].to(dt) - zhat
    if not params.ref_compat:
        nu = torch.stack([nu[:, 0], wrap_to_180(nu[:, 1])], dim=-1)
    nu = (nu * vmask[:, None]).reshape(2 * M)
    return A, B, nu


def _dense_ht(D: int, A, B, rows, dt) -> torch.Tensor:
    """Dense Hᵀ [D,2M]: column pair 2m holds A_mᵀ in the pose rows and
    B_mᵀ in landmark slot_m's row pair."""
    M = A.shape[0]
    dev = A.device
    Ht = torch.zeros((D, 2 * M), dtype=dt, device=dev)
    Ht[0:3, :] = A.permute(2, 0, 1).reshape(3, 2 * M)
    two = torch.arange(2, device=dev)
    rowpair = rows[:, None] + two[None, :]                      # [M,2]
    colpair = 2 * torch.arange(M, device=dev)[:, None] + two[None, :]
    Ht.index_put_((rowpair[:, :, None], colpair[:, None, :]),
                  B.transpose(1, 2), accumulate=True)
    return Ht


def innovation_operator(x: torch.Tensor, zs: torch.Tensor,
                        slots: torch.Tensor, valid: torch.Tensor,
                        params: EKFParams, dt
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked observation model for M measurements: (Ht [D,2M], nu [2M])."""
    A, B, nu = _masked_blocks(x, zs, slots, valid, params, dt)
    rows = 3 + 2 * slots.to(torch.int64)
    return _dense_ht(x.shape[0], A, B, rows, dt), nu


def noise_block(Rs: torch.Tensor, valid: torch.Tensor, dt) -> torch.Tensor:
    """Block-diagonal R [2M,2M]; invalid slots get identity blocks so the
    joint innovation system stays well-conditioned where H/nu are zero."""
    M = Rs.shape[0]
    eye = torch.eye(2, dtype=dt, device=Rs.device)
    blocks = torch.where(valid[:, None, None], Rs.to(dt), eye)  # [M,2,2]
    return torch.block_diag(*blocks) if M else torch.zeros(
        (0, 0), dtype=dt, device=Rs.device)


def hp_from_rows(P: torch.Tensor, x: torch.Tensor, zs: torch.Tensor,
                 slots: torch.Tensor, valid: torch.Tensor, params: EKFParams,
                 dt) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(HP [2M,D], Ht [D,2M], nu [2M]) from the OBSERVED rows of a
    symmetric P: the pose rows plus one contiguous row pair per gated
    landmark (pht_mode='rows'; P·Hᵀ = (H·P)ᵀ by symmetry).  The row pairs
    are gathered by ``params.rows_gather``: 'take' (index_select) or
    'pallas' (the pair-gather kernel, ops/kernels.pair_gather)."""
    D = x.shape[0]
    M = zs.shape[0]
    A, B, nu = _masked_blocks(x, zs, slots, valid, params, dt)
    rows = 3 + 2 * slots.to(torch.int64)
    Plm = gather_pairs(P, rows, params.rows_gather).reshape(M, 2, D).to(dt)
    Ppose = P[:3].to(dt)                                        # [3,D]
    HP = (torch.einsum("mij,jd->mid", A, Ppose)
          + torch.einsum("mij,mjd->mid", B, Plm)).reshape(2 * M, D)
    return HP, _dense_ht(D, A, B, rows, dt), nu


def update_batch(state: FilterState, zs: torch.Tensor, slots: torch.Tensor,
                 Rs: torch.Tensor, valid: torch.Tensor, params: EKFParams
                 ) -> FilterState:
    """Joint update of M (range, bearing) observations against ``slots``
    (zs f[M,2+], Rs f[M,2,2], valid bool[M]); P is updated in place.

    With bf16 P the large products take bf16 operands and accumulate in
    f32 (batched.py:168-174); everything small (S, its Cholesky, the
    mean) stays in the compute dtype."""
    x, P = state.x, state.P
    ct = x.dtype
    fast16 = P.dtype == torch.bfloat16

    def mm(a, b):
        """Large product in the storage precision, accumulated in ct.
        bf16 operands upcast exactly to f32 give jnp's
        preferred_element_type=f32 product (dense/gemm paths only)."""
        if fast16:
            return (a.to(torch.bfloat16).to(ct)
                    @ b.to(torch.bfloat16).to(ct))
        return a @ b

    if params.pht_mode == "rows":
        HP, Ht, nu = hp_from_rows(P, x, zs, slots, valid, params, ct)
        PHt = HP.T                                              # symmetry
        S = HP @ Ht
    else:
        Ht, nu = innovation_operator(x, zs, slots, valid, params, ct)
        PHt = mm(P, Ht)                                         # [D,2M]
        S = Ht.T @ PHt                                          # [2M,2M]
    S = S + noise_block(Rs, valid, ct)

    # Kg = PHt·S⁻¹ through the explicit Cholesky inverse (one triangular
    # solve against the identity, batched.py:187-198).  cholesky_ex does
    # not check its info flag, so no host sync.
    L, _ = torch.linalg.cholesky_ex(S)
    eye = torch.eye(2 * zs.shape[0], dtype=ct, device=x.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)

    if params.correction == "syrk":
        # Kg·(H·P) = W·Wᵀ with W = PHᵀ·L⁻ᵀ; the mean uses the same factor
        W = PHt @ Linv.T                                        # [D,2M]
        x = x + W @ (Linv @ nu)
        Wk = W.to(torch.bfloat16) if fast16 else W
        syrk_downdate(P, Wk.contiguous())                       # in place
        if params.symmetrize:
            P.copy_(0.5 * (P + P.T))
        return state._replace(x=x, P=P)

    Sinv = Linv.T @ Linv
    Kg = PHt @ Sinv                                             # [D,2M]
    x = x + Kg @ nu
    if params.joseph:
        KB = mm(Kg, PHt.T)
        P.copy_(P - KB - KB.T + mm(Kg @ S, Kg.T))
    elif params.use_pallas and not fast16:
        # the in-place correction kernel (batched.py:223-227); PHt.T is
        # HP itself in rows mode, a transposed view in dense mode, which
        # .contiguous() copies (D·2M elements) as the kernel takes no
        # strides
        cov_update(P, Kg.to(P.dtype), PHt.T.contiguous().to(P.dtype))
    else:
        P.sub_(mm(Kg, PHt.T))
    if params.symmetrize:
        P.copy_(0.5 * (P + P.T))
    return state._replace(x=x, P=P)


def update_chunked(state: FilterState, zs: torch.Tensor, slots: torch.Tensor,
                   Rs: torch.Tensor, valid: torch.Tensor, params: EKFParams
                   ) -> FilterState:
    """``update_batch`` in ``params.update_chunks`` sequential chunks of
    ceil(M/G) observations (each chunk linearizes against the running
    state)."""
    G = max(1, int(params.update_chunks))
    M = zs.shape[0]
    if G == 1 or G >= M:
        return update_batch(state, zs, slots, Rs, valid, params)
    m = -(-M // G)
    for g0 in range(0, M, m):
        sl = slice(g0, min(g0 + m, M))
        state = update_batch(state, zs[sl], slots[sl], Rs[sl], valid[sl],
                             params)
    return state


def measure_batched(state: FilterState, obs: ObsBatch, u: torch.Tensor,
                    params: EKFParams) -> FilterState:
    """Gate all observations against the pre-update state, apply ONE joint
    update, then append the new landmarks in order — each append a masked
    O(D) write at the device-side slot (ekf.append), so the loop over the
    M slots runs the same ops every tick and never syncs."""
    M = obs.rng.shape[0]
    zs = torch.stack([obs.rng, obs.bearing, obs.index.to(params.dtype)],
                     dim=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)                   # [M,2,2]

    obs_valid = obs.valid
    if params.association == ASSOC_KNOWN:
        is_new = zs[:, 2] > state.n_active.to(params.dtype)
        slots = torch.clamp(obs.index - 1, 0, state.capacity - 1)
    elif params.ml_losers == "drop":
        is_new, slots, losers = gate_batch(
            state, zs, Rs, params, use_pallas=params.use_pallas,
            return_losers=True)
        obs_valid = obs_valid & ~losers
    else:
        is_new, slots = gate_batch(state, zs, Rs, params,
                                   use_pallas=params.use_pallas)
    is_new = is_new | (state.n_active == 0)

    upd_valid = obs_valid & ~is_new
    state = update_chunked(state, zs, slots, Rs, upd_valid, params)

    add = obs_valid & is_new
    for ii in range(M):
        state = ekf.append(state, u, Rs[ii], obs.loc[ii], zs[ii, 2], params,
                           mask=add[ii])
    return state
