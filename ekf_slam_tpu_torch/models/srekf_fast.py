"""Fast square-root EKF-SLAM: the general-factor filter (counterpart of
ekf_slam_tpu/models/srekf_fast.py).

The factor S is a GENERAL D×D square root, P = S·Sᵀ, PSD by construction:

* the measurement update is the closed-form Andrews update from the
  observed rows of S (V = H·S): Sm = V·Vᵀ + R, C = chol(Sm), G = C⁻¹·V,
  W = C⁻¹·chol(R), S' = S − (S·Gᵀ)·(I+W)⁻¹·G, x' = x + (S·Gᵀ)·(C⁻¹ν) — the
  exact Kalman posterior in O(M·D²) products, no QR;
* the rank-1 process noise goes into a spare zero column of S
  (``sr_noise_buffer`` extra dims past the last slot), one column a tick;
* every ``sr_noise_buffer`` ticks ``sr_recompress`` forms P = S·Sᵀ and
  refactors it with the blocked Cholesky, which zeroes the buffer again.

Invariant (tests/test_srekf_fast.py): never-touched slot and buffer
columns of S stay exactly zero through predict, update and append.

The factor is updated in place where the JAX package returns a new one:
a state passed in is consumed.  The row pairs of S are gathered by
``params.rows_gather``: 'pallas' runs the pair-gather kernel
(ops/kernels.pair_gather) at any D, including this mode's odd D.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ASSOC_KNOWN, EKFParams
from ..ops.angles import cosd, sind, wrap_to_360
from ..ops.association import gate_batch
from ..ops.blocked_chol import chol_for_state, chol_nan
from ..ops.kernels import gather_pairs, syrk_gram
from ..ops.observations import ObsBatch
from ..state import FilterState
from . import ekf
from .batched import _masked_blocks
from .srekf import _retriangularize, sr_append, sr_strips


def buffer_start(state: FilterState) -> int:
    """First noise-buffer column: the dim right past the last slot."""
    return 3 + 2 * state.capacity


def buffer_size(state: FilterState) -> int:
    """Number of spare noise columns the state was padded with."""
    return state.x.shape[0] - buffer_start(state)


def _hs_rows(S: torch.Tensor, x: torch.Tensor, zs: torch.Tensor,
             slots: torch.Tensor, valid: torch.Tensor, params: EKFParams,
             dt) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H·S [2M,D], ν [2M]) from S's pose rows and one row pair per gated
    landmark; no dense H is formed."""
    D = S.shape[1]
    M = zs.shape[0]
    A, B, nu = _masked_blocks(x, zs, slots, valid, params, dt)
    rows = 3 + 2 * slots.to(torch.int64)
    Slm = gather_pairs(S, rows, params.rows_gather).reshape(M, 2, D).to(dt)
    Spose = S[:3].to(dt)                                        # [3,D]
    HS = (torch.einsum("mij,jd->mid", A, Spose)
          + torch.einsum("mij,mjd->mid", B, Slm)).reshape(2 * M, D)
    return HS, nu


def _sqrt_noise_block(Rs: torch.Tensor, valid: torch.Tensor, dt
                      ) -> torch.Tensor:
    """Lower Cholesky factor of the block-diagonal noise [2M,2M] from the
    closed-form 2×2 factors (identity blocks in masked slots)."""
    M = Rs.shape[0]
    tiny = torch.finfo(dt).tiny
    r00 = torch.where(valid, Rs[:, 0, 0].to(dt), 1.0)
    r10 = torch.where(valid, Rs[:, 1, 0].to(dt), 0.0)
    r11 = torch.where(valid, Rs[:, 1, 1].to(dt), 1.0)
    l00 = torch.sqrt(torch.clamp(r00, min=tiny))
    l10 = r10 / l00
    l11 = torch.sqrt(torch.clamp(r11 - l10 * l10, min=tiny))
    d0 = 2 * torch.arange(M, device=Rs.device)
    sqR = torch.zeros((2 * M, 2 * M), dtype=dt, device=Rs.device)
    sqR[d0, d0] = l00
    sqR[d0 + 1, d0] = l10
    sqR[d0 + 1, d0 + 1] = l11
    return sqR


def sr_update_andrews(state: FilterState, zs: torch.Tensor,
                      slots: torch.Tensor, Rs: torch.Tensor,
                      valid: torch.Tensor, params: EKFParams
                      ) -> FilterState:
    """Joint square-root update of M observations (srekf_fast.py:133-188);
    S is updated in place.  Masked lanes: zero H rows and identity R blocks
    make their columns of S·Gᵀ zero, so they change nothing."""
    x, S = state.x, state.P
    M = zs.shape[0]
    dt = S.dtype

    HS, nu = _hs_rows(S, x, zs, slots, valid, params, dt)       # [2M,D]
    sqR = _sqrt_noise_block(Rs, valid, dt)                      # [2M,2M]

    Sm = HS @ HS.T                                              # [2M,2M]
    # the block-diagonal R = sqR·sqRᵀ added entry by entry
    d0 = 2 * torch.arange(M, device=S.device)
    d1 = d0 + 1
    Sm[d0, d0] += sqR[d0, d0] ** 2
    Sm[d1, d0] += sqR[d1, d0] * sqR[d0, d0]
    Sm[d0, d1] += sqR[d1, d0] * sqR[d0, d0]
    Sm[d1, d1] += sqR[d1, d0] ** 2 + sqR[d1, d1] ** 2

    # explicit triangular inverses (one solve each against the identity),
    # then every D-wide application is a product
    eye = torch.eye(2 * M, dtype=dt, device=S.device)
    C = chol_nan(Sm)                                            # lower
    Cinv = torch.linalg.solve_triangular(C, eye, upper=False)
    G = Cinv @ HS                                               # [2M,D]
    W = Cinv @ sqR                                              # [2M,2M]
    y = Cinv @ nu                                               # C⁻¹ν

    SGt = S @ G.T                                               # [D,2M]
    x = x + (SGt @ y).to(x.dtype)                               # K·ν

    IW = W + eye                                                # I + W, lower
    IWinv = torch.linalg.solve_triangular(IW, eye, upper=False)
    Y = IWinv @ G                                               # [2M,D]
    S.addmm_(SGt, Y, alpha=-1)                                  # in place
    # rows past the active block stay exactly zero; columns are left as
    # they are (the noise-buffer deposits live in pose rows 0..2)
    act = torch.arange(S.shape[0], device=S.device) < 3 + 2 * state.n_active
    S.mul_(act[:, None].to(dt))
    return state._replace(x=x, P=S)


def sr_update_chunked(state: FilterState, zs: torch.Tensor,
                      slots: torch.Tensor, Rs: torch.Tensor,
                      valid: torch.Tensor, params: EKFParams) -> FilterState:
    """``sr_update_andrews`` in ``params.update_chunks`` sequential chunks
    of ceil(M/G) observations."""
    G = max(1, int(params.update_chunks))
    M = zs.shape[0]
    if G == 1 or G >= M:
        return sr_update_andrews(state, zs, slots, Rs, valid, params)
    m = -(-M // G)
    for g0 in range(0, M, m):
        sl = slice(g0, min(g0 + m, M))
        state = sr_update_andrews(state, zs[sl], slots[sl], Rs[sl],
                                  valid[sl], params)
    return state


def sr_predict_fast(state: FilterState, u: torch.Tensor, params: EKFParams,
                    noise_col: int) -> FilterState:
    """Square-root prediction without re-triangularization
    (srekf_fast.py:216-242): F·S is two row axpys, and √c·w goes into
    column ``noise_col`` (a host int), which must be all zero.  S is
    updated in place."""
    x, S = state.x, state.P
    dt = S.dtype
    th = x[2]
    dD, dTh = u[0], u[1]
    w = torch.stack([dD * cosd(th), dD * sind(th), dTh]).to(dt)
    sqc = torch.sqrt(torch.tensor(params.c_process, dtype=dt)).item()

    new_pose, f13, f23 = ekf.motion_model(x[:3], u, params.ref_compat)
    new_pose = torch.cat([new_pose[:2], wrap_to_360(new_pose[2:3])])
    x = torch.cat([new_pose.to(x.dtype), x[3:]])

    row2 = S[2]
    S[0] += f13 * row2                                          # F·S
    S[1] += f23 * row2
    S[:3, noise_col] = sqc * w
    return state._replace(x=x, P=S)


def sr_recompress(state: FilterState) -> FilterState:
    """General factor → fresh lower-triangular factor of the same P
    (srekf_fast.py:249-285): the Gram P = S·Sᵀ, then the blocked Cholesky.
    Zeroes every inactive and buffer column.

    The Gram is ``syrk_gram(S, use_pallas=True)``: on a CUDA tensor one
    launch of the Gram kernel (K6; f32 S as three TF32 products on the
    tensor cores), on a CPU tensor its plain version, the product the JAX
    default leaves to XLA.  The JAX package keeps the plain product
    because its Pallas Gram lost to XLA's on the TPU; on the H100 the
    kernel is faster than ``torch.matmul(S, S.T)``.

    Forming the Gram squares the condition number; where the Cholesky
    fails (NaN on its diagonal) the factor is instead re-triangularized
    by a QR of Sᵀ, which sees only κ(S).  That QR is the filter's own
    numerical branch, as in the JAX package, not a kernel fallback.  The
    JAX ``lax.cond`` picks it on the device; here the finiteness flag is
    read to the host, once per recompression, and the QR runs only when
    it is false."""
    S = state.P
    D = S.shape[0]
    G = syrk_gram(S, use_pallas=True).to(S.dtype)
    L = chol_for_state(G, state.n_active)
    del G
    if not bool(torch.isfinite(torch.diagonal(L)).all()):    # 1 host read
        act = (torch.arange(D, device=S.device)
               < 3 + 2 * state.n_active).to(S.dtype)
        L = _retriangularize(S.T, D) * act[:, None]
    return state._replace(P=L)


def sr_update_panel(state: FilterState, zs: torch.Tensor,
                    slots: torch.Tensor, Rs: torch.Tensor,
                    valid: torch.Tensor, params: EKFParams) -> FilterState:
    """Strict-triangular joint update: the chunked Andrews update, then
    the Gram + blocked-Cholesky re-triangularization (``sr_recompress``).
    ``sr_noise_buffer=1`` in a session runs this mode end to end."""
    st = sr_update_chunked(state, zs, slots, Rs, valid, params)
    return sr_recompress(st)


def sr_measure_fast(state: FilterState, obs: ObsBatch, u: torch.Tensor,
                    params: EKFParams) -> FilterState:
    """Gate against the strips of the general factor
    (``sr_strips(triangular=False)``), one chunked Andrews update, then the
    appends of new landmarks in order, each a masked O(D) write at the
    device-side slot (srekf_fast.py:320-360)."""
    M = obs.rng.shape[0]
    zs = torch.stack([obs.rng, obs.bearing, obs.index.to(params.dtype)],
                     dim=-1)
    Rs = ekf.obs_noise_batch(obs, zs, params)

    obs_valid = obs.valid
    if params.association == ASSOC_KNOWN:
        is_new = zs[:, 2] > state.n_active.to(params.dtype)
        slots = torch.clamp(obs.index - 1, 0, state.capacity - 1)
    else:
        strips = sr_strips(state.P, state.capacity, triangular=False)
        if params.ml_losers == "drop":
            is_new, slots, losers = gate_batch(state, zs, Rs, params,
                                               strips=strips,
                                               return_losers=True)
            obs_valid = obs_valid & ~losers
        else:
            is_new, slots = gate_batch(state, zs, Rs, params, strips=strips)
    is_new = is_new | (state.n_active == 0)

    upd_valid = obs_valid & ~is_new
    state = sr_update_chunked(state, zs, slots, Rs, upd_valid, params)

    add = obs_valid & is_new
    for ii in range(M):
        state = sr_append(state, u, Rs[ii], obs.loc[ii], zs[ii, 2], params,
                          mask=add[ii])
    return state
