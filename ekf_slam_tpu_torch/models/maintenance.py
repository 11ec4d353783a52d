"""Map lifecycle: landmark eviction, compaction, duplicate merging
(counterpart of ekf_slam_tpu/models/maintenance.py).

Eviction is a permutation of the joint state: kept slots are compacted to
the front in their order (the invariant "active slots are exactly
0..n_active-1" that append, the gates and the square-root filters rely
on), dropped slots move behind them and are zeroed.  The drop decision
is data (a boolean mask over the slots).

Where the JAX ``maintain`` picks the eviction or the identity with
``lax.cond`` on the device, the evictions here read the drop count (and
the active count, in the same transfer) to the host once and evict only
when it is above zero: as masks, a factored state would pay a full
recompression on every tick and a dense one its gathers.  A tick with
nothing to drop leaves the state untouched, bit for bit.

With the counts on the host the dense eviction gathers only the kept
block, P[rp, rp] for the kept rows rp, into one [k,k] buffer, copies it
to the leading block of P and zeroes the rest of P in place: one buffer
beside P, never the two D×D temporaries of ``P[perm][:, perm]``.  The
factored eviction gathers the kept rows of S into one [k,D] buffer, then
recompresses (``srekf_fast.sr_recompress``: on CUDA one launch of the
Gram kernel K6).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import EKFParams
from ..state import FilterState


def _slot_permutation(drop: torch.Tensor, n_active: torch.Tensor
                      ) -> torch.Tensor:
    """Slot permutation putting kept active slots first (stable), then
    dropped ones, then inactive padding — perm[new_slot] = old_slot.  The
    key klass·K + slot is unique, so any sort gives JAX's permutation."""
    K = drop.shape[0]
    slots = torch.arange(K, device=drop.device)
    active = slots < n_active
    klass = torch.where(active & ~drop, 0, torch.where(active & drop, 1, 2))
    return torch.argsort(klass * K + slots)


def _row_permutation(perm: torch.Tensor, D: int) -> torch.Tensor:
    """State-row permutation: pose rows fixed, slot k ↦ rows 3+2k, 4+2k;
    the tail past 3+2K (padding, noise buffer) stays in place."""
    K = perm.shape[0]
    dev = perm.device
    new = torch.arange(K, device=dev)
    rowperm = torch.arange(D, device=dev)
    rowperm[3 + 2 * new] = 3 + 2 * perm
    rowperm[4 + 2 * new] = 4 + 2 * perm
    return rowperm


def _permuted_small(state: FilterState, drop: torch.Tensor):
    """What both evictions share.  Reads the dropped active slots and
    n_active to the host in one transfer (the one sync); None when
    nothing is dropped, else x and sig permuted and zeroed past the kept
    slots, the new active mask and count, and the kept state rows in
    their new order."""
    K = state.capacity
    D = state.x.shape[0]
    dev = state.x.device
    slots = torch.arange(K, device=dev)
    drop = drop & (slots < state.n_active)
    nd, na = torch.stack([drop.sum(), state.n_active.to(torch.int64)]
                         ).tolist()
    if nd == 0:
        return None
    perm = _slot_permutation(drop, state.n_active)
    n_kept = (state.n_active - drop.sum()).to(state.n_active.dtype)
    keep_new = slots < n_kept
    rowperm = _row_permutation(perm, D)
    rows_kept = torch.arange(D, device=dev) < 3 + 2 * n_kept
    x = torch.where(rows_kept, state.x[rowperm], 0.0).to(state.x.dtype)
    sig = torch.where(keep_new, state.sig[perm], 0.0).to(state.sig.dtype)
    return x, sig, keep_new, n_kept, rowperm[:3 + 2 * (na - nd)]


def evict_landmarks(state: FilterState, drop: torch.Tensor,
                    params: EKFParams) -> FilterState:
    """Remove the landmarks where ``drop[k]`` is True (inactive slots are
    ignored); the survivors keep their joint covariance, compacted to the
    leading slots, and everything past 3 + 2·n_kept is zero.  Evicting a
    landmark marginalizes it out of the Gaussian, which is deleting its
    rows and columns, so this is lossless for the survivors.

    One host read of the drop count; with nothing dropped the state is
    returned untouched.  P is rewritten in place."""
    small = _permuted_small(state, drop)
    if small is None:
        return state
    x, sig, keep_new, n_kept, rp = small
    k = rp.shape[0]
    P = state.P
    blk = P[rp[:, None], rp[None, :]]                           # [k,k]
    P[k:].zero_()
    P[:k, k:].zero_()
    P[:k, :k].copy_(blk)
    del blk
    return FilterState(x=x, P=P, sig=sig, active=keep_new, n_active=n_kept)


def evict_landmarks_factored(state: FilterState, drop: torch.Tensor,
                             params: EKFParams) -> FilterState:
    """``evict_landmarks`` for a square-root state (the P field holds S
    with P = S·Sᵀ).  A submatrix of P is the Gram of the same row subset
    of S, so eviction permutes S's rows only; the recompression then
    restores a triangular factor whose freed columns are zero, which the
    O(D) appends rely on.  S is rewritten in place before the
    recompression."""
    from .srekf_fast import sr_recompress
    small = _permuted_small(state, drop)
    if small is None:
        return state
    x, sig, keep_new, n_kept, rp = small
    k = rp.shape[0]
    S = state.P
    rows = S.index_select(0, rp)                                # [k,D]
    S[k:].zero_()
    S[:k].copy_(rows)
    del rows
    return sr_recompress(FilterState(x=x, P=S, sig=sig, active=keep_new,
                                     n_active=n_kept))


def _slot_traces(state: FilterState, factored: bool) -> torch.Tensor:
    """Per-slot 2×2 covariance traces [K], in P's dtype — from P's
    diagonal, or from the factor's row norms (diag(S·Sᵀ) = ‖S row‖²)."""
    K = state.capacity
    end = 3 + 2 * K
    diag = ((state.P * state.P).sum(dim=1) if factored
            else torch.diagonal(state.P))
    return diag[3:end:2] + diag[4:end:2]


#: rows of the [K,K] distance plane formed at a time by duplicate_mask
_DUP_BLOCK = 2048


def duplicate_mask(state: FilterState, radius: float,
                   factored: bool = False) -> torch.Tensor:
    """Mark the worse of every active landmark pair closer than
    ``radius``: the larger covariance trace; among equal traces the higher
    slot is dropped, so the original observation survives.  Returns
    bool[K].  The squared distances are formed as JAX forms them, in the
    difference form (Δx)² + (Δy)², ``_DUP_BLOCK`` rows of the [K,K]
    plane at a time."""
    K = state.capacity
    lm = state.landmarks                                        # [K,2]
    act = state.active
    tr = _slot_traces(state, factored)                          # [K]
    slots = torch.arange(K, device=lm.device)
    r2 = radius * radius
    out = []
    for i0 in range(0, K, _DUP_BLOCK):
        i1 = min(i0 + _DUP_BLOCK, K)
        dx = lm[i0:i1, None, 0] - lm[None, :, 0]
        dy = lm[i0:i1, None, 1] - lm[None, :, 1]
        close = (dx * dx + dy * dy < r2) & act[i0:i1, None] & act[None, :]
        close &= slots[i0:i1, None] != slots[None, :]
        ti = tr[i0:i1, None]
        better = (tr[None, :] < ti) | ((tr[None, :] == ti)
                                       & (slots[None, :] < slots[i0:i1, None]))
        out.append((close & better).any(dim=1))
    return torch.cat(out)


def prune_by_uncertainty(state: FilterState, max_trace: float,
                         factored: bool = False) -> torch.Tensor:
    """Mark active landmarks whose 2×2 covariance trace exceeds
    ``max_trace`` (never converged or spurious).  Returns bool[K]."""
    return state.active & (_slot_traces(state, factored) > max_trace)


def maintain(state: FilterState, params: EKFParams,
             merge_radius: float = 0.0, max_trace: float = 0.0,
             factored: bool = False) -> Tuple[FilterState, torch.Tensor]:
    """One maintenance pass: merge duplicates within ``merge_radius`` and
    prune landmarks above ``max_trace`` (0 disables either).  Returns
    (state, n_evicted), n_evicted an int32 device scalar.  The eviction
    reads the drop count to the host once (with n_active) and evicts
    only when it is above zero; ``factored``: the state carries a
    square-root factor (srekf / srekf_fast), so the masks read its row
    norms and eviction goes through the factor-space path."""
    K = state.capacity
    drop = torch.zeros((K,), dtype=torch.bool, device=state.x.device)
    if merge_radius > 0:
        drop = drop | duplicate_mask(state, merge_radius, factored)
    if max_trace > 0:
        drop = drop | prune_by_uncertainty(state, max_trace, factored)
    evict = evict_landmarks_factored if factored else evict_landmarks
    return evict(state, drop, params), drop.sum().to(torch.int32)
