"""Blocked right-looking Cholesky (counterpart of
ekf_slam_tpu/ops/blocked_chol.py).

All O(D³) work is plain matrix products and only O(D·b²) goes through
the solver's own kernels:

    for each panel k (width b, a Python loop):
        L_kk   = chol(A_kk)                       # b×b cholesky_ex
        L_kk⁻¹ = trsm(L_kk, I_b)                  # ONE b×b triangular solve
        L_col  = A[k+1:, k] @ L_kk⁻ᵀ              # GEMM  (panel solve)
        A[k+1:, k+1:] −= L_col @ L_colᵀ           # GEMM  (trailing update)

The factorization runs in place on one working copy of the input: the
trailing update is an ``addmm_`` into the trailing block of that copy, not
a new (D−k0)² matrix per panel, and each finished panel is written over
the columns it came from.  The strict upper triangle is zeroed at the end.

A failed Cholesky gives NaN, as ``jnp.linalg.cholesky`` does: the panel
factor comes from ``torch.linalg.cholesky_ex`` with its error check off
(on CUDA the check is a host sync) and is replaced by NaN where its
``info`` flag is not 0.  The NaN then runs through every later panel,
which is what ``models/srekf_fast.sr_recompress`` tests for.
"""
from __future__ import annotations

import torch


def chol_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrized ``A``, NaN in the lower
    triangle where the factorization fails (``jnp.linalg.cholesky``: it
    factors (A + Aᵀ)/2 and returns NaN on a matrix that is not positive
    definite).  No host sync: ``info`` stays on the device."""
    L, info = torch.linalg.cholesky_ex(0.5 * (A + A.mT), check_errors=False)
    nan = torch.full_like(L, float("nan")).tril()
    return torch.where(info == 0, L, nan)


def tri_inv_blocked(L: torch.Tensor, block: int = 512) -> torch.Tensor:
    """L⁻¹ for lower-triangular L with the O(d³) work as GEMMs: recursive
    2×2 partition inv([[A,0],[B,C]]) = [[A⁻¹,0],[−C⁻¹·B·A⁻¹, C⁻¹]], so only
    blocks of at most ``block`` go through a triangular solve."""
    d = L.shape[0]
    if d <= block:
        eye = torch.eye(d, dtype=L.dtype, device=L.device)
        return torch.linalg.solve_triangular(L, eye, upper=False)
    h = max(block, ((d // 2) // block) * block)
    Ai = tri_inv_blocked(L[:h, :h], block=block)
    Ci = tri_inv_blocked(L[h:, h:], block=block)
    out = torch.zeros_like(L)
    out[:h, :h] = Ai
    out[h:, h:] = Ci
    out[h:, :h] = -Ci @ (L[h:, :h] @ Ai)
    return out


def _chol_in_place(A: torch.Tensor, block: int) -> torch.Tensor:
    """Factor ``A`` in place (its lower triangle becomes L, its strict
    upper triangle 0); the panel structure of blocked_chol.py:60-99."""
    D = A.shape[0]
    if D <= min(block, 512):
        A.copy_(chol_nan(A))
        return A
    if D <= block:
        return _chol_in_place(A, 512)
    for k0 in range(0, D, block):
        b = min(block, D - k0)
        k1 = k0 + b
        Akk = A[k0:k1, k0:k1]
        if b <= 512:
            Akk.copy_(chol_nan(Akk))
        else:
            _chol_in_place(Akk, 512)
        if k1 >= D:
            break
        Lkk_inv = tri_inv_blocked(Akk.tril())
        Lcol = A[k1:, k0:k1] @ Lkk_inv.T                 # [D-k1, b] GEMM
        A[k1:, k0:k1] = Lcol
        A[k1:, k1:].addmm_(Lcol, Lcol.T, alpha=-1)      # trailing update
    return A.tril_()


def chol_blocked(A: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Lower Cholesky factor of the symmetric positive-definite ``A`` (a
    new tensor; ``A`` is not changed).  Same math as
    ``torch.linalg.cholesky``; the strict upper triangle is exactly 0."""
    return _chol_in_place(A.clone(), block)


def chol_for_state(P: torch.Tensor, n_active, block: int = 1024
                   ) -> torch.Tensor:
    """Cholesky of a filter covariance whose rows/cols beyond the active
    block (3+2·n_active) are zero: 1 is added on the inactive diagonal so
    the factorization is well-defined, and the inactive rows of the factor
    are zeroed back out.  ``n_active`` may be a device tensor: nothing is
    read back to the host.  Returns a new tensor."""
    D = P.shape[0]
    act = (torch.arange(D, device=P.device) < 3 + 2 * n_active)
    W = P.clone()
    # O(D) diagonal write, not a D² add of diag(aug)
    W.diagonal().add_((~act).to(P.dtype))
    _chol_in_place(W, block)
    return W.mul_(act[:, None].to(P.dtype))
