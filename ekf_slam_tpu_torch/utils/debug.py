"""Eager state validation (counterpart of ekf_slam_tpu/utils/debug.py).

The same structural, dtype and numeric invariants as the JAX package's
``validate_state``, checked in the same order with plain asserts, so the
same state fails on the same assertion.  chex imports JAX, so none of it
is used here.  The value checks run on the state's own device and bring
only scalars back: JAX's version copies P to the host (1.6 GB at 10k
landmarks), and a bf16 P has no numpy dtype.

    validate_state(carry.filt, params)        # raises AssertionError

A state whose P is stored in another dtype than x (``tuned_params``' bf16
P beside f32 x) fails the dtype assertion, as it does in JAX.
"""
from __future__ import annotations

import torch

from ..config import EKFParams
from ..state import FilterState


def validate_state(state: FilterState, params: EKFParams,
                   check_values: bool = True) -> None:
    """Structural + (optionally) numeric invariants of a FilterState.

    Raises AssertionError on violation.  Each value check reads one
    scalar back to the host (a sync on a CUDA state)."""
    K = params.capacity
    D = state.x.shape[0]
    assert (state.x.dim(), state.sig.dim(), state.active.dim()) == (1, 1, 1), (
        "rank of x, sig, active", state.x.dim(), state.sig.dim(),
        state.active.dim())
    assert state.P.dim() == 2, ("rank of P", state.P.dim())
    assert tuple(state.P.shape) == (D, D), ("shape of P", state.P.shape, D)
    assert tuple(state.sig.shape) == (K,), ("shape of sig", state.sig.shape, K)
    assert tuple(state.active.shape) == (K,), (
        "shape of active", state.active.shape, K)
    assert D >= 3 + 2 * K, (D, K)
    assert state.P.dtype == state.x.dtype, (state.P.dtype, state.x.dtype)

    if not check_values:
        return
    n = int(state.n_active)
    assert 0 <= n <= K, n
    n_set = int(state.active.sum())
    assert n_set == n, (n_set, n)
    # active slots are a prefix (append fills in order)
    assert bool(state.active[:n].all()) and not bool(state.active[n:].any()), (
        "active is not a prefix of", n)
    assert bool(torch.isfinite(state.x).all()) and bool(
        torch.isfinite(state.P).all()), "non-finite x or P"
    d = 3 + 2 * n
    diag = torch.diagonal(state.P)[:d]
    assert bool((diag > -1e-5).all()), float(diag.min())
    # inactive block must stay exactly zero (masked-write invariant)
    assert not bool(state.P[d:, :].any()) and not bool(state.P[:, d:].any()), (
        "inactive block of P is not zero past", d)
    assert not bool(state.x[d:].any()), ("x is not zero past", d)


def assert_symmetric(P, tol: float = 1e-5) -> float:
    """|P − Pᵀ|max < tol, computed on P's device in P's dtype; returns
    the asymmetry it measured."""
    P = torch.as_tensor(P)
    asym = float((P - P.mT).abs().max())
    assert asym < tol, f"covariance asymmetry {asym:.2e} >= {tol:.0e}"
    return asym
