"""Fixed-capacity SLAM filter state (counterpart of ekf_slam_tpu/state.py).

Layout: ``x = [xr, yr, theta_deg, l0x, l0y, l1x, l1y, ...]`` with
``D = 3 + 2K`` (rounded up by ``pad_to_multiple_of``); landmark slot ``k``
occupies rows ``3+2k : 5+2k``.  Inactive slots hold zeros in ``x`` and
zero rows/cols in ``P``, so masked updates touching them are no-ops.

Unlike the JAX state, the tensors here are mutable: the filter updates
``P`` in place where the JAX package donates or aliases its buffer, so a
state passed to ``predict``/``update_batch``/``append`` is consumed.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import EKFParams, resolve_device


class FilterState(NamedTuple):
    x: torch.Tensor         # f[D]      joint mean, theta in degrees at x[2]
    P: torch.Tensor         # f[D, D]   joint covariance (dense, padded)
    sig: torch.Tensor       # f[K]      landmark signatures
    active: torch.Tensor    # bool[K]   slot occupied
    n_active: torch.Tensor  # i32 ()    number of active landmarks

    @property
    def capacity(self) -> int:
        return self.sig.shape[0]

    @property
    def landmarks(self) -> torch.Tensor:
        """Landmark positions f[K, 2] (sliced by capacity, not to the end:
        x may carry padding rows)."""
        K = self.capacity
        return self.x[3:3 + 2 * K].reshape(K, 2)


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_state(params: EKFParams, pad_to_multiple_of: int = 1,
               extra_dims: int = 0, device=None) -> FilterState:
    """Origin pose, P = p0_diag·I on the pose block, no landmarks
    (EKF_SLAM.m:28-31).  ``pad_to_multiple_of`` rounds D up (permanent
    zero rows); ``extra_dims`` appends zero dims beyond 3+2K."""
    device = resolve_device(device)
    D, K = params.dim + extra_dims, params.capacity
    D = round_up(D, pad_to_multiple_of)
    P = torch.zeros((D, D), dtype=params.cov_dt, device=device)
    P[:3, :3].fill_diagonal_(params.p0_diag)
    return FilterState(
        x=torch.zeros((D,), dtype=params.dtype, device=device),
        P=P,
        sig=torch.zeros((K,), dtype=params.dtype, device=device),
        active=torch.zeros((K,), dtype=torch.bool, device=device),
        n_active=torch.zeros((), dtype=torch.int32, device=device),
    )
