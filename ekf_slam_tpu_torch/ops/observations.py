"""Fixed-capacity observation batch (counterpart of
ekf_slam_tpu/ops/observations.py): rows [range, bearing_deg, index]
(RANSAC.m:275-284) plus the world-frame loc, padded to ``max_obs`` with a
validity mask."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import resolve_device


class ObsBatch(NamedTuple):
    rng: torch.Tensor      # f[M]   measured range
    bearing: torch.Tensor  # f[M]   measured bearing, degrees
    index: torch.Tensor    # i32[M] extractor landmark index (signature)
    loc: torch.Tensor      # f[M,2] world-frame landmark position
    valid: torch.Tensor    # bool[M]
    #: optional per-observation covariance [M,2,2] in (range m, bearing
    #: deg), propagated from the line fit (EKFParams.noise_model='fit').
    R: torch.Tensor = None


def empty_obs(max_obs: int, dtype=torch.float32, device=None) -> ObsBatch:
    """An all-invalid batch of ``max_obs`` rows."""
    device = resolve_device(device)
    return ObsBatch(
        rng=torch.zeros((max_obs,), dtype=dtype, device=device),
        bearing=torch.zeros((max_obs,), dtype=dtype, device=device),
        index=torch.zeros((max_obs,), dtype=torch.int32, device=device),
        loc=torch.zeros((max_obs, 2), dtype=dtype, device=device),
        valid=torch.zeros((max_obs,), dtype=torch.bool, device=device),
    )


def obs_from_rows(rows, locs, max_obs: int, dtype=torch.float32,
                  device=None) -> ObsBatch:
    """A padded batch from host-side rows [range, bearing, index] and the
    matching world locations (test and simulator convenience); rows past
    ``max_obs`` are dropped."""
    rows = np.atleast_2d(np.asarray(rows, np.float64))
    locs = np.atleast_2d(np.asarray(locs, np.float64))
    n = 0 if rows.size == 0 else min(rows.shape[0], max_obs)
    out = empty_obs(max_obs, dtype, device)
    if n == 0:
        return out
    dev = out.rng.device
    out.rng[:n] = torch.as_tensor(rows[:n, 0], device=dev).to(dtype)
    out.bearing[:n] = torch.as_tensor(rows[:n, 1], device=dev).to(dtype)
    out.index[:n] = torch.as_tensor(rows[:n, 2].astype(np.int32),
                                    device=dev)
    out.loc[:n] = torch.as_tensor(locs[:n], device=dev).to(dtype)
    out.valid[:n] = True
    return out
