"""Fixed-capacity observation batch (counterpart of
ekf_slam_tpu/ops/observations.py): rows [range, bearing_deg, index]
(RANSAC.m:275-284) plus the world-frame loc, padded to ``max_obs`` with a
validity mask."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ObsBatch(NamedTuple):
    rng: torch.Tensor      # f[M]   measured range
    bearing: torch.Tensor  # f[M]   measured bearing, degrees
    index: torch.Tensor    # i32[M] extractor landmark index (signature)
    loc: torch.Tensor      # f[M,2] world-frame landmark position
    valid: torch.Tensor    # bool[M]
    #: optional per-observation covariance [M,2,2] in (range m, bearing
    #: deg), propagated from the line fit (EKFParams.noise_model='fit').
    R: torch.Tensor = None
