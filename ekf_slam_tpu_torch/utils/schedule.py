"""Update-scheduling heuristics: the fast configuration for a map size
(counterpart of ekf_slam_tpu/utils/schedule.py).

The boundary and knobs are the JAX package's, chosen by measurements on
that package's accelerator; this module keeps them so the port runs the
same configuration.  Small maps (K ≤ 2000): dense P·Hᵀ, f32 storage, GEMM
correction, chunk-256 scheduling.  Large maps: rows-mode P·Hᵀ, bf16
covariance storage, the SYRK correction, chunk-512 scheduling.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..config import EKFParams


def recommended_schedule(capacity: int, batch: Optional[int] = None
                         ) -> dict:
    """(batch, update_chunks, pht_mode, cov_dtype, correction) for
    ``capacity``; ``batch`` overrides the observation batch size M and
    the chunks then target the chunk length (256 small / 512 large)."""
    if capacity <= 2000:
        m = batch or 8192
        return {"batch": m, "update_chunks": max(1, m // 256),
                "pht_mode": "dense", "cov_dtype": None,
                "correction": "gemm"}
    m = batch or 4096
    return {"batch": m, "update_chunks": max(1, m // 512),
            "pht_mode": "rows", "cov_dtype": torch.bfloat16,
            "correction": "syrk"}


def tuned_params(params: EKFParams, batch: Optional[int] = None,
                 cov_dtype: Any = "auto") -> EKFParams:
    """``params`` with the scheduling knobs applied.  ``cov_dtype='auto'``
    takes the schedule's storage dtype; an explicit dtype (or None) pins
    it, and a non-bf16 choice also reverts the correction to 'gemm' (the
    SYRK form was chosen for bf16 P).  'srekf' is returned unchanged and
    'srekf_fast' only takes the chunking."""
    s = recommended_schedule(params.capacity, batch)
    if params.update_mode == "srekf":
        return params
    if params.update_mode == "srekf_fast":
        return dataclasses.replace(params, update_chunks=s["update_chunks"])
    cd = s["cov_dtype"] if cov_dtype == "auto" else cov_dtype
    corr = s["correction"] if cd == torch.bfloat16 else "gemm"
    return dataclasses.replace(params, update_chunks=s["update_chunks"],
                               pht_mode=s["pht_mode"], cov_dtype=cd,
                               correction=corr)
