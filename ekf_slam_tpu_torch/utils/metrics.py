"""Filter-health monitors and JSONL metrics (counterpart of
ekf_slam_tpu/utils/metrics.py).

The reference's only observability is live plotting; this module gives
a covariance health summary computed on the device (finite, symmetry
drift, smallest diagonal, trace: the (I−KH)P form of EKF_SLAM_UC.m:146
loses symmetry and definiteness, and these quantify the drift), the
normalized innovation squared, and an append-only JSONL logger.
"""
from __future__ import annotations

import json
import os
import time
from typing import IO, NamedTuple, Optional

import numpy as np
import torch

from ..state import FilterState


class FilterHealth(NamedTuple):
    finite: torch.Tensor      # bool  all of x and the masked P finite
    asym: torch.Tensor        # f     max |P - Pᵀ| over the active block
    min_diag: torch.Tensor    # f     min diag(P) over the active dims
    trace: torch.Tensor       # f     tr(P) over the active dims


def filter_health(state: FilterState) -> FilterHealth:
    """Health summary of the covariance, on the state's device with no
    host read (each field a 0-dim tensor).  The active dims are the first
    3 + 2·n_active; P is masked past them as the JAX package masks it, so
    padding (the tuned path pads D to a multiple of 512) is left out, but
    a non-finite entry anywhere in P still makes ``finite`` false (0·inf
    is NaN).  Under update_mode 'srekf' and 'srekf_fast' the P field
    holds the factor S (P = S·Sᵀ), and the fields describe S, as the JAX
    package's do: ``asym`` is then S's asymmetry, not a fault."""
    P = state.P
    idx = torch.arange(state.x.shape[0], device=P.device)
    active = idx < 3 + 2 * state.n_active
    m = active.to(P.dtype)
    Pm = P * m[:, None] * m[None, :]
    asym = (Pm - Pm.T).abs().max()
    diag = P.diagonal()
    min_diag = torch.where(active, diag, float("inf")).min()
    finite = torch.isfinite(state.x).all() & torch.isfinite(Pm).all()
    trace = torch.where(active, diag, 0.0).sum()
    return FilterHealth(finite=finite, asym=asym, min_diag=min_diag,
                        trace=trace)


def nis(innovation: torch.Tensor, phi_inv: torch.Tensor) -> torch.Tensor:
    """Normalized innovation squared νᵀ·Φ⁻¹·ν, the consistency statistic
    (χ²(2)-distributed for a consistent filter)."""
    return innovation @ phi_inv @ innovation


class MetricsLogger:
    """Append-only JSONL metrics stream (host side).  ``log`` reads each
    tensor field back to the host (one transfer, and so one host sync,
    per field on a CUDA tensor), as the JAX logger's ``np.asarray`` does:
    call it where the caller may wait for the device."""

    def __init__(self, path: Optional[str] = None,
                 stream: Optional[IO] = None):
        if stream is None and path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
        self._fh = stream if stream is not None else (
            open(path, "a") if path else None)
        self._t0 = time.perf_counter()

    def log(self, step: int, **fields) -> dict:
        rec = {"step": int(step),
               "t_wall": round(time.perf_counter() - self._t0, 6)}
        for k, v in fields.items():
            if isinstance(v, torch.Tensor):
                v = v.tolist()
            elif isinstance(v, np.ndarray):
                v = v.item() if v.ndim == 0 else v.tolist()
            rec[k] = v
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
