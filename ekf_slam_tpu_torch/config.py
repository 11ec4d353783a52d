"""Typed configuration for the PyTorch EKF-SLAM engine.

Mirrors ``ekf_slam_tpu/config.py`` field for field (same names, same
defaults, same validation) with torch dtypes in place of jnp dtypes, so a
configuration converts between the two packages as a plain field dict
(``convert.params_from_dict``).  The field comments of the JAX package
document each knob; this module repeats only what differs here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

ASSOC_SIGNATURE = "signature"
ASSOC_ML = "ml"
ASSOC_ML_UNIQUE = "ml_unique"
ASSOC_KNOWN = "known"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another device.  With no GPU and no explicit device this raises — the
    port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` as a Python float — what
    ``jnp.asarray(value, dtype)`` holds.  Products with it stay Python
    scalars: a 0-dim CUDA tensor made from a Python number would cost a
    host-to-device copy and a stream sync per use."""
    return torch.tensor(value, dtype=dtype).item()


@dataclasses.dataclass(frozen=True)
class EKFParams:
    """Filter-core parameters (reference values: EKF_SLAM.m:12-31,
    EKF_SLAM_UC.m:13-16)."""

    capacity: int = 128
    max_obs: int = 16
    c_process: float = 0.2
    q_floor: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rc: Tuple[float, float] = (0.1, 5.0)
    #: 'scaled' (reference R = diag(z_r·rc0, z_phi·rc1)), 'constant'
    #: (diag(rc0², rc1²)) or 'fit' (extractor-propagated R + the floor).
    noise_model: str = "scaled"
    s_cost: float = 1e-11
    s_thresh: float = 1e9
    p0_diag: float = 0.1
    association: str = ASSOC_SIGNATURE
    ml_losers: str = "append"
    #: 'sequential' (the reference's per-observation chain, models/ekf
    #: .measure), 'batched', 'srekf' (the QR square-root filter) or
    #: 'srekf_fast' (the general-factor square-root filter).
    update_mode: str = "sequential"
    sr_noise_buffer: int = 64
    update_chunks: int = 1
    pht_mode: str = "dense"
    #: 'take' gathers the observed row pairs with ``index_select``;
    #: 'pallas' runs the hand-written pair-gather kernel
    #: (ops/kernels.pair_gather) on CUDA tensors.  Unlike the JAX kernel
    #: it takes any shape, so nothing is padded and nothing falls back.
    rows_gather: str = "take"
    #: 'syrk' runs the hand-written CUDA SYRK downdate
    #: (ops/kernels.syrk_downdate) on CUDA tensors.
    correction: str = "gemm"
    guard_max_jump: float = None
    ref_compat: bool = True
    #: the batched session's kernel path: the fused gate kernel
    #: (ops/gating.gate_costs_state) in place of the plain gate, and with
    #: non-bf16 P and the gemm correction the in-place cov_update kernel
    #: (ops/kernels.cov_update).  On TPU this is the JAX package's measured
    #: experiment setting, not a default.
    use_pallas: bool = False
    masked_writes: bool = False
    joseph: bool = False
    symmetrize: bool = False
    dtype: Any = torch.float32
    #: storage dtype for P only (None → ``dtype``); torch.bfloat16 halves
    #: the bytes of every pass over P while contractions accumulate in f32.
    cov_dtype: Any = None

    def __post_init__(self):
        if self.pht_mode not in ("dense", "rows"):
            raise ValueError(f"unknown pht_mode {self.pht_mode!r}")
        if self.update_mode not in ("sequential", "batched", "srekf",
                                    "srekf_fast"):
            raise ValueError(f"unknown update_mode {self.update_mode!r}")
        if self.update_mode in ("srekf", "srekf_fast"):
            ignored = [
                ("cov_dtype", self.cov_dtype is not None),
                ("use_pallas", self.use_pallas),
                ("joseph", self.joseph),
                ("symmetrize", self.symmetrize),
                ("masked_writes", self.masked_writes),
                ("pht_mode='rows'", self.pht_mode == "rows"),
                ("q_floor", any(q > 0 for q in self.q_floor)),
            ]
            bad = [name for name, hit in ignored if hit]
            if bad:
                raise ValueError(
                    f"update_mode={self.update_mode!r} ignores dense-path "
                    f"options {bad}; unset them (square-root filters keep "
                    "full-precision factor storage and have the row-gather "
                    "built in)")
        if self.association not in (ASSOC_SIGNATURE, ASSOC_ML,
                                    ASSOC_ML_UNIQUE, ASSOC_KNOWN):
            raise ValueError(f"unknown association {self.association!r}")
        if self.noise_model not in ("scaled", "constant", "fit"):
            raise ValueError(f"unknown noise_model {self.noise_model!r}; "
                             "use 'scaled' (reference), 'constant' or "
                             "'fit'")
        if self.noise_model != "scaled" and self.ref_compat:
            raise ValueError(
                f"noise_model={self.noise_model!r} departs from the "
                "reference's value-scaled R (EKF_SLAM_UC.m:110) — unset "
                "ref_compat")
        if self.ml_losers not in ("append", "drop"):
            raise ValueError(f"unknown ml_losers {self.ml_losers!r}; "
                             "use 'append' or 'drop'")
        if self.ml_losers == "drop" and self.association != ASSOC_ML_UNIQUE:
            raise ValueError(
                "ml_losers='drop' only applies to association='ml_unique' "
                "(no other mode produces batch-level losers)")
        if self.rows_gather not in ("take", "pallas"):
            raise ValueError(f"unknown rows_gather {self.rows_gather!r}")
        if (self.rows_gather == "pallas"
                and self.pht_mode != "rows"
                and self.update_mode != "srekf_fast"):
            raise ValueError(
                "rows_gather='pallas' only applies to row-gathering paths "
                "(pht_mode='rows' or update_mode='srekf_fast')")
        if self.correction not in ("gemm", "syrk"):
            raise ValueError(f"unknown correction {self.correction!r}")
        if self.correction == "syrk" and self.joseph:
            raise ValueError(
                "correction='syrk' computes the plain symmetric downdate "
                "W·Wᵀ; the Joseph form's correction is not of that shape — "
                "unset joseph (syrk already preserves symmetry exactly)")
        if self.correction == "syrk" and self.update_mode in (
                "srekf", "srekf_fast"):
            raise ValueError(
                "correction='syrk' applies to the dense batched update "
                "only; square-root modes never form the dense correction")
        if self.update_mode == "srekf" and self.update_chunks > 1:
            raise ValueError(
                "update_chunks is not supported by the QR srekf path "
                "(one pre-array per tick); use update_mode='srekf_fast'")
        if self.update_mode == "srekf_fast" and self.sr_noise_buffer < 1:
            raise ValueError(
                "update_mode='srekf_fast' needs sr_noise_buffer >= 1 "
                "(spare zero columns for O(D) process-noise absorption)")

    @property
    def cov_dt(self):
        """Effective covariance storage dtype."""
        return self.dtype if self.cov_dtype is None else self.cov_dtype

    @property
    def dim(self) -> int:
        """Joint state dimension D = 3 + 2K (before padding)."""
        return 3 + 2 * self.capacity


@dataclasses.dataclass(frozen=True)
class RansacParams:
    """Landmark-extraction parameters (reference constants RANSAC.m:67-90)."""

    line_consensus: int = 300
    wall_search_timeout: int = 3
    sample_points: int = 20
    bearing_window_deg: float = 5.0
    inlier_dist: float = 0.25
    assoc_dist: float = 0.50
    promote_count: int = 10
    freshness: int = 50
    table_capacity: int = 256
    match_mode: str = "all"
    refine_passes: int = 0
    refine_frac: float = 0.5
    split_kink_deg: float = 0.0
    max_fit_rms: float = 0.0
    split_gap: float = 0.0
    #: >0 selects the batched-hypothesis wall search, whose scoring and
    #: greedy rounds run in the hand-written CUDA kernel
    #: (ops/kernels.wall_search); 0 the reference's one-seed-per-round
    #: search (ops/ransac.find_walls), plain torch ops.
    n_hypotheses: int = 0
    ref_compat: bool = True
    writeback_last_only: bool = True
    writeback_mode: str = "ref"
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.writeback_mode not in ("ref", "sig", "off"):
            raise ValueError(
                f"unknown writeback_mode {self.writeback_mode!r}; "
                "use 'ref', 'sig' or 'off'")
        if self.match_mode not in ("all", "nearest"):
            raise ValueError(f"unknown match_mode {self.match_mode!r}; "
                             "use 'all' (reference) or 'nearest'")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Deterministic simulator settings (sim/world.py)."""

    n_beams: int = 1024
    fov_deg: float = 360.0
    max_range: float = 8.0
    range_noise_std: float = 0.01
    odom_xy_noise_std: float = 0.002
    odom_theta_noise_std: float = 0.05
    dtype: Any = torch.float32


def ref_compat_uc(capacity: int = 128, **kw) -> EKFParams:
    """EKF_SLAM_UC preset (EKF_SLAM_UC.m:12-16)."""
    kw.setdefault("rc", (0.1, 5.0))
    kw.setdefault("association", ASSOC_SIGNATURE)
    kw.setdefault("ref_compat", True)
    return EKFParams(capacity=capacity, **kw)


def ref_compat_known(capacity: int = 128, **kw) -> EKFParams:
    """EKF_SLAM preset, known correspondence (EKF_SLAM.m:12-16)."""
    kw.setdefault("rc", (0.01, 5.0))
    kw.setdefault("association", ASSOC_KNOWN)
    kw.setdefault("ref_compat", True)
    return EKFParams(capacity=capacity, **kw)


def ref_compat_legacy(capacity: int = 128, **kw) -> EKFParams:
    """Legacy script-pipeline preset (SLAM_ransac.m:17: Rc = [10, 1]),
    known correspondence."""
    kw.setdefault("rc", (10.0, 1.0))
    kw.setdefault("association", ASSOC_KNOWN)
    kw.setdefault("ref_compat", True)
    return EKFParams(capacity=capacity, **kw)


def sim_ransac(n_beams: int = 1024, **kw) -> RansacParams:
    """RANSAC preset scaled to the simulator's beam density (the
    reference's consensus assumes ~640 returns per wall)."""
    consensus = max(20, int(300 * n_beams / 640 / 8))
    return RansacParams(line_consensus=consensus, bearing_window_deg=20.0,
                        **kw)
