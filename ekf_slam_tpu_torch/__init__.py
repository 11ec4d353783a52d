"""ekf_slam_tpu_torch — the EKF-SLAM engine in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``ekf_slam_tpu`` (JAX/XLA/Pallas), module for module: the same
configuration fields, state layout and tick; plain PyTorch around the
kernels; P updated in place.  This package imports neither JAX nor
``ekf_slam_tpu``.  Entry points run on CUDA unless given ``device='cpu'``.

    from ekf_slam_tpu_torch import SlamSession, EKFParams, RansacParams
    sess = SlamSession(ekf_params=tuned_params(EKFParams(
        capacity=10000, max_obs=8, ref_compat=False,
        update_mode="batched"), batch=8),
        ransac_params=RansacParams(n_hypotheses=64, ref_compat=False))
    carry, outs = sess.run(odom_poses, ranges, beam_angles)

The session's kernel path runs the fused gate, row-pair gather and
in-place covariance correction kernels instead: ``EKFParams(...,
pht_mode="rows", rows_gather="pallas", correction="gemm",
use_pallas=True)`` with f32 P.  The general-factor square-root session,
``EKFParams(..., update_mode="srekf_fast", rows_gather="pallas")``,
carries a square root S of P (P = S·Sᵀ) and recompresses it with a
blocked Cholesky every ``sr_noise_buffer`` ticks.
"""

from .config import EKFParams, RansacParams, SimConfig
from .session import SessionCarry, SlamSession
from .utils.schedule import tuned_params

__all__ = ["SlamSession", "SessionCarry", "EKFParams", "RansacParams",
           "SimConfig", "tuned_params"]
