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

``SlamSession()`` as constructed runs the reference's sequential filter
(``update_mode="sequential"``, the one-seed wall search), and
``update_mode="srekf"`` the QR square-root filter.  In every update mode
the session also takes ``control_source="icp"`` or ``"fused"``
(scan-to-scan ICP, ops/icp.py), the fault guard
(``EKFParams(guard_max_jump=...)``, utils/faults.py) and map maintenance
(``maintain_merge_radius``, ``maintain_max_trace``,
models/maintenance.py).  The live operating path drives a session as
ticks arrive: ``io.stream.StreamingSlamSession`` (windows of ticks,
read back through one CUDA event a window), fed by ``push`` or by
``io.socket_feed.SocketScanSource`` over TCP, with the scan-log codec
(``io.scanlog``), the odometry quaternions (``utils.quat``) and the
filter-health metrics (``utils.metrics``).  A session's carry and
generator are checkpointed by ``utils.checkpointing`` (the stream's
heartbeats too), and ``utils.recovery`` runs a session with checkpoints
and resumes a killed one from the newest, bit for bit.  The exports
are the JAX package's but ``MeshConfig``, which comes with the
distributed layers (ROADMAP §1 item 6).
"""

from . import config
from .config import (ASSOC_KNOWN, ASSOC_ML, ASSOC_SIGNATURE, EKFParams,
                     RansacParams, SimConfig, ref_compat_known,
                     ref_compat_legacy, ref_compat_uc)
from .session import ALGORITHMS, EXTRACTORS, SessionCarry, SlamSession
from .state import FilterState, init_state
from .utils.schedule import tuned_params

__all__ = [
    "config", "EKFParams", "RansacParams", "SimConfig",
    "ASSOC_SIGNATURE", "ASSOC_ML", "ASSOC_KNOWN",
    "ref_compat_uc", "ref_compat_known", "ref_compat_legacy",
    "FilterState", "init_state",
    "SlamSession", "SessionCarry", "ALGORITHMS", "EXTRACTORS",
    "tuned_params",
]
