"""SLAM session orchestrator (counterpart of ekf_slam_tpu/session.py;
SLAM.m:70-144).

One tick with odometry control:

    scan_from_ranges → predict → ransac.extract → measure

where predict and measure follow ``update_mode``:
- 'sequential' (the default, the reference's chain): ``ekf.predict``,
  then ``ekf.measure``, each observation gated (``association.gate``)
  and applied in turn;
- 'batched': ``ekf.predict``, then ``batched.measure_batched``
  (``gate_batch`` → ``update_chunked`` → ``ekf.append``), on the tuned
  schedule (utils/schedule.tuned_params: rows, bf16 P, the SYRK kernel)
  or the kernel path (``use_pallas=True, rows_gather='pallas',
  correction='gemm'``: the fused gate, row-pair gather and in-place
  correction kernels);
- 'srekf' (the QR square-root filter, models/srekf.py): the triangular
  factor L (P = L·Lᵀ) carried in the P field, ``sr_predict`` and
  ``sr_measure_batched``;
- 'srekf_fast' (the general-factor square-root filter,
  models/srekf_fast.py): the factor S carried in the P field, recompressed
  every ``sr_noise_buffer`` ticks.

The JAX session compiles the tick once and scans it over a sequence; here
``run`` is a Python loop over ticks and each tick issues the same ops on
the same shapes, with no host read of a device value (the data-dependent
branches are masked selects), so the host only enqueues work.  No host
sync remains in a tick but the square-root recompression's one and map
maintenance's one (below): chip_smoke.py counts them with PyTorch's
sync-debug mode.

The covariance is updated in place, as the JAX session's donated carry
is (session.py:134-143): ``step`` consumes the carry it is given; keep
only the returned one.  The extractor's random draws come from the
session's ``torch.Generator`` on its device, reseeded with ``seed`` by
every ``init_carry`` (as every JAX carry starts from ``PRNGKey(seed)``),
unless ``step``/``run`` are given explicit draws ``(u, s)`` — the JAX
package draws them from threefry, which torch cannot reproduce, so
parity runs hand the JAX draws in.

Under 'srekf_fast' the recompression schedule is kept on the host: the
carry's ``sr_tick`` is a Python int, so the tick that recompresses and
the noise column of each predict are known without a read from the
device; the recompression itself reads one flag back (its QR branch,
srekf_fast.sr_recompress), so that tick syncs once.

The control u = [ΔD, Δθ] comes from ``control_source``: 'odometry'
dead-reckons consecutive odometry poses; 'icp' matches each scan onto
the previous one (ops/icp.py, seeded with the previous tick's control);
'fused' computes both and takes ICP's where its quality gates pass.
ICP runs a fixed number of iterations and reads nothing back.

With ``EKFParams(guard_max_jump=...)`` the filter state after extract is
copied before the measurement (P into one buffer the session allocates
once, since the measurement overwrites P in place), and
``utils/faults.guarded`` selects, on the device, between the measured
state and that copy.  Map maintenance (``maintain_merge_radius``,
``maintain_max_trace``) runs after the guard and before the
recompression, as in JAX; it reads its drop count to the host once a
tick and evicts only when it is above zero (models/maintenance.py), so a
tick with maintenance on syncs once, and a factored tick that evicts
twice (the recompression's flag as well).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .config import (EKFParams, RansacParams, ref_compat_known,
                     ref_compat_uc, resolve_device)
from .models import ekf
from .models.batched import measure_batched
from .models.maintenance import maintain
from .models.srekf import (factor_from_state, sr_measure_batched,
                           sr_predict, sr_strips)
from .models.srekf_fast import sr_measure_fast, sr_predict_fast, sr_recompress
from .ops.angles import angdiff_deg, cosd, sind
from .ops.association import batch_costs, gate_batch
from .ops.icp import icp
from .ops.observations import ObsBatch
from .ops.ransac import LandmarkTable, extract, init_table
from .ops.scan import scan_from_ranges, to_cartesian
from .state import FilterState, init_state
from .utils.faults import guarded

ALGORITHMS: Dict[str, Callable[..., EKFParams]] = {
    "EKF_SLAM": ref_compat_known,
    "EKF_SLAM_UC": ref_compat_uc,
}

EXTRACTORS = {"RANSAC": (init_table, extract)}


class SessionCarry(NamedTuple):
    """Everything that persists across ticks.  The JAX carry's PRNG key
    has no counterpart: the session's generator holds the random state."""
    filt: FilterState
    table: LandmarkTable
    old_odom: torch.Tensor   # f[3] previous odometry pose (SLAM.m:100-113)
    #: the previous scan in the robot frame and its mask, and the previous
    #: tick's control (the constant-velocity seed of the next scan
    #: match): carried under control_source 'icp' or 'fused' only
    prev_pts: Optional[torch.Tensor] = None     # f[B,2]
    prev_valid: Optional[torch.Tensor] = None   # bool[B]
    prev_u: Optional[torch.Tensor] = None       # f[2]
    #: ticks run so far under update_mode='srekf_fast' (None otherwise): a
    #: host int, where the JAX carry holds a device i32
    sr_tick: Optional[int] = None


class StepOutput(NamedTuple):
    pose: torch.Tensor       # estimated robot pose after the tick
    n_active: torch.Tensor   # landmark count
    n_obs: torch.Tensor      # observations processed this tick
    u: torch.Tensor          # control used
    obs: ObsBatch            # the tick's observation batch
    #: per-observation NIS against the associated slot (NaN for invalid
    #: or new rows), with collect_nis=True only
    nis: Optional[torch.Tensor] = None
    #: the port's records of the tick's decisions (the JAX StepOutput has
    #: none of them), each a device scalar: whether the fused control
    #: took ICP's estimate ('fused' only), whether the guard accepted the
    #: measurement (guard on only), and how many landmarks maintenance
    #: evicted (maintenance on only)
    icp_ok: Optional[torch.Tensor] = None
    guard_ok: Optional[torch.Tensor] = None
    n_evicted: Optional[torch.Tensor] = None


@dataclasses.dataclass
class SlamSession:
    """``SlamSession(ekf_params=..., ransac_params=...).run(odom, ranges,
    beams)`` on the card (``device=None`` → CUDA; pass ``device='cpu'``
    to run on the CPU)."""

    algorithm: str = "EKF_SLAM_UC"
    extractor: str = "RANSAC"
    ekf_params: Optional[EKFParams] = None
    ransac_params: Optional[RansacParams] = None
    seed: int = 0
    #: 'odometry', 'icp' or 'fused' (see the module docstring)
    control_source: str = "odometry"
    icp_iters: int = 15
    icp_max_pair_dist: float = 0.5
    #: sign ΔD by the ICP translation's direction in the previous robot
    #: frame, so backward motion gives a negative ΔD
    icp_signed: bool = True
    #: fused-mode quality gates: ICP wins only with at least this many
    #: inlier pairs and at most this RMS residual
    icp_min_inliers: int = 30
    icp_max_rmse: float = 0.25
    #: map maintenance after each tick's measurement: merge duplicates
    #: within this radius, evict landmarks whose 2×2 trace exceeds this
    #: (0 = off each)
    maintain_merge_radius: float = 0.0
    maintain_max_trace: float = 0.0
    collect_nis: bool = False
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; "
                f"choose from {sorted(ALGORITHMS)}")
        if self.extractor not in EXTRACTORS:
            raise ValueError(
                f"unknown extractor {self.extractor!r}; "
                f"choose from {sorted(EXTRACTORS)}")
        if self.control_source not in ("odometry", "icp", "fused"):
            raise ValueError(
                f"unknown control_source {self.control_source!r}; "
                f"choose from ['fused', 'icp', 'odometry']")
        if self.ekf_params is None:
            self.ekf_params = ALGORITHMS[self.algorithm]()
        if self.ransac_params is None:
            self.ransac_params = RansacParams(dtype=self.ekf_params.dtype)
        self._snap = None       # the guard's copy of P, allocated once
        self._init_table, self._extract = EXTRACTORS[self.extractor]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    # -- construction -------------------------------------------------------
    def init_carry(self, first_odom=None, n_beams: Optional[int] = None,
                   init_pose=None) -> SessionCarry:
        """Initial carry.  Under correction='syrk' the state is padded to a
        multiple of 512, as the JAX session pads it for its kernel
        (session.py:204-214), so both packages run the same D; under
        'srekf_fast' it gains ``sr_noise_buffer`` spare dims and carries
        its Cholesky factor (session.py:195-202); under 'srekf' it carries
        the Cholesky factor of the unpadded state (session.py:215-218).
        ``init_pose`` anchors the filter at [x, y, theta_deg].  Under
        control_source 'icp' or 'fused' the carry holds an empty previous
        scan of ``n_beams`` beams (so the first tick's ICP finds no pair
        and its u is 0) and a zero previous control; without ``n_beams``
        that raises, as in JAX (session.py:225-234).  Every carry restarts
        the extractor's draws: the generator is reseeded with ``seed``, as
        the JAX carry's key is ``PRNGKey(seed)`` (session.py:239)."""
        ep = self.ekf_params
        self.generator.manual_seed(self.seed)
        sr_tick = None
        if ep.update_mode == "srekf_fast":
            filt = factor_from_state(init_state(
                ep, extra_dims=ep.sr_noise_buffer, device=self.device))
            sr_tick = 0
        else:
            pad = 512 if ep.correction == "syrk" else 1
            filt = init_state(ep, pad_to_multiple_of=pad, device=self.device)
            if ep.update_mode == "srekf":
                filt = factor_from_state(filt)
        if init_pose is not None:
            x = filt.x.clone()
            x[:3] = torch.as_tensor(init_pose, dtype=x.dtype)
            filt = filt._replace(x=x)
        old = (torch.zeros((3,), dtype=ep.dtype, device=self.device)
               if first_odom is None
               else torch.as_tensor(first_odom, device=self.device
                                    ).to(ep.dtype))
        prev_pts = prev_valid = prev_u = None
        if self.control_source in ("icp", "fused"):
            if n_beams is None:
                raise ValueError(
                    f"control_source={self.control_source!r} needs n_beams "
                    "at init_carry (the previous scan is part of the carry)")
            prev_pts = torch.zeros((n_beams, 2), dtype=ep.dtype,
                                   device=self.device)
            prev_valid = torch.zeros((n_beams,), dtype=torch.bool,
                                     device=self.device)
            prev_u = torch.zeros((2,), dtype=ep.dtype, device=self.device)
        return SessionCarry(filt=filt,
                            table=self._init_table(self.ransac_params,
                                                   device=self.device),
                            old_odom=old, prev_pts=prev_pts,
                            prev_valid=prev_valid, prev_u=prev_u,
                            sr_tick=sr_tick)

    def _nis(self, filt: FilterState, obs: ObsBatch) -> torch.Tensor:
        """Per-observation NIS against the pre-measure state the
        measurement phase associates with (session.py:326-353)."""
        ep = self.ekf_params
        zs = torch.stack([obs.rng, obs.bearing, obs.index.to(ep.dtype)],
                         dim=-1)
        Rs = ekf.obs_noise_batch(obs, zs, ep)
        strips = (sr_strips(filt.P, ep.capacity,
                            triangular=ep.update_mode == "srekf")
                  if ep.update_mode in ("srekf", "srekf_fast") else None)
        if ep.association == "known":
            is_new = zs[:, 2] > filt.n_active.to(ep.dtype)
            slots = torch.clamp(obs.index - 1, 0, ep.capacity - 1)
        else:
            is_new, slots = gate_batch(filt, zs, Rs, ep, strips=strips)[:2]
        pos_cost, _ = batch_costs(filt, zs, Rs, ep, strips=strips)
        got = obs.valid & ~is_new & (filt.n_active > 0)
        at = pos_cost.gather(1, slots[:, None].to(torch.int64))[:, 0]
        return torch.where(got, at, float("nan")).to(ep.dtype)

    def step(self, carry: SessionCarry, odom_pose, ranges, beam_angles,
             draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[SessionCarry, StepOutput]:
        """One runSlam() tick (SLAM.m:70-144 minus plotting).  Consumes
        ``carry`` (P is updated in place)."""
        ep, rp = self.ekf_params, self.ransac_params
        dev = self.device
        odom_pose = torch.as_tensor(odom_pose, device=dev)
        scan = scan_from_ranges(torch.as_tensor(ranges, device=dev),
                                torch.as_tensor(beam_angles, device=dev))
        prev_pts = prev_valid = prev_u = icp_ok = None
        if self.control_source in ("icp", "fused"):
            dD, dTh, icp_ok, prev_pts, prev_valid = self._icp_control(
                carry, scan, odom_pose)
        else:
            dD, dTh = _odometry_control(carry.old_odom, odom_pose)
        u = torch.stack([dD, dTh]).to(ep.dtype)
        if self.control_source in ("icp", "fused"):
            prev_u = u

        mode = ep.update_mode
        sr = mode == "srekf_fast"
        if sr:
            # this tick's fresh zero column of the factor: the buffer
            # starts right past the last slot dim (3+2K)
            col = ep.dim + carry.sr_tick % ep.sr_noise_buffer
            filt = sr_predict_fast(carry.filt, u, ep, col)
        elif mode == "srekf":
            filt = sr_predict(carry.filt, u, ep)
        else:
            filt = ekf.predict(carry.filt, u, ep)              # SLAM.m:110
        obs, table = self._extract(carry.table, scan, filt.x, filt.n_active,
                                   rp, ep.max_obs, sig=filt.sig,
                                   draws=draws, generator=self.generator)
        nis = self._nis(filt, obs) if self.collect_nis else None
        factored = mode in ("srekf", "srekf_fast")
        guard = ep.guard_max_jump is not None
        if guard:
            before = self._snapshot(filt)
        if sr:
            filt = sr_measure_fast(filt, obs, u, ep)
        elif mode == "srekf":
            filt = sr_measure_batched(filt, obs, u, ep)
        elif mode == "batched":
            filt = measure_batched(filt, obs, u, ep)
        else:
            filt = ekf.measure(filt, obs, u, ep)               # SLAM.m:116
        guard_ok = n_evicted = None
        if guard:
            # JAX session.py:367-371: the filter only, not the table
            filt, verdict = guarded(before, filt, ep.guard_max_jump,
                                    factored=factored)
            guard_ok = verdict.ok
        if self.maintain_merge_radius > 0 or self.maintain_max_trace > 0:
            # one host read of the drop count (models/maintenance.py)
            filt, n_evicted = maintain(
                filt, ep, merge_radius=self.maintain_merge_radius,
                max_trace=self.maintain_max_trace, factored=factored)
        sr_tick = carry.sr_tick
        if sr:
            # every sr_noise_buffer ticks the spare columns run out:
            # recompress the general factor back to triangular
            # (session.py:383-392), decided on the host
            if (sr_tick + 1) % ep.sr_noise_buffer == 0:
                filt = sr_recompress(filt)
            sr_tick += 1
        out = StepOutput(pose=filt.x[:3].clone(), n_active=filt.n_active,
                         n_obs=obs.valid.sum().to(torch.int32), u=u,
                         obs=obs, nis=nis, icp_ok=icp_ok, guard_ok=guard_ok,
                         n_evicted=n_evicted)
        return SessionCarry(filt=filt, table=table,
                            old_odom=odom_pose.to(ep.dtype),
                            prev_pts=prev_pts, prev_valid=prev_valid,
                            prev_u=prev_u, sr_tick=sr_tick), out

    def _icp_control(self, carry: SessionCarry, scan, odom_pose):
        """Scan-to-scan control (JAX session.py:253-304): align this scan
        onto the previous one in the robot frame, seeded with the previous
        tick's control (the chord at the half-angle heading and the turn);
        ΔD signed by the translation's direction under ``icp_signed``.
        Under 'fused' the dead-reckoned odometry replaces ICP's estimate
        where its quality gates fail.  Returns (ΔD, Δθ, the fused gate or
        None, this scan's points and mask)."""
        ep = self.ekf_params
        pts = to_cartesian(scan).to(ep.dtype)
        pD, pTh = carry.prev_u[0], carry.prev_u[1]
        seed = torch.stack([pD * cosd(0.5 * pTh), pD * sind(0.5 * pTh),
                            pTh])
        res = icp(pts, scan.valid, carry.prev_pts, carry.prev_valid,
                  iters=self.icp_iters, init_pose=seed,
                  max_pair_dist=self.icp_max_pair_dist)
        dTh = res.pose[2]
        mag = torch.sqrt(res.pose[0] * res.pose[0]
                         + res.pose[1] * res.pose[1])
        if self.icp_signed:
            half = dTh * 0.5
            proj = res.pose[0] * cosd(half) + res.pose[1] * sind(half)
            dD = torch.where(proj < 0, -mag, mag)
        else:
            dD = mag
        ok = None
        if self.control_source == "fused":
            dD_o, dTh_o = _odometry_control(carry.old_odom, odom_pose)
            ok = ((res.n_inliers >= self.icp_min_inliers)
                  & (res.rmse <= self.icp_max_rmse))
            dD = torch.where(ok, dD, dD_o)
            dTh = torch.where(ok, dTh, dTh_o)
        return dD, dTh, ok, pts, scan.valid

    def _snapshot(self, filt: FilterState) -> FilterState:
        """The guard's copy of the state before the measurement: P copied
        into the session's one buffer (allocated on first use, or when
        P's shape, dtype or device changes), the small fields cloned."""
        P, buf = filt.P, self._snap
        if (buf is None or buf.shape != P.shape or buf.dtype != P.dtype
                or buf.device != P.device):
            buf = self._snap = torch.empty_like(P)
        buf.copy_(P)
        return FilterState(x=filt.x.clone(), P=buf, sig=filt.sig.clone(),
                           active=filt.active.clone(),
                           n_active=filt.n_active.clone())

    def run(self, odom_poses, ranges, beam_angles,
            carry: Optional[SessionCarry] = None,
            draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]
            = None) -> Tuple[SessionCarry, StepOutput]:
        """Run a sequence tick by tick: odom_poses f[T,3], ranges f[T,B],
        beam_angles f[B]; ``draws`` optionally one (u, s) pair per tick
        (the extractor's: see ransac.extract).
        Returns the final carry and the per-tick outputs stacked on a
        leading T axis."""
        odom_poses = torch.as_tensor(odom_poses, device=self.device)
        ranges = torch.as_tensor(ranges, device=self.device)
        if carry is None:
            carry = self.init_carry(
                first_odom=odom_poses[0],
                n_beams=(ranges.shape[1]
                         if self.control_source in ("icp", "fused")
                         else None))
        outs = []
        for t in range(odom_poses.shape[0]):
            carry, out = self.step(carry, odom_poses[t], ranges[t],
                                   beam_angles,
                                   draws=None if draws is None else draws[t])
            outs.append(out)
        return carry, stack_outputs(outs)


def _odometry_control(old: torch.Tensor, odom_pose: torch.Tensor):
    """(ΔD, Δθ) from consecutive odometry poses (SLAM.m:105-107)."""
    dD = torch.sqrt((odom_pose[0] - old[0]) ** 2
                    + (odom_pose[1] - old[1]) ** 2)
    return dD, angdiff_deg(old[2], odom_pose[2])


def stack_outputs(outs: Sequence[StepOutput]) -> StepOutput:
    """Per-tick StepOutputs → one StepOutput with a leading T axis."""
    def stack(get):
        vals = [get(o) for o in outs]
        return None if vals[0] is None else torch.stack(vals)
    obs = ObsBatch(*(stack(lambda o, i=i: o.obs[i])
                     for i in range(len(ObsBatch._fields))))
    return StepOutput(pose=stack(lambda o: o.pose),
                      n_active=stack(lambda o: o.n_active),
                      n_obs=stack(lambda o: o.n_obs),
                      u=stack(lambda o: o.u), obs=obs,
                      nis=stack(lambda o: o.nis),
                      icp_ok=stack(lambda o: o.icp_ok),
                      guard_ok=stack(lambda o: o.guard_ok),
                      n_evicted=stack(lambda o: o.n_evicted))
