"""Submap SLAM: map-block partitioning tied together by the pose graph
(counterpart of ekf_slam_tpu/parallel/submaps.py).

The robot runs a normal session in the local frame of the current submap
(the filter starts at the origin).  When a submap ages out (a tick
budget) it is frozen, a keyframe node is dropped at its anchor, an
odometry edge joins consecutive anchors, and a fresh submap starts at the
current global pose.  Loop closures are edges between non-consecutive
anchors; the pose graph (parallel/posegraph.py) re-aligns all anchors, and
the global map is each submap's landmarks pushed through its optimised
anchor.

Transitions are host-driven, as in JAX: a segment's ticks run through the
session with nothing read back, and the host reads at the segment
boundary only (the landmark count, the segment's poses, its keyframe
scans) and in loop-closure detection (each ICP match's gates).  Each
segment starts from a fresh ``init_carry``, which reseeds the session's
generator, as each JAX segment's carry restarts from ``PRNGKey(seed)``;
``run(..., draws=)`` hands the extractor's draws in instead, one pair a
tick.  The helpers ``compose``, ``inverse_pose`` and ``transform_points``
are numpy on the host, as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import EKFParams, RansacParams
from ..ops.icp import icp as run_icp
from ..ops.scan import scan_from_ranges, scan_to_world, to_cartesian
from ..session import SessionCarry, SlamSession
from . import posegraph as pg


def compose(anchor: np.ndarray, local: np.ndarray) -> np.ndarray:
    """Global pose of ``local`` expressed in ``anchor``'s frame (degrees)."""
    th = np.deg2rad(anchor[2])
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return np.concatenate([
        anchor[:2] + R @ np.asarray(local[:2]),
        [np.mod(anchor[2] + local[2], 360.0)],
    ])


def inverse_pose(p: np.ndarray) -> np.ndarray:
    """SE(2) inverse: compose(p, inverse_pose(p)) = identity (degrees)."""
    th = np.deg2rad(p[2])
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return np.concatenate([-(R.T @ np.asarray(p[:2])),
                           [np.mod(-p[2], 360.0)]])


def transform_points(anchor: np.ndarray, pts: np.ndarray) -> np.ndarray:
    th = np.deg2rad(anchor[2])
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return pts @ R.T + anchor[:2]


def host(x: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host (one read where it lies on
    the card)."""
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class Submap:
    anchor: np.ndarray            # global pose of the submap frame at spawn
    node_id: int                  # pose-graph node of the anchor
    carry: SessionCarry           # frozen filter state (local frame)
    n_landmarks: int
    end_local_pose: np.ndarray    # robot pose in this submap at freeze time
    #: representative scan points in the SUBMAP frame (for ICP loop
    #: closures) and their mask
    scan_pts: Optional[np.ndarray] = None
    scan_valid: Optional[np.ndarray] = None
    #: keyframe scans along the segment (ROBOT-frame points at each
    #: keyframe tick) and their local poses in the submap frame, for the
    #: trajectory loop-closure detector
    kf_pts: Optional[np.ndarray] = None      # [Nk,B,2]
    kf_valid: Optional[np.ndarray] = None    # [Nk,B]
    kf_pose: Optional[np.ndarray] = None     # [Nk,3] local poses


@dataclasses.dataclass
class SubmapSlam:
    """Host-orchestrated submap pipeline over segments of session ticks
    (on CUDA unless given ``device='cpu'``)."""

    ekf_params: Optional[EKFParams] = None
    ransac_params: Optional[RansacParams] = None
    max_landmarks_per_submap: int = 24
    ticks_per_submap: int = 200
    seed: int = 0
    #: dtype of the pose-graph and loop-closure math; None follows the
    #: filter dtype
    graph_dtype: Optional[torch.dtype] = None
    #: extra SlamSession keyword arguments for the per-submap session
    session_kwargs: Optional[dict] = None
    #: global pose of the FIRST submap's frame (the world anchor)
    start_pose: Optional[np.ndarray] = None
    #: record a ROBOT-frame keyframe scan every this many ticks within a
    #: segment (for trajectory loop closures); 0 disables keyframes
    kf_every: int = 40
    device: Optional[object] = None

    def __post_init__(self):
        self.session = SlamSession(ekf_params=self.ekf_params,
                                   ransac_params=self.ransac_params,
                                   seed=self.seed, device=self.device,
                                   **(self.session_kwargs or {}))
        self.ekf_params = self.session.ekf_params
        self.device = self.session.device
        self._dt = (self.graph_dtype if self.graph_dtype is not None
                    else self.ekf_params.dtype)
        self.graph = pg.init_graph(256, 1024, self._dt, device=self.device)
        self.submaps: List[Submap] = []
        self._anchor = (np.zeros(3) if self.start_pose is None
                        else np.asarray(self.start_pose, np.float64))
        self.graph, self._node = pg.add_node(self.graph, self._anchor)
        self._segment_local: List[np.ndarray] = []
        # information = 1/sigma² on [m, m, RADIAN] residuals: a segment's
        # end-pose error is ~0.3 m / ~1.5 deg, so heading information is
        # two orders above position (JAX submaps.py:142-147)
        self._odo_info = np.array([10.0, 10.0, 1500.0])

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        t = torch.as_tensor(a, device=self.device)
        return t if dtype is None else t.to(dtype)

    # -- running ------------------------------------------------------------
    def run(self, odom, ranges, beam_angles,
            draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]
            = None) -> np.ndarray:
        """Feed the whole stream (odom [T,3], ranges [T,B], beam angles
        [B]; host arrays or tensors); returns the global pose estimates
        [T,3] (numpy).  ``draws``: the extractor's draws, one pair a tick.

        Each segment starts at the PREVIOUS tick's odometry, so its first
        step integrates the t0-1 → t0 motion and no tick of motion is lost
        at a boundary; under ICP control its carry is seeded with the
        t0-1 scan for the same reason (JAX submaps.py:159-186)."""
        odom = self._tensor(odom)
        ranges = self._tensor(ranges)
        beam_angles = self._tensor(beam_angles)
        T = odom.shape[0]
        poses = np.zeros((T, 3))
        is_icp = self.session.control_source in ("icp", "fused")
        t0 = 0
        while t0 < T:
            t1 = min(t0 + self.ticks_per_submap, T)
            seg_carry = self.session.init_carry(
                first_odom=odom[t0] if t0 == 0 else odom[t0 - 1],
                n_beams=ranges.shape[1] if is_icp else None)
            if is_icp and t0 > 0:
                scp = scan_from_ranges(ranges[t0 - 1], beam_angles)
                seg_carry = seg_carry._replace(
                    prev_pts=to_cartesian(scp).to(self.ekf_params.dtype),
                    prev_valid=scp.valid)
            seg_carry, outs = self.session.run(
                odom[t0:t1], ranges[t0:t1], beam_angles, carry=seg_carry,
                draws=None if draws is None else draws[t0:t1])
            local = host(outs.pose)
            self._segment_local.append(local)
            for i in range(t1 - t0):
                poses[t0 + i] = compose(self._anchor, local[i])
            # representative scan: the first tick's scan in the submap
            # frame (the robot starts at the submap origin)
            sc = scan_from_ranges(ranges[t0], beam_angles)
            pts0 = host(scan_to_world(
                sc, torch.zeros(3, dtype=sc.ranges.dtype,
                                device=self.device)))
            kf_pts = kf_valid = kf_pose = None
            if self.kf_every > 0:
                ks = list(range(0, t1 - t0, self.kf_every))
                sck = scan_from_ranges(ranges[t0 + ks[0]:t1:self.kf_every],
                                       beam_angles)
                kf_pts = host(to_cartesian(sck))
                kf_valid = host(sck.valid)
                kf_pose = np.stack([local[k] for k in ks])
            self._freeze_segment(seg_carry, local[-1], scan_pts=pts0,
                                 scan_valid=host(sc.valid), kf_pts=kf_pts,
                                 kf_valid=kf_valid, kf_pose=kf_pose)
            t0 = t1
        return poses

    def _freeze_segment(self, carry: SessionCarry, end_local: np.ndarray,
                        scan_pts=None, scan_valid=None, kf_pts=None,
                        kf_valid=None, kf_pose=None):
        """Freeze the current submap, drop a keyframe, spawn the next."""
        self.submaps.append(Submap(
            anchor=self._anchor.copy(), node_id=self._node,
            carry=carry, n_landmarks=int(carry.filt.n_active),
            end_local_pose=np.asarray(end_local),
            scan_pts=scan_pts, scan_valid=scan_valid,
            kf_pts=kf_pts, kf_valid=kf_valid, kf_pose=kf_pose))
        new_anchor = compose(self._anchor, end_local)
        self.graph, nid = pg.add_node(self.graph, new_anchor)
        # odometry edge: the measured relative pose between the two
        # anchors is the filter's end-of-segment local pose
        z = np.array([end_local[0], end_local[1],
                      np.mod(end_local[2] + 180.0, 360.0) - 180.0])
        self.graph = pg.add_edge(self.graph, self._node, nid,
                                 self._tensor(z, self._dt),
                                 self._tensor(self._odo_info, self._dt))
        self._anchor = new_anchor
        self._node = nid

    # -- loop closure / optimization -----------------------------------------
    def _relative(self, pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
        """``posegraph.relative_pose`` in the graph dtype on the device,
        read back: the seed of a loop-closure match."""
        return host(pg.relative_pose(self._tensor(pa, self._dt),
                                     self._tensor(pb, self._dt)))

    def detect_loop_closures(self, radius: float = 1.0,
                             min_separation: int = 2,
                             info=(200.0, 200.0, 200.0),
                             use_icp: bool = False,
                             icp_max_rmse: float = 0.1,
                             icp_min_inliers: int = 50) -> int:
        """Anchor-proximity loop closures: when two non-adjacent submap
        anchors lie within ``radius`` (by current estimates), add a
        relative-pose edge; with ``use_icp`` measured by matching the two
        submaps' stored scans, seeded from the anchor estimate and kept
        only under the rmse and inlier gates.  Returns the closures
        added."""
        added = 0
        for i in range(len(self.submaps)):
            for j in range(i + min_separation + 1, len(self.submaps)):
                a, b = self.submaps[i], self.submaps[j]
                if np.linalg.norm(a.anchor[:2] - b.anchor[:2]) >= radius:
                    continue
                z0 = self._relative(a.anchor, b.anchor)
                if (use_icp and a.scan_pts is not None
                        and b.scan_pts is not None):
                    # points of j's frame aligned into i's frame:
                    # p_i = T(z_ij) · p_j; ICP refines z_ij from z0
                    res = run_icp(
                        self._tensor(b.scan_pts, self._dt),
                        self._tensor(b.scan_valid),
                        self._tensor(a.scan_pts, self._dt),
                        self._tensor(a.scan_valid),
                        init_pose=self._tensor(z0, self._dt), iters=25)
                    if (float(res.rmse) > icp_max_rmse
                            or int(res.n_inliers) < icp_min_inliers):
                        continue
                    z = host(res.pose).copy()
                    z[2] = np.mod(z[2] + 180.0, 360.0) - 180.0
                else:
                    z = z0
                self.add_loop_closure(i, j, z, info)
                added += 1
        return added

    def detect_loop_closures_traj(self, ranges, beam_angles,
                                  radius: float = 10.0,
                                  min_separation: int = 1,
                                  info=(6.0, 6.0, 3000.0),
                                  icp_max_rmse: float = 0.12,
                                  icp_min_inliers: int = 120,
                                  icp_max_pair_dist: float = 2.0,
                                  max_per_pair: int = 1,
                                  max_corr_xy: float = 4.0,
                                  max_corr_deg: float = 15.0) -> int:
        """Trajectory loop closures (JAX submaps.py:275-384): walk each
        segment's per-tick global pose estimates; where the robot passes
        within ``radius`` of an EARLIER submap's keyframe, ICP-match that
        tick's scan (robot frame) against the keyframe's, coarse then
        fine, seeded from the current estimate; the match gives the
        robot's pose in the old submap's frame, hence an edge between the
        two anchors, z_ij = (kf_pose ∘ z_icp) ∘ (local_j[t])⁻¹.  Accepted
        only under the rmse and inlier gates and within the plausible
        drift envelope (``max_corr_xy``, ``max_corr_deg``).  ``ranges``
        and ``beam_angles`` are the stream ``run`` consumed.  Returns the
        closures added."""
        ranges = self._tensor(ranges)
        beams = self._tensor(beam_angles, self._dt)
        added = 0
        t_base = 0
        for j, (smj, local_j) in enumerate(zip(self.submaps,
                                               self._segment_local)):
            glob = np.stack([compose(smj.anchor, p) for p in local_j])
            for i in range(0, j - min_separation):
                smi = self.submaps[i]
                if smi.kf_pts is None:
                    continue
                # global poses of submap i's keyframes (current estimates)
                kf_glob = np.stack([compose(smi.anchor, p)
                                    for p in smi.kf_pose])
                # nearest (segment tick, keyframe) pairs
                d = np.hypot(glob[:, None, 0] - kf_glob[None, :, 0],
                             glob[:, None, 1] - kf_glob[None, :, 1])
                n_pair = 0
                while n_pair < max_per_pair:
                    t, kf = np.unravel_index(np.argmin(d), d.shape)
                    if d[t, kf] >= radius:
                        break
                    d[t, :] = np.inf      # one closure per tick/keyframe
                    d[:, kf] = np.inf
                    sc = scan_from_ranges(
                        ranges[t_base + t].to(self._dt), beams)
                    # seed: the robot's pose in the KEYFRAME's robot frame
                    # by the current estimates
                    z0 = self._relative(kf_glob[kf], glob[t])
                    a = (to_cartesian(sc), sc.valid,
                         self._tensor(smi.kf_pts[kf], self._dt),
                         self._tensor(smi.kf_valid[kf]))
                    # coarse-to-fine: a first pass pairs coarsely to pull
                    # the drift in, a tight pass re-pairs, and the gates
                    # read the tight pass
                    coarse = run_icp(*a, init_pose=self._tensor(z0, self._dt),
                                     iters=25,
                                     max_pair_dist=icp_max_pair_dist)
                    res = run_icp(*a, init_pose=coarse.pose, iters=15,
                                  max_pair_dist=0.5)
                    if (float(res.rmse) > icp_max_rmse
                            or int(res.n_inliers) < icp_min_inliers):
                        continue
                    # perceptual-aliasing guard: a closure correcting more
                    # than the plausible drift envelope is rejected
                    z_fine = host(res.pose).astype(np.float64)
                    dxy = float(np.hypot(z_fine[0] - z0[0],
                                         z_fine[1] - z0[1]))
                    dth = abs(((z_fine[2] - z0[2]) + 180.0) % 360.0
                              - 180.0)
                    if dxy > max_corr_xy or dth > max_corr_deg:
                        continue
                    # robot in submap i's frame = kf_pose ∘ z_icp; edge
                    # z_ij = (robot in i) ∘ (robot in j)⁻¹
                    z = compose(compose(smi.kf_pose[kf], z_fine),
                                inverse_pose(local_j[t]))
                    z[2] = np.mod(z[2] + 180.0, 360.0) - 180.0
                    self.add_loop_closure(i, j, z, info)
                    added += 1
                    n_pair += 1
            t_base += len(local_j)
        return added

    def add_loop_closure(self, i: int, j: int, z_rel, info=(200.0, 200.0,
                                                           200.0)):
        """Relative-pose constraint between submap i's and submap j's
        anchors (e.g. from scan matching or re-observed landmarks)."""
        self.graph = pg.add_edge(
            self.graph, self.submaps[i].node_id, self.submaps[j].node_id,
            self._tensor(np.asarray(z_rel), self._dt),
            self._tensor(np.asarray(info), self._dt))

    def optimize(self, iters: int = 15) -> bool:
        """Re-align all anchors (the host float64 solve, ``optimize_np``);
        updates each submap's stored anchor.  Returns False, leaving the
        anchors untouched, if the optimised nodes are not finite."""
        before = self.graph
        self.graph = pg.optimize_np(self.graph, iters=iters)
        nodes = host(self.graph.nodes)
        n = self.graph.n_nodes
        if not np.all(np.isfinite(nodes[:n])):
            self.graph = before
            return False
        for sm in self.submaps:
            sm.anchor = nodes[sm.node_id].copy()
            sm.anchor[2] = np.mod(sm.anchor[2], 360.0)
        return True

    # -- global map -----------------------------------------------------------
    def global_landmarks(self) -> np.ndarray:
        """All landmarks, each submap's pushed through its (optimised)
        anchor, concatenated [N,2]."""
        out = []
        for sm in self.submaps:
            n = sm.n_landmarks
            if n == 0:
                continue
            local = host(sm.carry.filt.x[3:3 + 2 * n]).reshape(n, 2)
            out.append(transform_points(sm.anchor, local))
        return (np.concatenate(out, axis=0) if out
                else np.zeros((0, 2)))

    def global_trajectory_nodes(self) -> np.ndarray:
        """Optimised anchor poses [S+1, 3] (the keyframe trajectory)."""
        return host(self.graph.nodes[:self.graph.n_nodes])

    def global_poses(self) -> np.ndarray:
        """Per-tick global pose estimates [T,3] recomposed through the
        CURRENT anchors (``run`` returns the composition before any
        ``optimize``)."""
        out = []
        for sm, local in zip(self.submaps, self._segment_local):
            out.append(np.stack([compose(sm.anchor, p) for p in local]))
        return (np.concatenate(out, axis=0) if out
                else np.zeros((0, 3)))
