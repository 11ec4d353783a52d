"""Concurrent submap SLAM: all map blocks advance at once (counterpart of
ekf_slam_tpu/parallel/parallel_submaps.py).

The T-tick stream is cut into S segments; segment s's filter starts at
the origin of its own frame (anchored at the robot pose entering the
segment) and is driven by the frame-invariant controls of its odometry
window.  The S segment filters advance in lockstep as one fleet
(parallel/multi.FleetSlamSession, robot s = segment s, drawing from
``seed + s``), so a run takes T/S fleet ticks instead of T session
ticks.  Anchors, odometry edges, loop closures and the global map are
inherited from SubmapSlam.  The mesh-sharded layout waits for the
sharded half of the distributed layer: a ``mesh`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.scan import scan_from_ranges, scan_to_world
from .multi import SHARDED_HALF, FleetSlamSession, tree_map
from .submaps import SubmapSlam, compose, host


@dataclasses.dataclass
class ParallelSubmapSlam(SubmapSlam):
    """S submaps advanced concurrently as one fleet, tied together by the
    inherited pose-graph layer."""

    n_submaps: int = 4
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(SHARDED_HALF)
        super().__post_init__()
        self.fleet = FleetSlamSession(
            n_sessions=self.n_submaps, ekf_params=self.ekf_params,
            ransac_params=self.ransac_params, seed=self.seed,
            device=self.device)

    # -- running --------------------------------------------------------------
    def run(self, odom, ranges, beam_angles,
            draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]
            = None) -> np.ndarray:
        """Consume the whole stream with all submaps advancing at once;
        returns global pose estimates [T,3] (numpy).  T must divide by
        n_submaps.  ``draws``: one pair a tick of the stream; segment s's
        tick i takes the pair of stream tick s·T/S + i."""
        odom = self._tensor(odom)
        ranges = self._tensor(ranges)
        T = odom.shape[0]
        S = self.n_submaps
        if T % S != 0:
            raise ValueError(f"T={T} must divide by n_submaps={S}")
        L = T // S

        # [T,...] → [L,S,...]: tick i of every segment advances together
        seg_odom = odom.reshape(S, L, 3).transpose(0, 1)
        seg_rng = ranges.reshape(S, L, -1).transpose(0, 1)
        seg_draws = (None if draws is None else
                     [[draws[s * L + i] for s in range(S)]
                      for i in range(L)])
        # each segment dead-reckons from the tick before its window, so no
        # control step is lost at a boundary (s = 0 anchors to its own
        # first tick: u = 0 on tick 0, as in the single-session run)
        first = torch.stack([odom[0]] + [odom[s * L - 1]
                                         for s in range(1, S)])

        carry = self.fleet.init_carry(first_odoms=first)
        carry, outs = self.fleet.run(seg_odom, seg_rng, beam_angles,
                                     carry=carry, draws=seg_draws)
        self._last_carry = carry      # for placement introspection and tests
        local = host(outs.pose)                               # [L,S,3]
        beams = self._tensor(beam_angles)

        # host side: chain anchors, freeze every submap, emit global poses
        poses = np.zeros((T, 3))
        for s in range(S):
            for i in range(L):
                poses[s * L + i] = compose(self._anchor, local[i, s])
            carry_s = tree_map(lambda a, s=s: a[s], carry)
            sc = scan_from_ranges(ranges[s * L], beams)
            pts0 = host(scan_to_world(
                sc, torch.as_tensor(local[0, s], device=self.device)
                .to(sc.ranges.dtype)))
            self._freeze_segment(carry_s, local[-1, s], scan_pts=pts0,
                                 scan_valid=host(sc.valid))
        return poses
