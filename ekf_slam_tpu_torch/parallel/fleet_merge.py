"""Multi-robot map merging: N independent sessions → one global map
(counterpart of ekf_slam_tpu/parallel/fleet_merge.py).

Each robot of a fleet (parallel/multi.py) maps in its own frame.  This
module fuses the fleet's maps into robot 0's frame:

* one pose-graph node per robot, the global pose of its map frame,
  initialised from a coarse deployment guess;
* a weak prior edge pins each guess, and pairwise scan-match edges
  (ops/icp.py between the robots' representative scans, seeded from the
  guesses and accepted under rmse and inlier gates) supply the precise
  alignment;
* Gauss-Newton over the graph (``posegraph.optimize``, on the device in
  ``dtype``), then every robot's landmarks go through its optimised frame
  and near-duplicates are merged on the host.

Anchors, scans and landmarks are host data (numpy), as in JAX; the ICP
matches and the graph solve run on ``device`` (CUDA unless given
``device='cpu'``) and read back each match's gates and the anchors.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..config import resolve_device
from ..ops.icp import icp as run_icp
from ..ops.scan import scan_from_ranges, scan_to_world
from . import posegraph as pg
from .submaps import host, transform_points


@dataclasses.dataclass
class RobotMap:
    """One robot's contribution: its local map and a coarse global
    anchor."""
    anchor_guess: np.ndarray      # f[3] global pose of the robot's frame
    scan_pts: np.ndarray          # f[B,2] representative scan, robot FRAME
    scan_valid: np.ndarray        # bool[B]
    landmarks: np.ndarray         # f[n,2] local landmark estimates


class MergeResult(NamedTuple):
    anchors: np.ndarray           # f[N,3] optimised robot-frame poses
    landmarks: np.ndarray         # f[M,2] merged global landmarks
    n_before_merge: int           # landmark count before dedup
    n_icp_edges: int              # accepted inter-robot alignments
    graph: "pg.PoseGraph"


def robot_map_from_carry(carry, ranges0, beam_angles, anchor_guess,
                         local_pose=None) -> RobotMap:
    """A RobotMap from one robot's session carry and its first scan, on
    the carry's device.  ``local_pose``: the robot's pose in its own frame
    when ``ranges0`` was taken (the origin for the first tick)."""
    dev = carry.filt.x.device
    sc = scan_from_ranges(torch.as_tensor(ranges0, device=dev),
                          torch.as_tensor(beam_angles, device=dev))
    pose = (torch.zeros(3, dtype=sc.ranges.dtype, device=dev)
            if local_pose is None
            else torch.as_tensor(local_pose, device=dev).to(sc.ranges.dtype))
    n = int(carry.filt.n_active)
    lms = host(carry.filt.x[3:3 + 2 * n]).reshape(n, 2)
    return RobotMap(anchor_guess=np.asarray(anchor_guess, np.float64),
                    scan_pts=host(scan_to_world(sc, pose)),
                    scan_valid=host(sc.valid),
                    landmarks=lms)


def _dedupe(points: np.ndarray, radius: float) -> np.ndarray:
    """Greedy merge of points within ``radius`` (cluster means)."""
    out: List[np.ndarray] = []
    counts: List[int] = []
    for p in points:
        for k, q in enumerate(out):
            if np.linalg.norm(p - q) < radius:
                out[k] = (q * counts[k] + p) / (counts[k] + 1)
                counts[k] += 1
                break
        else:
            out.append(p.astype(np.float64))
            counts.append(1)
    return np.asarray(out) if out else np.zeros((0, 2))


def merge_maps(maps: Sequence[RobotMap], icp_iters: int = 25,
               icp_max_rmse: float = 0.15, icp_min_inliers: int = 80,
               guess_info=(2.0, 2.0, 2.0), icp_info=(300.0, 300.0, 300.0),
               merge_radius: float = 0.3, opt_iters: int = 15,
               dtype=None, device=None) -> MergeResult:
    """Fuse N robot maps into robot 0's frame (see the module doc).

    ``dtype``: the dtype of the graph and ICP math; defaults to the scan
    points' dtype (f32 for maps read from the card)."""
    dev = resolve_device(device)
    N = len(maps)
    dt = (dtype if dtype is not None
          else torch.from_numpy(np.asarray(maps[0].scan_pts)).dtype)

    def vec(a):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    graph = pg.init_graph(max(8, N), max(16, N * N), dt, device=dev)
    ids = []
    for m in maps:
        graph, nid = pg.add_node(graph, vec(m.anchor_guess))
        ids.append(nid)

    # weak priors: keep every frame near its deployment guess
    for k in range(1, N):
        z = pg.relative_pose(vec(maps[0].anchor_guess),
                             vec(maps[k].anchor_guess))
        graph = pg.add_edge(graph, ids[0], ids[k], z, vec(guess_info))

    # precise alignment: pairwise scan matches seeded from the guesses
    n_icp = 0
    for i in range(N):
        for j in range(i + 1, N):
            a, b = maps[i], maps[j]
            z0 = pg.relative_pose(vec(a.anchor_guess), vec(b.anchor_guess))
            res = run_icp(vec(b.scan_pts),
                          torch.as_tensor(b.scan_valid, device=dev),
                          vec(a.scan_pts),
                          torch.as_tensor(a.scan_valid, device=dev),
                          init_pose=z0, iters=icp_iters)
            if (float(res.rmse) > icp_max_rmse
                    or int(res.n_inliers) < icp_min_inliers):
                continue
            z = host(res.pose).copy()
            z[2] = np.mod(z[2] + 180.0, 360.0) - 180.0
            graph = pg.add_edge(graph, ids[i], ids[j], vec(z),
                                vec(icp_info))
            n_icp += 1

    graph = pg.optimize(graph, iters=opt_iters)
    anchors = host(graph.nodes[:N]).copy()
    anchors[:, 2] = np.mod(anchors[:, 2], 360.0)

    pts = [transform_points(anchors[k], maps[k].landmarks)
           for k in range(N) if maps[k].landmarks.shape[0]]
    all_pts = (np.concatenate(pts, axis=0) if pts else np.zeros((0, 2)))
    merged = _dedupe(all_pts, merge_radius)
    return MergeResult(anchors=anchors, landmarks=merged,
                       n_before_merge=int(all_pts.shape[0]),
                       n_icp_edges=n_icp, graph=graph)
