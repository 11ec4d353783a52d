"""Keyframe pose graph: SE(2) Gauss-Newton (counterpart of
ekf_slam_tpu/parallel/posegraph.py).

Keyframe poses and relative-pose constraints (odometry chains, loop
closures, inter-robot scan matches), optimised by fixed-iteration
Gauss-Newton.  The node and edge tables are fixed-capacity and masked, as
in JAX: an invalid entry contributes zero information.  Angles are degrees
at the API and radians inside.

Departures from the JAX module:
- ``n_nodes`` and ``n_edges`` are host ints, as the session's ``sr_tick``
  is, so appending reads nothing back from the device; ``add_node`` and
  ``add_edge`` take host node ids.
- ``optimize`` (the device solve) assembles the normal equations with
  ``index_put_(..., accumulate=True)`` and solves them with
  ``torch.linalg.solve_ex``, which reads no error flag back (a singular
  system gives non-finite nodes, as JAX's solve does).  On CUDA the
  accumulation runs on atomics, in no fixed order.
- ``optimize_np`` is the same host float64 solve as JAX's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..ops.angles import wrap_to_180

_D2R = math.pi / 180.0


class PoseGraph(NamedTuple):
    nodes: torch.Tensor       # f[Nk,3] keyframe poses (x, y, theta_deg)
    node_valid: torch.Tensor  # bool[Nk]
    edge_ij: torch.Tensor     # i64[Ne,2] (from, to) node ids
    edge_z: torch.Tensor      # f[Ne,3] relative pose measurement (deg)
    edge_info: torch.Tensor   # f[Ne,3] diagonal information (x, y, theta)
    edge_valid: torch.Tensor  # bool[Ne]
    n_nodes: int              # host int (JAX: a device i32)
    n_edges: int              # host int (JAX: a device i32)


def init_graph(max_nodes: int = 256, max_edges: int = 1024,
               dtype=torch.float32, device=None) -> PoseGraph:
    dev = resolve_device(device)
    return PoseGraph(
        nodes=torch.zeros((max_nodes, 3), dtype=dtype, device=dev),
        node_valid=torch.zeros((max_nodes,), dtype=torch.bool, device=dev),
        edge_ij=torch.zeros((max_edges, 2), dtype=torch.int64, device=dev),
        edge_z=torch.zeros((max_edges, 3), dtype=dtype, device=dev),
        edge_info=torch.zeros((max_edges, 3), dtype=dtype, device=dev),
        edge_valid=torch.zeros((max_edges,), dtype=torch.bool, device=dev),
        n_nodes=0, n_edges=0)


def _vec(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, device=like.device).to(like.dtype)


def add_node(g: PoseGraph, pose) -> Tuple[PoseGraph, int]:
    """Masked append of a keyframe; returns (graph, node_id).  A full
    table leaves the graph as it is and still returns ``n_nodes``, as
    JAX's does.  The graph given is not modified."""
    i = g.n_nodes
    if i >= g.nodes.shape[0]:
        return g, i
    nodes, valid = g.nodes.clone(), g.node_valid.clone()
    nodes[i] = _vec(pose, nodes)
    valid[i].fill_(True)           # a fill, not a host-to-device copy
    return g._replace(nodes=nodes, node_valid=valid, n_nodes=i + 1), i


def add_edge(g: PoseGraph, i: int, j: int, z_rel, info) -> PoseGraph:
    """Masked append of a relative-pose constraint i → j (host node ids).
    A full table leaves the graph as it is."""
    e = g.n_edges
    if e >= g.edge_ij.shape[0]:
        return g
    ij, z = g.edge_ij.clone(), g.edge_z.clone()
    inf, ev = g.edge_info.clone(), g.edge_valid.clone()
    ij[e, 0].fill_(int(i))
    ij[e, 1].fill_(int(j))
    z[e] = _vec(z_rel, z)
    inf[e] = _vec(info, inf)
    ev[e].fill_(True)
    return g._replace(edge_ij=ij, edge_z=z, edge_info=inf, edge_valid=ev,
                      n_edges=e + 1)


def relative_pose(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """t2v(inv(T_a)·T_b) with degree angles: the measurement an odometry
    or loop-closure edge carries."""
    th = pa[2] * _D2R
    c, s = torch.cos(th), torch.sin(th)
    d = pb[:2] - pa[:2]
    return torch.stack([c * d[0] + s * d[1],
                        -s * d[0] + c * d[1],
                        wrap_to_180(pb[2] - pa[2])])


def _residual_and_jac(xi: torch.Tensor, xj: torch.Tensor, z: torch.Tensor):
    """SE(2) edge residual and its Jacobians with respect to (xi, xj), for
    one edge ([3] each) or a batch ([E,3] each): r [...,3], A and B
    [...,3,3].  Residual r = [R_iᵀ(t_j − t_i) − t_z ; wrap(θ_j − θ_i −
    θ_z)], the angle in radians, so the information acts on commensurate
    units."""
    thi = xi[..., 2] * _D2R
    c, s = torch.cos(thi), torch.sin(thi)
    dx, dy = xj[..., 0] - xi[..., 0], xj[..., 1] - xi[..., 1]
    rth = wrap_to_180(xj[..., 2] - xi[..., 2] - z[..., 2]) * _D2R
    r = torch.stack([c * dx + s * dy - z[..., 0],
                     -s * dx + c * dy - z[..., 1], rth], dim=-1)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    # d rt / d theta_i (theta in radians) in A's last column
    A = torch.stack([
        torch.stack([-c, -s, -s * dx + c * dy], dim=-1),
        torch.stack([s, -c, -c * dx - s * dy], dim=-1),
        torch.stack([zero, zero, -one], dim=-1)], dim=-2)
    Bm = torch.stack([
        torch.stack([c, s, zero], dim=-1),
        torch.stack([-s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)
    return r, A, Bm


def optimize(g: PoseGraph, iters: int = 10, damping: float = 1e-6
             ) -> PoseGraph:
    """Fixed-iteration Gauss-Newton over all valid nodes and edges, on the
    graph's device and in its dtype.

    Dense normal equations (3Nk × 3Nk): keyframe graphs are small beside
    the landmark map.  Node 0 is anchored by a strong prior (the gauge
    freedom); invalid nodes are frozen by a unit prior.  Reads nothing
    back to the host."""
    Nk = g.nodes.shape[0]
    dt, dev = g.nodes.dtype, g.nodes.device
    ii, jj = g.edge_ij[:, 0], g.edge_ij[:, 1]
    info = g.edge_info * g.edge_valid.to(dt)[:, None]
    Om = torch.diag_embed(info)                                  # [E,3,3]
    ar3 = torch.arange(3, device=dev)
    ri = ii[:, None] * 3 + ar3[None, :]                          # [E,3]
    rj = jj[:, None] * 3 + ar3[None, :]
    free = g.node_valid
    prior = torch.diag(torch.where(
        free, torch.full((Nk,), damping, dtype=dt, device=dev),
        torch.ones((Nk,), dtype=dt, device=dev)).repeat_interleave(3))
    freef = free.to(dt)[:, None]
    nodes = g.nodes
    for _ in range(iters):
        r, A, Bm = _residual_and_jac(nodes[ii], nodes[jj], g.edge_z)
        AtO = torch.einsum("eqi,eqp->eip", A, Om)                # Aᵀ·Ω
        BtO = torch.einsum("eqi,eqp->eip", Bm, Om)
        H = torch.zeros((3 * Nk, 3 * Nk), dtype=dt, device=dev)
        b = torch.zeros((3 * Nk,), dtype=dt, device=dev)
        for rb, cb, blk in ((ri, ri, torch.einsum("eip,epj->eij", AtO, A)),
                            (ri, rj, torch.einsum("eip,epj->eij", AtO, Bm)),
                            (rj, ri, torch.einsum("eip,epj->eij", BtO, A)),
                            (rj, rj, torch.einsum("eip,epj->eij", BtO, Bm))):
            H.index_put_((rb[:, :, None].expand_as(blk),
                          cb[:, None, :].expand_as(blk)), blk,
                         accumulate=True)
        b.index_put_((ri,), torch.einsum("eip,ep->ei", AtO, r),
                     accumulate=True)
        b.index_put_((rj,), torch.einsum("eip,ep->ei", BtO, r),
                     accumulate=True)
        # anchor node 0, damp the free nodes, freeze the invalid ones
        H = H + prior
        H[ar3, ar3] += 1e6
        sol, _ = torch.linalg.solve_ex(H, b)
        delta = -sol.reshape(Nk, 3)
        delta = torch.cat([delta[:, :2], delta[:, 2:] * (1.0 / _D2R)], 1)
        nodes = nodes + delta * freef
        nodes = torch.cat([nodes[:, :2], wrap_to_180(nodes[:, 2:])], 1)
    return g._replace(nodes=nodes)


def optimize_np(g: PoseGraph, iters: int = 20, damping: float = 1e-6
                ) -> PoseGraph:
    """Host float64 Gauss-Newton, the same math as ``optimize``.

    The normal equations carry a 1e6 gauge prior on node 0 beside the 1e-6
    damping on free nodes (condition ~1e12): fine in f64, not in an f32
    solve.  Keyframe graphs are tiny, so a numpy double solve per
    iteration costs microseconds.  The nodes come back in the graph's
    dtype and on its device."""
    nodes = g.nodes.detach().cpu().double().numpy().copy()
    valid = g.node_valid.cpu().numpy()
    eij = g.edge_ij.cpu().numpy()
    ez = g.edge_z.detach().cpu().double().numpy()
    einfo = g.edge_info.detach().cpu().double().numpy()
    evalid = g.edge_valid.cpu().numpy()
    Nk = nodes.shape[0]
    d2r = np.pi / 180.0

    for _ in range(iters):
        H = np.zeros((3 * Nk, 3 * Nk))
        b = np.zeros(3 * Nk)
        for e in range(len(eij)):
            if not evalid[e]:
                continue
            i, j = int(eij[e, 0]), int(eij[e, 1])
            xi, xj, z = nodes[i], nodes[j], ez[e]
            thi = xi[2] * d2r
            c, s = np.cos(thi), np.sin(thi)
            dx, dy = xj[0] - xi[0], xj[1] - xi[1]
            r = np.array([
                c * dx + s * dy - z[0],
                -s * dx + c * dy - z[1],
                (((xj[2] - xi[2] - z[2]) + 180.0) % 360.0 - 180.0) * d2r,
            ])
            A = np.array([[-c, -s, -s * dx + c * dy],
                          [s, -c, -c * dx - s * dy],
                          [0.0, 0.0, -1.0]])
            B = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
            Om = np.diag(einfo[e])
            ri = slice(3 * i, 3 * i + 3)
            rj = slice(3 * j, 3 * j + 3)
            AtO, BtO = A.T @ Om, B.T @ Om
            H[ri, ri] += AtO @ A
            H[ri, rj] += AtO @ B
            H[rj, ri] += BtO @ A
            H[rj, rj] += BtO @ B
            b[3 * i:3 * i + 3] += AtO @ r
            b[3 * j:3 * j + 3] += BtO @ r
        diag = np.where(valid, damping, 1.0).repeat(3)
        H += np.diag(diag)
        H[0, 0] += 1e6
        H[1, 1] += 1e6
        H[2, 2] += 1e6
        delta = -np.linalg.solve(H, b).reshape(Nk, 3)
        delta[:, 2] /= d2r
        nodes = nodes + delta * valid[:, None]
        nodes[:, 2] = (nodes[:, 2] + 180.0) % 360.0 - 180.0
    return g._replace(nodes=torch.from_numpy(nodes).to(
        device=g.nodes.device, dtype=g.nodes.dtype))


def graph_error(g: PoseGraph) -> torch.Tensor:
    """Sum of squared information-weighted edge residuals (a device
    scalar)."""
    r, _, _ = _residual_and_jac(g.nodes[g.edge_ij[:, 0]],
                                g.nodes[g.edge_ij[:, 1]], g.edge_z)
    w = g.edge_valid.to(r.dtype)
    return torch.sum(w * torch.sum(r * r * g.edge_info, dim=-1))
