"""Fused maximum-likelihood gate costs for M×K pairs (counterpart of
ekf_slam_tpu/ops/pallas/gating.py).

``gate_costs`` launches the hand-written CUDA kernel (csrc/gate_costs.cu,
replacing ``gate_costs_pallas``) on CUDA tensors and runs the plain
version ``gate_costs_ref`` on CPU tensors; ``gate_costs.launches`` counts
the kernel launches.  Both take the JAX function's arguments and strip
layout:

  pose [3], prr [3,3] — robot pose and pose covariance block
  zs [M,3], rdiag [M,2] — measurements (range, bearing, signature) and
                          the diagonal of their R
  lm [K,2], sig [K], active [K] — landmark table slices of the state
  prl [K,6] — pose↔landmark strip, P[0:3, 3+2k:5+2k] row-major
  pll [K,4] — landmark diagonal blocks (p00, p01, p10, p11)

and return cost [M,K] = νᵀΦ⁻¹ν + (z_sig − sig)²/s_cost, +inf in inactive
slots.  The kernel's contract is narrower than the XLA-path gate
(ops/association.batch_costs): it uses R's diagonal only, the det form of
the 2×2 solve, a symmetric P (Φ's off-diagonal is Φ01 on both sides), and
always adds the signature cost to the position cost.

The bearing strip ẑ_φ = wrapTo360(atan2d(Δy, Δx) − θ) is computed with
torch before the launch, as the JAX package computes it in XLA before its
kernel (gating.py:172-178), so kernel and plain version share it to the
bit.
"""
from __future__ import annotations

import torch

from ..config import rounded
from . import kernels as _k
from .angles import atan2d, wrap_to_360


def strips_from_state(state):
    """The kernel's strip inputs (lm, sig, active, prr, prl, pll) of a
    FilterState, each contiguous as the kernel reads it."""
    from .association import _lm_diag_blocks
    P = state.P
    K = state.capacity
    end = 3 + 2 * K
    prl = P[:3, 3:end].reshape(3, K, 2).permute(1, 0, 2).reshape(K, 6)
    pll = _lm_diag_blocks(P, K).reshape(K, 4)
    return (state.landmarks, state.sig, state.active,
            P[:3, :3].contiguous(), prl, pll)


def _bearing_strip(pose: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """Predicted bearing of every slot, wrapTo360(atan2d(Δy, Δx) − θ)."""
    delta = lm - pose[:2]
    return wrap_to_360(atan2d(delta[:, 1], delta[:, 0]) - pose[2])


def gate_costs_ref(pose, prr, zs, rdiag, lm, sig, active, prl, pll,
                   s_cost: float, wrap_innovation: bool = True
                   ) -> torch.Tensor:
    """Plain version: the [M,K] costs in the TPU kernel's order of
    operations, every input cast to ``lm``'s dtype as the JAX wrapper
    casts them."""
    dt = lm.dtype
    pose, prr, zs, rdiag, sig, prl, pll = (
        a.to(dt) for a in (pose, prr, zs, rdiag, sig, prl, pll))
    dx = lm[:, 0] - pose[0]
    dy = lm[:, 1] - pose[1]
    q = dx * dx + dy * dy
    q = torch.where(q == 0.0, torch.ones_like(q), q)
    sq = torch.sqrt(q)
    inv_q = 1.0 / q
    zero, mone = torch.zeros_like(q), torch.full_like(q, -1.0)
    A = ((-sq * dx * inv_q, -sq * dy * inv_q, zero),
         (dy * inv_q, -dx * inv_q, mone))
    B = ((sq * dx * inv_q, sq * dy * inv_q),
         (-dy * inv_q, dx * inv_q))

    def arow(i, j):                       # A[i,:]·Prr·A[j,:]
        s = 0.0
        for a in range(3):
            for b in range(3):
                s = s + A[i][a] * prr[a, b] * A[j][b]
        return s

    def aprlb(i, j):                      # A[i,:]·Prl_k·B[j,:]
        s = 0.0
        for a in range(3):
            for b in range(2):
                s = s + A[i][a] * prl[:, 2 * a + b] * B[j][b]
        return s

    def bpllb(i, j):                      # B[i,:]·Pll_k·B[j,:]
        return (B[i][0] * (pll[:, 0] * B[j][0] + pll[:, 1] * B[j][1])
                + B[i][1] * (pll[:, 2] * B[j][0] + pll[:, 3] * B[j][1]))

    phi00 = arow(0, 0) + 2.0 * aprlb(0, 0) + bpllb(0, 0)
    phi11 = arow(1, 1) + 2.0 * aprlb(1, 1) + bpllb(1, 1)
    phi01 = arow(0, 1) + aprlb(0, 1) + aprlb(1, 0) + bpllb(0, 1)

    n0 = zs[:, 0:1] - sq[None, :]                                   # [M,K]
    n1 = zs[:, 1:2] - _bearing_strip(pose, lm)[None, :]
    if wrap_innovation:
        n1 = n1 - torch.floor((n1 + 180.0) / 360.0) * 360.0
    s00 = phi00[None, :] + rdiag[:, 0:1]
    s11 = phi11[None, :] + rdiag[:, 1:2]
    phi01 = phi01[None, :]
    det = s00 * s11 - phi01 * phi01
    pos = (n0 * (s11 * n0 - phi01 * n1)
           + n1 * (-phi01 * n0 + s00 * n1)) / det
    ds = zs[:, 2:3] - sig[None, :]
    sigc = ds * ds * rounded(1.0 / s_cost, dt)
    return torch.where(active[None, :], pos + sigc, float("inf"))


def gate_costs(pose, prr, zs, rdiag, lm, sig, active, prl, pll,
               s_cost: float, wrap_innovation: bool = True) -> torch.Tensor:
    """Fused [M,K] gate costs (kernel on CUDA, plain version on CPU).  On
    CUDA every float input is float32 and contiguous, ``active`` bool."""
    K, M = lm.shape[0], zs.shape[0]
    shapes = {"pose": (pose, (3,)), "prr": (prr, (3, 3)),
              "zs": (zs, (M, 3)), "rdiag": (rdiag, (M, 2)),
              "lm": (lm, (K, 2)), "sig": (sig, (K,)),
              "active": (active, (K,)), "prl": (prl, (K, 6)),
              "pll": (pll, (K, 4))}
    for name, (a, shape) in shapes.items():
        _k._require(tuple(a.shape) == shape,
                    f"{name} must be {shape}, got {tuple(a.shape)}")
        _k._require(a.device == lm.device,
                    f"{name} is on {a.device}, lm on {lm.device}")
    _k._require(active.dtype == torch.bool, "active must be bool")
    if lm.device.type == "cpu":
        return gate_costs_ref(pose, prr, zs, rdiag, lm, sig, active, prl,
                              pll, s_cost, wrap_innovation)
    _k._require(lm.device.type == "cuda",
                f"gate_costs runs on CUDA or CPU tensors, not {lm.device}")
    for name, (a, _) in shapes.items():
        _k._require(name == "active" or a.dtype == torch.float32,
                    f"the gate_costs kernel takes float32, {name} is "
                    f"{a.dtype}")
        _k._require(a.is_contiguous(), f"gate_costs needs contiguous "
                                       f"inputs, {name} is strided")
    out = torch.empty((M, K), dtype=torch.float32, device=lm.device)
    if M == 0 or K == 0:
        return out
    zphi = _bearing_strip(pose, lm)
    lib = _k._lib("gate_costs")
    with torch.cuda.device(lm.device):
        err = lib.gate_costs(
            pose.data_ptr(), prr.data_ptr(), zs.data_ptr(), rdiag.data_ptr(),
            lm.data_ptr(), zphi.data_ptr(), sig.data_ptr(),
            active.data_ptr(), prl.data_ptr(), pll.data_ptr(),
            rounded(1.0 / s_cost, torch.float32), int(wrap_innovation),
            M, K, out.data_ptr(), _k._stream(lm.device))
    _k._launch_check("gate_costs", err)
    gate_costs.launches += 1
    return out


gate_costs.launches = 0
