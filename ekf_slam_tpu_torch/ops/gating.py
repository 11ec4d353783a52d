"""Fused maximum-likelihood gate costs for M×K pairs (counterpart of
ekf_slam_tpu/ops/pallas/gating.py).

``gate_costs_state`` launches the hand-written CUDA kernel
(csrc/gate_costs.cu, replacing ``gate_costs_pallas`` and the XLA work
that feeds it) on CUDA tensors and runs the plain version
``gate_costs_state_ref`` on CPU tensors; ``gate_costs_state.launches``
counts the kernel launches.  It takes the filter state as it lies:

  x [≥3] — the state vector, pose (x, y, θ deg) at x[0:3]
  P [≥3+2K, ≥3+2K] — the covariance (any padding; the kernel reads
                     Prr, the pose↔landmark strip and the landmark
                     diagonal blocks in place)
  lm [K,2], sig [K], active [K] — landmark table slices of the state
  zs [M,3], Rs [M,2,2] — measurements (range, bearing, signature) and
                         their R, of which only the diagonal is read

and returns cost [M,K] = νᵀΦ⁻¹ν + (z_sig − sig)²/s_cost, +inf in inactive
slots.  The kernel's contract is narrower than the XLA-path gate
(ops/association.batch_costs): it uses R's diagonal only, the det form of
the 2×2 solve, a symmetric P (Φ's off-diagonal is Φ01 on both sides), and
always adds the signature cost to the position cost.

The plain version composes the JAX function's pieces: ``strips_from_state``
(the strips lm, sig, active, prr [3,3], prl [K,6] = P[0:3, 3+2k:5+2k]
row-major, pll [K,4] = (p00, p01, p10, p11)), the R diagonal, and
``gate_costs_ref``, which takes the strips as ``gate_costs_pallas`` does
and computes the bearing strip ẑ_φ = wrapTo360(atan2d(Δy, Δx) − θ) as the
JAX package computes it in XLA before its kernel (gating.py:172-178).  The
kernel computes that bearing itself, with atan2f; ``checks.gate_tolerance``
bounds what an ulp of it can move a cost.
"""
from __future__ import annotations

import torch

from ..config import rounded
from . import kernels as _k
from .angles import _DEG2RAD, atan2d, wrap_to_360

# PyTorch's CUDA division by a Python float multiplies by the float32
# reciprocal of the float32 divisor: the kernel's atan2d does the same
_RAD2DEG_F32 = (torch.tensor(1.0) / torch.tensor(_DEG2RAD)).item()


def _strips(P: torch.Tensor, K: int):
    """(prr [3,3], prl [K,6], pll [K,4]) of P, each contiguous."""
    from .association import _lm_diag_blocks
    end = 3 + 2 * K
    prl = P[:3, 3:end].reshape(3, K, 2).permute(1, 0, 2).reshape(K, 6)
    pll = _lm_diag_blocks(P, K).reshape(K, 4)
    return P[:3, :3].contiguous(), prl, pll


def strips_from_state(state):
    """The kernel's strip inputs (lm, sig, active, prr, prl, pll) of a
    FilterState, each contiguous as the TPU kernel reads it."""
    return (state.landmarks, state.sig, state.active,
            *_strips(state.P, state.capacity))


def _bearing_strip(pose: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """Predicted bearing of every slot, wrapTo360(atan2d(Δy, Δx) − θ)."""
    delta = lm - pose[:2]
    return wrap_to_360(atan2d(delta[:, 1], delta[:, 0]) - pose[2])


def gate_terms_ref(pose, prr, zs, rdiag, lm, sig, active, prl, pll,
                   s_cost: float, wrap_innovation: bool = True) -> dict:
    """The plain version's terms, in the TPU kernel's order of operations,
    every input cast to ``lm``'s dtype as the JAX wrapper casts them:
    ``cost`` [M,K] and the [M,K] terms n0, n1, s00, phi01, det it is made
    of (``checks.gate_tolerance`` reads them)."""
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
    cost = torch.where(active[None, :], pos + sigc, float("inf"))
    return dict(cost=cost, n0=n0, n1=n1, s00=s00, phi01=phi01, det=det)


def gate_costs_ref(pose, prr, zs, rdiag, lm, sig, active, prl, pll,
                   s_cost: float, wrap_innovation: bool = True
                   ) -> torch.Tensor:
    """Plain version of the TPU kernel: the [M,K] costs from the strips
    (``gate_costs_pallas``'s arguments)."""
    return gate_terms_ref(pose, prr, zs, rdiag, lm, sig, active, prl, pll,
                          s_cost, wrap_innovation)["cost"]


def strip_args(x, P, lm, sig, active, zs, Rs):
    """``gate_costs_ref``'s arguments read from the state: the strips and
    the R diagonal (JAX association.py:273-276)."""
    prr, prl, pll = _strips(P, lm.shape[0])
    rdiag = torch.stack([Rs[:, 0, 0], Rs[:, 1, 1]], dim=-1)
    return x[:3], prr, zs, rdiag, lm, sig, active, prl, pll


def gate_costs_state_ref(x, P, lm, sig, active, zs, Rs, s_cost: float,
                         wrap_innovation: bool = True) -> torch.Tensor:
    """Plain version of the kernel: strips, R diagonal and
    ``gate_costs_ref``, on any device."""
    return gate_costs_ref(*strip_args(x, P, lm, sig, active, zs, Rs),
                          s_cost, wrap_innovation)


_P_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gate_costs_state(x, P, lm, sig, active, zs, Rs, s_cost: float,
                     wrap_innovation: bool = True, zphi_out=None
                     ) -> torch.Tensor:
    """Fused [M,K] gate costs from the filter state (kernel on CUDA, plain
    version on CPU).  On CUDA: x, lm, sig, zs, Rs float32 and P float32
    or bfloat16; lm, sig, active, zs, Rs contiguous; P with unit inner
    stride and any leading dimension; active bool.  ``zphi_out``
    (CUDA only, float32 [K]): where given, the kernel also writes its
    bearing strip ẑ_φ there, for checks."""
    K, M = lm.shape[0], zs.shape[0]
    D = 3 + 2 * K
    shapes = {"lm": (lm, (K, 2)), "sig": (sig, (K,)),
              "active": (active, (K,)), "zs": (zs, (M, 3)),
              "Rs": (Rs, (M, 2, 2))}
    for name, (a, shape) in shapes.items():
        _k._require(tuple(a.shape) == shape,
                    f"{name} must be {shape}, got {tuple(a.shape)}")
    _k._require(x.dim() == 1 and x.shape[0] >= 3,
                f"x must be a vector of at least 3, got {tuple(x.shape)}")
    _k._require(P.dim() == 2 and P.shape[0] >= D and P.shape[1] >= D,
                f"P {tuple(P.shape)} does not hold 3 + 2·{K} rows and "
                "columns")
    dense = dict(x=x, **{name: a for name, (a, _) in shapes.items()})
    for name, a in dict(dense, P=P).items():
        _k._require(a.device == lm.device,
                    f"{name} is on {a.device}, lm on {lm.device}")
    _k._require(active.dtype == torch.bool, "active must be bool")
    if lm.device.type == "cpu":
        _k._require(zphi_out is None, "zphi_out is the kernel's, on CUDA")
        return gate_costs_state_ref(x, P, lm, sig, active, zs, Rs, s_cost,
                                    wrap_innovation)
    _k._require(lm.device.type == "cuda",
                f"gate_costs_state runs on CUDA or CPU tensors, not "
                f"{lm.device}")
    _k._require(P.dtype in _P_DTYPES,
                f"the gate_costs kernel takes float32 or bfloat16 P, not "
                f"{P.dtype}")
    _k._require(P.stride(1) == 1 and P.stride(0) >= D,
                f"the gate_costs kernel reads P row-major with a unit inner "
                f"stride and a leading dimension ≥ {D}, got strides "
                f"{P.stride()}")
    for name, a in dense.items():
        _k._require(name == "active" or a.dtype == torch.float32,
                    f"the gate_costs kernel takes float32, {name} is "
                    f"{a.dtype}")
        _k._require(a.is_contiguous(),
                    f"gate_costs needs contiguous inputs, {name} is strided")
    out = torch.empty((M, K), dtype=torch.float32, device=lm.device)
    zp = 0
    if zphi_out is not None:
        _k._require(zphi_out.shape == (K,) and zphi_out.dtype == torch.float32
                    and zphi_out.is_contiguous()
                    and zphi_out.device == lm.device,
                    "zphi_out must be a contiguous float32 [K] on lm's device")
        zp = zphi_out.data_ptr()
    if M == 0 or K == 0:
        return out
    lib = _k._lib("gate_costs")
    with torch.cuda.device(lm.device):
        err = lib.gate_costs(
            x.data_ptr(), P.data_ptr(), P.stride(0), _P_DTYPES[P.dtype],
            lm.data_ptr(), sig.data_ptr(), active.data_ptr(), zs.data_ptr(),
            Rs.data_ptr(), _RAD2DEG_F32,
            rounded(1.0 / s_cost, torch.float32), int(wrap_innovation),
            M, K, out.data_ptr(), zp, _k._stream(lm.device))
    _k._launch_check("gate_costs", err)
    gate_costs_state.launches += 1
    return out


gate_costs_state.launches = 0
