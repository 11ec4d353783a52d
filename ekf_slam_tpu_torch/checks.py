"""Inputs and runs shared by the port's on-card checks (``chip_smoke.py``
and ``tests/test_torch_cuda.py``): the K3 scoring case, the K2 gating
case and the tolerance of its in-kernel bearing, the K5 pair starts, the
square-root recompression's QR branch, and one session run on several
devices with the same inputs.  Each caller keeps its own shapes and
tolerances."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from .config import EKFParams, RansacParams, SimConfig
from .models.srekf import _retriangularize
from .models.srekf_fast import sr_recompress
from .ops import gating as G
from .ops.angles import atan2d, wrap_to_360
from .ops.blocked_chol import chol_for_state
from .ops.kernels import syrk_gram
from .session import SlamSession
from .sim import world as W
from .state import FilterState


def score_lines_case(g: torch.Generator, NH: int, B: int, thresh: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random points [B,2], validity [B] and lines [NH,2] on ``g``'s
    device.  Points within 1e-5 of ``thresh`` from any line are marked
    invalid: the kernel's ``rsqrtf`` and the plain version's ``1/sqrt`` may
    round them to either side."""
    dev = g.device
    pts = (torch.rand((B, 2), generator=g, device=dev) - 0.5) * 10.0
    lines = torch.stack([torch.randn((NH,), generator=g, device=dev) * 2.0,
                         (torch.rand((NH,), generator=g, device=dev) - 0.5)
                         * 8.0], dim=-1).contiguous()
    valid = torch.rand((B,), generator=g, device=dev) < 0.9
    p64, l64 = pts.double(), lines.double()
    d64 = ((l64[:, :1] * p64[None, :, 0] - p64[None, :, 1] + l64[:, 1:])
           .abs() / torch.sqrt(l64[:, :1] ** 2 + 1.0))
    valid &= ~((d64 - thresh).abs() < 1e-5).any(dim=0)
    return pts, valid, lines


def gate_case(g: torch.Generator, M: int, K: int, D: int = None,
              noise: float = 0.05
              ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Inputs of ``gating.gate_costs_state`` on ``g``'s device, float32:
    (x, P, lm, sig, active, zs, Rs), and a keep mask [M,K].

    P is [D, D] (D ≥ 3 + 2K; default 3 + 2K, larger for a padded layout)
    and holds NaN everywhere the gate does not read: only Prr, the
    pose↔landmark strip P[0:3, 3:3+2K] and the slots' 2×2 diagonal blocks
    are set, each block positive definite, its sub-diagonal p10 off its
    super-diagonal p01 by ~1e-3 so that a swap of the two shows.  Rs has
    NaN off its diagonal, which the gate does not read either.  About 80%
    of the K slots are active; three in four measurements re-observe a
    slot with position noise ``noise`` (m; 0 gives bearing innovations of
    a few ulps, computed in f64 from the float32 state) and its signature,
    the rest are new.  ``keep`` is False where, in f64, the bearing
    innovation lies within 1e-4° of the ±180 seam of the innovation wrap,
    or the predicted bearing within 1e-4° of wrapTo360's 0/360 seam: two
    roundings may land on either side of a seam there."""
    dev = g.device
    f64 = torch.float64
    D = 3 + 2 * K if D is None else D

    def u(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev, dtype=f64) \
            * (hi - lo) + lo

    def nrm(shape, std):
        return torch.randn(shape, generator=g, device=dev, dtype=f64) * std

    pose = torch.cat([u((2,), -1.0, 1.0), u((1,), 0.0, 360.0)]).float()
    A = nrm((3, 3), 0.1)
    prr = A @ A.T + 0.01 * torch.eye(3, dtype=f64, device=dev)
    lm = u((K, 2), -10.0, 10.0).float()
    sig = torch.arange(1, K + 1, dtype=torch.float32, device=dev)
    active = torch.rand((K,), generator=g, device=dev) < 0.8
    L = nrm((K, 2, 2), 0.1)
    pll = (L @ L.transpose(1, 2)
           + 0.01 * torch.eye(2, dtype=f64, device=dev)).reshape(K, 4)
    pll[:, 2] += nrm((K,), 1e-3)
    prl = nrm((K, 6), 0.003)
    x = torch.zeros((D,), device=dev)
    x[:3], x[3:3 + 2 * K] = pose, lm.reshape(-1)
    P = torch.full((D, D), float("nan"), device=dev)
    P[:3, :3] = prr.float()
    P[:3, 3:3 + 2 * K] = prl.float().reshape(K, 3, 2).permute(
        1, 0, 2).reshape(3, 2 * K)
    i = torch.arange(3, 3 + 2 * K, 2, device=dev)
    for e, (r, c) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        P[i + r, i + c] = pll[:, e].float()

    p64, lm64 = pose.double(), lm.double()
    tgt = torch.randint(0, K, (M,), generator=g, device=dev)
    new = torch.rand((M,), generator=g, device=dev) < 0.25
    zlm = torch.where(new[:, None], u((M, 2), -10.0, 10.0),
                      lm64[tgt] + nrm((M, 2), noise))
    d = zlm - p64[:2]
    rng_ = torch.hypot(d[:, 0], d[:, 1])
    zs = torch.stack([rng_, torch.remainder(atan2d(d[:, 1], d[:, 0])
                                            - p64[2], 360.0),
                      torch.where(new, 1e5 + torch.arange(M, device=dev,
                                                          dtype=f64),
                                  sig[tgt].double())], dim=-1).float()
    Rs = torch.full((M, 2, 2), float("nan"), device=dev)
    Rs[:, 0, 0], Rs[:, 1, 1] = (rng_ * 0.01).float(), u((M,), 0.5, 5.0).float()
    zphi = wrap_to_360(atan2d(lm64[:, 1] - p64[1], lm64[:, 0] - p64[0])
                       - p64[2])
    seam = torch.remainder(zs.double()[:, 1:2] - zphi[None, :] + 180.0, 360.0)
    keep = ((seam > 1e-4) & (seam < 360.0 - 1e-4)
            & (zphi > 1e-4) & (zphi < 360.0 - 1e-4))
    return (x, P, x[3:3 + 2 * K].view(K, 2), sig, active, zs, Rs), keep


# a one-ulp gap of atan2f grows through − θ and wrapTo360 to at most one
# grid step of the largest magnitude on the way, 2 ulp(360°)
BEARING_DELTA_DEG = 2 * 2.0 ** -15


def gate_tolerance(args: Tuple[torch.Tensor, ...], s_cost: float,
                   wrap_innovation: bool = True, rel: float = 1e-5,
                   delta: float = BEARING_DELTA_DEG) -> torch.Tensor:
    """How far [M,K] the kernel's cost may lie from the plain version's,
    ``args`` being ``gate_costs_state``'s (x, P, lm, sig, active, zs, Rs).
    The kernel computes the bearing ẑ_φ itself with atan2f, which may round
    off the plain version's by up to ``delta`` degrees; every other
    operation rounds as the plain version's does.  The cost is a quadratic
    in the innovation n1, so an n1 shift of ±delta moves it by at most
    |∂cost/∂n1|·delta + (s00/det)·delta², with ∂cost/∂n1 =
    2(s00·n1 − Φ01·n0)/det from the plain version's own terms; the
    tolerance is rel·|cost| plus that.  Inactive slots (+inf in both)
    get 0."""
    t = G.gate_terms_ref(*G.strip_args(*args), s_cost, wrap_innovation)
    slope = 2.0 * (t["s00"] * t["n1"] - t["phi01"] * t["n0"]) / t["det"]
    tol = (rel * t["cost"].abs() + slope.abs() * delta
           + (t["s00"] / t["det"]).abs() * delta * delta)
    return torch.where(args[4][None, :], tol, 0.0)


def bearing_gap_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest gap between two float32 bearing strips (degrees), taken
    modulo 360 (0 and 360 are one bearing), in ulps of ``want``."""
    d = got.double() - want.double()
    d = (d - 360.0 * torch.round(d / 360.0)).abs()
    w = want.abs()
    ulp = (torch.nextafter(w, torch.full_like(w, float("inf"))) - w).double()
    return (d / ulp).max().item() if d.numel() else 0.0


def pair_starts(rows: int, device, dtype=torch.int64) -> torch.Tensor:
    """Eight pair starts into a matrix of ``rows`` rows: duplicates,
    unordered, and the last row pair (rows − 2)."""
    s = [3, rows - 2, 3, rows // 2 + 1, 5, rows - 2, 0, rows // 3]
    return torch.tensor(s, dtype=dtype, device=device)


def recompress_qr_case(devices: Iterable[str], capacity: int = 32,
                       n_active: int = 20, buffer: int = 8, seed: int = 0
                       ) -> Dict[str, Dict[str, object]]:
    """``sr_recompress`` of one f32 general factor whose last active row is
    zeroed, on each device.  The factor is made on the CPU from ``seed``:
    a random lower-triangular block over the 3 + 2·n_active active dims,
    mixed by a random orthogonal matrix (so it is not triangular), with
    noise deposits in the pose rows of the buffer columns.  Its Gram is
    singular, so the blocked Cholesky gives NaN and the recompression must
    take its QR branch.  The zeroed row is the last active one, so the QR's
    R is unique up to the signs the branch fixes, whichever QR routine the
    device runs.  Returns {device: {"chol_failed": the Cholesky's diagonal
    is not finite, "qr_taken": the result equals the QR branch's, "L":
    the recompressed factor}}."""
    g = torch.Generator().manual_seed(seed)
    D = 3 + 2 * capacity + buffer
    d = 3 + 2 * n_active
    A = torch.randn((d, d), generator=g, dtype=torch.float64)
    Q, _ = torch.linalg.qr(torch.randn((d, d), generator=g,
                                       dtype=torch.float64))
    S = torch.zeros((D, D), dtype=torch.float64)
    S[:d, :d] = (torch.tril(A) * 0.1 + torch.eye(d, dtype=torch.float64)
                 * 0.3) @ Q
    S[:3, D - buffer:D - buffer // 2] = torch.randn(
        (3, buffer - buffer // 2), generator=g, dtype=torch.float64) * 0.01
    S[d - 1] = 0.0
    S = S.float()
    out = {}
    for where in devices:
        na = torch.tensor(n_active, dtype=torch.int32, device=where)
        state = FilterState(
            x=torch.zeros((D,), device=where), P=S.to(where),
            sig=torch.zeros((capacity,), device=where),
            active=torch.arange(capacity, device=where) < n_active,
            n_active=na)
        diag = torch.diagonal(chol_for_state(syrk_gram(state.P), na))
        L = sr_recompress(state).P
        act = (torch.arange(D, device=where) < d).float()
        qr = _retriangularize(state.P.T, D) * act[:, None]
        out[where] = dict(chol_failed=not bool(torch.isfinite(diag).all()),
                          qr_taken=bool(torch.equal(L, qr)), L=L)
    return out


def session_on_devices(ep: EKFParams, rp: RansacParams, T: int,
                       n_beams: int, devices: Iterable[str], seed: int = 0
                       ) -> Dict[str, object]:
    """One ``rectangle_room(4, 3)`` trajectory of T ticks on
    ``circle_controls(T, 0.05, 3.0)`` and one set of extractor draws, both
    made on the CPU from ``seed``, run by a fresh ``SlamSession`` on each
    device.  Returns {device: the session's stacked outputs}."""
    g = torch.Generator().manual_seed(seed)
    traj = W.simulate(W.rectangle_room(4.0, 3.0, device="cpu"),
                      W.circle_controls(T, 0.05, 3.0, device="cpu"),
                      SimConfig(n_beams=n_beams, max_range=12.0), g)
    NH = rp.n_hypotheses
    draws = [(torch.rand((NH, n_beams), generator=g),
              torch.rand((NH, n_beams), generator=g)) for _ in range(T)]
    outs = {}
    for where in devices:
        sess = SlamSession(ekf_params=ep, ransac_params=rp, device=where)
        _, outs[where] = sess.run(traj.odom, traj.ranges, traj.beam_angles,
                                  draws=[(u.to(where), s.to(where))
                                         for u, s in draws])
    return outs
