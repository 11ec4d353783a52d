"""Inputs and runs shared by the port's on-card checks (``chip_smoke.py``
and ``tests/test_torch_cuda.py``): the K3 scoring case, the wall-search
case and its comparison with the plain version, the K2 gating case and
the tolerance of its in-kernel bearing, the K5 pair starts, the K6
Gram's precision check against the f64 Gram, the square-root
recompression's QR branch, one session run on several
devices with the same inputs, and the JAX package's batched-update
benchmark (bench.py) as the port runs it: its parameters, full state,
measurements and one gate + update batch.  Each caller keeps its own
shapes and tolerances."""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .config import EKFParams, RansacParams, SimConfig, resolve_device
from .models import batched as _batched
from .models import ekf as _ekf
from .models.batched import update_chunked
from .models.srekf import _retriangularize
from .models.srekf_fast import sr_recompress
from .ops import gating as G
from .ops.angles import atan2d, wrap_to_360
from .ops.association import gate, gate_batch
from .ops.blocked_chol import chol_for_state
from .ops.kernels import syrk_gram, wall_search
from .ops.ransac import perpendicular_foot, seed_trials, wall_search_ref
from .ops.scan import scan_from_ranges, scan_to_world
from .session import SlamSession
from .sim import world as W
from .state import FilterState, round_up
from .utils.schedule import tuned_params


def syrk_case(g: torch.Generator, D: int, R: int, dtype, exact: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inputs of ``kernels.syrk_downdate`` on ``g``'s device: a
    bit-symmetric P [D, D] and W [D, R], both of ``dtype``.

    Random (``exact`` false): P = (A + Aᵀ)/2 with A standard normal, and W
    normal scaled by 0.1·√(16/R), so W·Wᵀ keeps the size it has at a
    tick's rank 16 (its diagonal ~0.16).  ``exact``: integers, P in
    [−64, 64] and W in {−1, 0, 1} with one entry in 16 nonzero, so every
    product, every partial sum and the result (|P − W·Wᵀ| well under 256)
    are exact in f32 and in bf16: the kernel must then equal the plain
    version to the bit, whatever the order of its sums."""
    dev = g.device
    if exact:
        A = torch.randint(-64, 65, (D, D), generator=g, device=dev,
                          dtype=torch.float32)
        P = (torch.triu(A) + torch.triu(A, 1).T).to(dtype)
        del A
        nz = torch.rand((D, R), generator=g, device=dev) < 1 / 16
        sign = torch.randint(0, 2, (D, R), generator=g, device=dev) * 2 - 1
        return P, (nz * sign).to(dtype)
    A = torch.randn((D, D), generator=g, device=dev)
    P = ((A + A.T) * 0.5).to(dtype)
    del A
    W = torch.randn((D, R), generator=g, device=dev) * (0.1 * math.sqrt(
        16 / R))
    return P, W.to(dtype)


def bf16_ulp(x: float) -> float:
    """Spacing of bfloat16 numbers at magnitude x (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def syrk_compare(out: torch.Tensor, ref: torch.Tensor, P_absmax: float
                 ) -> Dict[str, object]:
    """The kernel's P − W·Wᵀ (``out``) against the plain version's
    (``ref``), from an input P whose largest magnitude is ``P_absmax``:
    both accumulate exact products in f32 in other orders, so in bf16 an
    element may round to the neighbouring value, within one bf16 ulp of
    |P|max; in f32 the sums agree within 1e-5 of |ref|max.  Returns the
    largest gap, its tolerance, the number of elements that differ, and
    whether ``out`` is bit-symmetric."""
    d = (out.float() - ref.float()).abs()
    tol = (bf16_ulp(P_absmax) if out.dtype == torch.bfloat16
           else 1e-5 * ref.abs().max().item())
    err = d.max().item()
    return dict(err=err, tol=tol, n_diff=int(torch.count_nonzero(d)),
                symmetric=bool(torch.equal(out, out.T)),
                ok=err <= tol)


def bf16_ulps(t: torch.Tensor) -> torch.Tensor:
    """Spacing of bfloat16 numbers at each |t|, as f32 (zero and subnormal
    magnitudes take the spacing at the smallest normal, 2⁻¹³³)."""
    m = t.float().abs().clamp_min(2.0 ** -126)
    _, e = torch.frexp(m)
    return torch.ldexp(torch.ones_like(m), e - 8)


def syrk_gap_bound(a: torch.Tensor, b: torch.Tensor, P: torch.Tensor,
                   Wa: torch.Tensor, Wb: torch.Tensor) -> torch.Tensor:
    """Elementwise bound (f64) on |a − b| for two bf16 downdates of one P,
    a = P − Wa·Waᵀ and b = P − Wb·Wbᵀ, each summed in f32 in any order
    and rounded once to bf16:

        ulp(max(|a|, |b|)) + |Wa·Waᵀ − Wb·Wbᵀ|
            + γ·(2|P| + |Wa|·|Wa|ᵀ + |Wb|·|Wb|ᵀ)

    The first term is the two roundings to bf16 (half an ulp each, neither
    wider than the spacing at the larger result); the second is what the
    inputs' own difference makes, exactly (0 when Wa is Wb); the third
    bounds the f32 sums' errors, R products and the subtraction, with
    γ = n·2⁻²³/(1 − n·2⁻²³) and n = R + 1: one f32 ulp an operation, which
    also covers accumulation that truncates."""
    f = torch.float64
    A, B = Wa.to(f), Wb.to(f)
    n = Wa.shape[1] + 1
    gamma = n * 2.0 ** -23 / (1 - n * 2.0 ** -23)
    bound = (A @ A.T - B @ B.T).abs_()
    A.abs_()
    B.abs_()
    bound += gamma * (2 * P.to(f).abs() + A @ A.T + B @ B.T)
    bound += bf16_ulps(torch.maximum(a.float().abs(), b.float().abs())).to(f)
    return bound


@contextlib.contextmanager
def record_syrk():
    """Within the block, every K1 downdate of the batched update
    (``models.batched.update_batch``) records its inputs: yields a list
    that receives a copy of (P before the downdate, W) for each call, on
    their device.  The call itself goes on to the wrapper, and its launch
    counter, unchanged."""
    inner = _batched.syrk_downdate
    calls = []

    def recording(P, W):
        calls.append((P.clone(), W.clone()))
        return inner(P, W)

    _batched.syrk_downdate = recording
    try:
        yield calls
    finally:
        _batched.syrk_downdate = inner


def tf32_round(S: torch.Tensor) -> torch.Tensor:
    """S as f32, each element rounded to TF32 (10 stored mantissa bits) to
    nearest with ties away from zero, by bit operations on its f32 bits:
    (bits + 0x1000) & 0xFFFFE000 (exact for finite S)."""
    b = S.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def full_f32_matmul():
    """Within the block an f32 ``torch.matmul`` on CUDA runs in full f32:
    ``torch.backends.cuda.matmul.allow_tf32`` is set False and restored
    after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tf32_single_pass(S: torch.Tensor) -> torch.Tensor:
    """The precision control of the Gram: S rounded to TF32
    (``tf32_round``), then an f32 ``torch.matmul`` of it with its
    transpose (``allow_tf32`` False): the products are exact in f32, so
    this is what one TF32 MMA pass forms, on S's device."""
    A = tf32_round(S)
    with full_f32_matmul():
        return torch.matmul(A, A.T)


def gram_dense_case(D: int, R: int, seed: int = 0) -> torch.Tensor:
    """S [D, R] f32 on the CPU, standard normal entries drawn by numpy from
    ``seed``, D and R (the same on every machine)."""
    rng = np.random.default_rng((seed, D, R))
    return torch.from_numpy(rng.standard_normal((D, R), dtype=np.float32))


def gram_banded_case(g: torch.Generator, D: int, width: int = 256
                     ) -> torch.Tensor:
    """S [D, D] f32 on ``g``'s device, lower triangular with standard
    normal entries within ``width`` of the diagonal (S_ij for
    i − width < j ≤ i) and 0 elsewhere: every tile pair of the Gram runs,
    but no sum has more than ``width`` nonzero terms, so the accumulation
    error of an f32 Gram is small."""
    S = torch.randn((D, D), generator=g, device=g.device)
    return S.tril_().triu_(1 - width)


def _gram_errors(S: torch.Tensor, Gs: Iterable[torch.Tensor],
                block: int = 2048) -> list:
    """``gram_error`` of each G in ``Gs`` (on any device) against one f64
    Gram of S, formed on S's device ``block`` rows at a time."""
    Gs = list(Gs)
    S64 = S.to(torch.float64)
    d = (S64 * S64).sum(dim=1)                      # G64's diagonal
    errs = [0.0] * len(Gs)
    for i0 in range(0, S64.shape[0], block):
        i1 = min(i0 + block, S64.shape[0])
        ref = S64[i0:i1] @ S64.T
        scale = torch.sqrt(d[i0:i1, None] * d[None, :])
        zero = scale == 0
        scale[zero] = 1.0
        for n, G in enumerate(Gs):
            Gb = G[i0:i1].to(S.device, torch.float64)
            if bool((Gb[zero] != 0).any()):
                errs[n] = math.inf
                continue
            e = torch.nan_to_num((Gb - ref).abs_().div_(scale),
                                 nan=math.inf).max().item()
            errs[n] = max(errs[n], e)
            del Gb
    return errs


def gram_error(G: torch.Tensor, S: torch.Tensor) -> float:
    """e(G) = max over i, j of |G_ij − G64_ij| / √(G64_ii·G64_jj), G64
    the f64 Gram of S: on the diagonal the relative error the Cholesky
    sees.  Where G64_ii·G64_jj = 0 (a zero row of S) G_ij must be exactly
    0, or e is infinite; a NaN in G counts as infinite."""
    return _gram_errors(S, [G])[0]


def gram_plain_errors(S: torch.Tensor, seed: int = 0) -> Dict[str, float]:
    """e of the plain f32 Grams of S: the CPU's ``torch.matmul`` ('cpu'),
    the same with S's contraction columns permuted by ``seed`` (a
    different order of every sum, 'cpu_permuted') and, for S on CUDA, the
    card's ``torch.matmul`` in full f32 ('card', ``allow_tf32`` False)."""
    Sh = S.detach().to("cpu", torch.float32)
    perm = torch.randperm(Sh.shape[1],
                          generator=torch.Generator().manual_seed(seed))
    Sp = Sh[:, perm]
    Gs = {"cpu": Sh @ Sh.T, "cpu_permuted": Sp @ Sp.T}
    del Sp
    if S.device.type == "cuda":
        with full_f32_matmul():
            Gs["card"] = torch.matmul(S, S.T)
    return dict(zip(Gs, _gram_errors(S, Gs.values())))


def gram_compare(G: torch.Tensor, S: torch.Tensor,
                 plain_errors: Dict[str, float]) -> Dict[str, object]:
    """A Gram of S (the kernel's, or a stand-in) against the f64 Gram:
    its e (``gram_error``), the limit 4·m + 8·2⁻²³, m the largest e of the
    plain f32 Grams of the same S (``gram_plain_errors``), and whether e
    is within it."""
    err = gram_error(G, S)
    lim = 4 * max(plain_errors.values()) + 8 * 2.0 ** -23
    return dict(err=err, limit=lim, ok=err <= lim)


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


# The wall search's two settings: the flagship pipeline's extractor
# (bench.py:385-396, the sessions of chip_smoke.py) and
# examples/large_world_slam.py:76-77's, which switches on the refits, both
# splits and the RMS gate (its T = 9 cut to 4).
WALL_SETTINGS = {
    "flagship": dict(line_consensus=60, bearing_window_deg=15.0,
                     wall_search_timeout=4),
    "large_world": dict(line_consensus=36, bearing_window_deg=20.0,
                        wall_search_timeout=4, sample_points=12,
                        inlier_dist=0.15, refine_passes=2, refine_frac=0.4,
                        split_gap=1.2, split_kink_deg=3.0, max_fit_rms=0.04),
}


def _notched_room() -> W.World:
    """A room whose floor wall has a 1.6 m doorway (a gap split) and whose
    right wall bends by 3.8° halfway up (a kink split)."""
    return W.World(segments=torch.tensor(
        [[-4.0, -3.0, -0.8, -3.0], [0.8, -3.0, 4.0, -3.0],
         [4.0, -3.0, 4.0, 0.0], [4.0, 0.0, 3.8, 3.0], [3.8, 3.0, -4.0, 3.0],
         [-4.0, 3.0, -4.0, -3.0]]))


def wall_search_case(seed: int, B: int, NH: int, setting: str, device
                     ) -> Tuple[Tuple[torch.Tensor, ...], RansacParams]:
    """Inputs of ``kernels.wall_search`` on ``device``, float32: one noisy
    scan of B beams (1 cm range noise) from a pose drawn from ``seed``, in
    ``rectangle_room(4, 3)`` for the flagship setting and in a room with a
    doorway and a bent wall for large_world's, as world points [B,2],
    validity [B], and the NH trial lines [NH,2] and trial_ok [NH] that
    ``seed_trials`` fits from draws made from ``seed``; and the setting's
    RansacParams.  Points within 1e-5 of the inlier band from any trial
    line are marked invalid: the counts' rsqrtf and the masks' 1/sqrt may
    round them to either side."""
    params = RansacParams(ref_compat=False, n_hypotheses=NH,
                          dtype=torch.float32, **WALL_SETTINGS[setting])
    g = torch.Generator().manual_seed(seed)
    world = (W.rectangle_room(4.0, 3.0, device="cpu")
             if setting == "flagship" else _notched_room())
    u = torch.rand(3, generator=g, dtype=torch.float64)
    pose = torch.tensor([2.0 * u[0] - 1.0, 2.0 * u[1] - 1.0,
                         360.0 * u[2]]).float()
    beams = torch.arange(B, dtype=torch.float32) * (360.0 / B)
    ranges = (W.raycast(world, pose, beams, 12.0)
              + torch.randn(B, generator=g) * 0.01)
    scan = scan_from_ranges(ranges, beams)
    pts = scan_to_world(scan, pose).contiguous()
    draws = (torch.rand((NH, B), generator=g),
             torch.rand((NH, B), generator=g))
    trial, trial_ok = seed_trials(pts, scan.valid, params, NH, draws=draws)
    p64, l64 = pts.double(), trial.double()
    d64 = ((l64[:, :1] * p64[None, :, 0] - p64[None, :, 1] + l64[:, 1:])
           .abs() / torch.sqrt(l64[:, :1] ** 2 + 1.0))
    valid = scan.valid & ~((d64 - params.inlier_dist).abs() < 1e-5).any(0)
    return tuple(a.to(device) for a in (pts, valid, trial, trial_ok)), params


WALL_QUANTITIES = ("foot x", "foot y", "angle", "σθ²", "σc²", "t̄")


def wall_search_quantities(result) -> torch.Tensor:
    """[T, 6] f64 on the CPU: each round's perpendicular foot (m), line
    angle atan(m) (rad) and fit statistics [σθ², σc², t̄] from a result
    (lines, ok, avail, stats) of the wall search.  Slopes are compared as
    angles: y = m·x + b is ill-conditioned near vertical walls."""
    lines, stats = result[0].double().cpu(), result[3].double().cpu()
    m, b = lines[:, 0], lines[:, 1]
    return torch.cat([perpendicular_foot(m, b), torch.atan(m)[:, None],
                      stats], dim=1)


def wall_search_gaps(q: torch.Tensor, q64: torch.Tensor) -> torch.Tensor:
    """|q − q64| per round and quantity, angles modulo π (atan(m) of a
    near-vertical line may land at either end of (−π/2, π/2))."""
    d = q - q64
    d[:, 2] = d[:, 2] - math.pi * torch.round(d[:, 2] / math.pi)
    return d.abs()


def _ulp32(x: torch.Tensor) -> torch.Tensor:
    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()


# how many times the f32 plain runs' own spread a kernel may reach: the
# runs are a sample of sum orders, and with 16 of them a further reordered
# run can land past twice their farthest (PERF.md §6)
WALL_FACTOR = 4.0


def wall_search_tolerance(q32s, q64: torch.Tensor, extent: float
                          ) -> torch.Tensor:
    """How far [T, 6] a float32 result's quantities may lie from the f64
    plain version's ``q64``: WALL_FACTOR times the farthest of the f32
    plain runs ``q32s`` (the same function, its sums reduced in other
    orders), plus a floor of 4 f32 ulps of each quantity's scale: the
    scan's ``extent`` (the largest |coordinate|, m) for the feet and t̄,
    1 rad for the angle, the value itself for σθ² and σc².  A kernel whose
    only departure is the order of its f32 sums lies inside; a kernel that
    fits another mask does not."""
    worst = torch.stack([wall_search_gaps(q, q64) for q in q32s]).amax(0)
    scale = torch.tensor([extent, extent, 1.0, 0.0, 0.0, extent],
                         dtype=torch.float64)
    scale = torch.maximum(scale, q64.abs())
    scale[:, 3:5] = q64[:, 3:5].abs()
    return WALL_FACTOR * worst + 4.0 * _ulp32(scale)


def _plain_run(args, params, perm=None):
    """wall_search_ref with its per-round counts and trace, the points in
    the order ``perm`` (their sums then run in another order), everything
    returned on the CPU in the points' original order."""
    pts, valid, trial, trial_ok = args
    if perm is not None:
        pts, valid = pts[perm], valid[perm]
    T, NH = params.wall_search_timeout, trial.shape[0]
    counts = torch.zeros((T + 1, NH), dtype=torch.int32, device=pts.device)
    pools = torch.zeros((T, pts.shape[0]), dtype=torch.bool,
                        device=pts.device)
    trace = []
    res = wall_search_ref(pts, valid, trial, trial_ok, params,
                          counts_out=counts, pools_out=pools, trace=trace)

    def back(x):
        x = torch.as_tensor(x).cpu()
        if perm is None or x.dim() == 0:
            return x
        out = torch.empty_like(x)
        out[..., perm] = x
        return out

    res = tuple(r.cpu() for r in res[:2]) + (back(res[2]), res[3].cpu())
    trace = [[(name, back(v), back(c), None if rel is None else back(rel))
              for name, v, c, rel in rec] for rec in trace]
    return dict(res=res, counts=counts.cpu(), pools=back(pools), trace=trace)


def _first_split(a, b) -> int:
    """The first round whose decisions (ok, the pool and the counts it
    leaves) differ between two runs; −1 if their initial counts differ, T
    if none do."""
    if not torch.equal(a["counts"][0], b["counts"][0]):
        return -1
    T = a["res"][1].shape[0]
    for r in range(T):
        if (a["res"][1][r] != b["res"][1][r]
                or not torch.equal(a["pools"][r], b["pools"][r])
                or not torch.equal(a["counts"][r + 1], b["counts"][r + 1])):
            return r
    return T


# what each decision the plain version notes (ransac._note) can change:
# the round's inlier mask, only its line, or only its ok
WALL_DECISIONS = {"trial distance": "mask", "largest gap": "mask",
                  "chord at the gap": "mask", "chord at the median": "mask",
                  "kink": "mask", "slope gap": "mask",
                  "chord at the kink": "mask", "refine distance": "line",
                  "fit rms": "ok", "refit denominator": "ok"}


def _near_cuts(plain, others, r):
    """Decisions of ``plain``'s round r that lie within their f32 rounding
    band: |value − cut| ≤ WALL_FACTOR times the largest change of that
    margin over ``others`` (the same round of the f64 and the reordered f32
    runs) plus 4 f32 ulps.  Returns (name, point or None, margin, band)
    tuples."""
    out = []
    for k, (name, v, c, rel) in enumerate(plain["trace"][r]):
        margin = v.double() - c.double()
        moved = torch.zeros_like(margin)
        for o in others:
            _, vo, co, _ = o["trace"][r][k]
            moved = torch.maximum(moved, (vo.double() - co.double()
                                          - margin).abs())
        scale = torch.maximum(v.double().abs(), c.double().abs())
        band = WALL_FACTOR * moved + 4.0 * _ulp32(scale)
        near = margin.abs() <= band
        if margin.dim() == 0:
            if bool(near):
                out.append((name, None, margin.item(), band.item()))
            continue
        if rel is not None:
            near &= rel
        for i in torch.nonzero(near).flatten().tolist():
            out.append((name, i, margin[i].item(), band[i].item()))
    return out


def wall_search_compare(args, params: RansacParams, strict: bool,
                        kernel: Optional[Callable] = None, orders: int = 16,
                        seed: int = 0) -> Dict[str, object]:
    """The wall-search kernel (``kernel(*args, params, counts_out=,
    pools_out=)``, default ``kernels.wall_search``) against its plain
    version on the same device (f32), the plain version in f64 on the CPU,
    and ``orders`` f32 plain runs on the CPU with the points permuted.

    * Decisions: the initial counts, and each round's ok and the pool and
      counts it leaves, must equal the plain version's bit for bit.  With
      ``strict`` (the splits off: the masks come from the trial lines,
      which are inputs) that holds for every round, and no decision of the
      plain run may lie within its f32 rounding band (``_near_cuts``).
      Otherwise the first round that differs must hold a decision within
      that band of a kind that can make the difference (WALL_DECISIONS);
      the rounds after it are not compared, and the decisions are listed
      in ``notes``.
    * Numbers: in every round both keep in step (the f64 run too) and the
      plain run accepts, the feet, angle and statistics lie within
      ``wall_search_tolerance`` of the f64 run's.

    Returns dict(failures, notes, compared rounds, worst gap/tolerance
    ratio, max_abs_err: the largest gap between the kernel's and the f32
    plain version's feet (m) in the compared rounds)."""
    pts, valid, trial, trial_ok = args
    T, NH, B = params.wall_search_timeout, trial.shape[0], pts.shape[0]
    counts_k = torch.zeros((T + 1, NH), dtype=torch.int32, device=pts.device)
    pools_k = torch.zeros((T, B), dtype=torch.bool, device=pts.device)
    res_k = (kernel or wall_search)(pts, valid, trial, trial_ok, params,
                                    counts_out=counts_k, pools_out=pools_k)
    kern = dict(res=tuple(r.cpu() for r in res_k), counts=counts_k.cpu(),
                pools=pools_k.cpu())
    plain = _plain_run(args, params)
    cpu = tuple(a.cpu() for a in args)
    f64 = _plain_run((cpu[0].double(), cpu[1], cpu[2].double(), cpu[3]),
                     dataclasses.replace(params, dtype=torch.float64))
    g = torch.Generator().manual_seed(seed)
    runs = [_plain_run(cpu, params, torch.randperm(B, generator=g))
            for _ in range(orders)]
    q = {name: wall_search_quantities(x["res"])
         for name, x in (("k", kern), ("p", plain), ("64", f64))}
    extent = cpu[0][cpu[1]].abs().max().item() if bool(cpu[1].any()) else 1.0
    split64 = _first_split(plain, f64)
    splits = [_first_split(plain, x) for x in runs]
    failures, notes, compared, ratio, err = [], [], [], 0.0, 0.0

    split_k = _first_split(plain, kern)
    why, kinds = None, ()
    if 0 <= split_k < T:
        okp = bool(plain["res"][1][split_k])
        okk = bool(kern["res"][1][split_k])
        if okp != okk:
            why, kinds = "ok differs", ("mask", "ok")
        elif okp:       # the pool each leaves differs: a mask decision
            why, kinds = "the pool or the counts it leaves differ", ("mask",)
        else:           # neither accepts, so neither may touch the pool
            why = ("the pool or the counts differ in a round that accepts "
                   "no wall")
    for r in range(min(split_k, split64)):
        if not plain["res"][1][r]:
            continue
        tol = wall_search_tolerance(
            [q["p"]] + [wall_search_quantities(x["res"])
                        for x, s in zip(runs, splits) if s > r], q["64"],
            extent)[r]
        gap = wall_search_gaps(q["k"], q["64"])[r]
        if (gap > tol).any():
            split_k = r
            bad = [f"{n} {gap[i].item():.3e} > {tol[i].item():.3e}"
                   for i, n in enumerate(WALL_QUANTITIES) if gap[i] > tol[i]]
            why = f"outside the tolerance: {', '.join(bad)}"
            kinds = ("mask", "line", "ok")
            break
        compared.append(r)
        ratio = max(ratio, (gap / tol).max().item())
        err = max(err, (q["k"][r, :2] - q["p"][r, :2]).abs().max().item())
    if split64 < T:
        notes.append(f"the f64 plain run decides otherwise from round "
                     f"{split64}: its rounds are not held to the tolerance")

    others = [f64] + runs

    def near(rounds, kinds):
        return [(r,) + x for r in rounds for x in _near_cuts(plain, others, r)
                if WALL_DECISIONS[x[0]] in kinds]

    if strict:
        close = near(range(T), ("mask", "line", "ok"))
        if close:
            failures.append(f"decisions within the f32 rounding band: "
                            f"{close[:5]}")
    if split_k == -1:
        failures.append("the initial counts differ")
    elif split_k < T:
        close = near((split_k,), kinds)
        msg = f"round {split_k}: {why}"
        # each point whose pool differs needs its own decision at a cut,
        # unless a decision over the whole wall (a split) is at its cut
        diff = torch.nonzero(kern["pools"][split_k]
                             != plain["pools"][split_k]).flatten().tolist()
        whole = [x for x in close if x[2] is None]
        mine = {x[2]: x for x in close if x[2] is not None}
        far = [] if whole else [i for i in diff if i not in mine]
        if strict or not close or far:
            failures.append(f"{msg}; decisions of the plain run within the "
                            f"f32 rounding band that could change it: "
                            f"{close[:5] or 'none'}; points of the pool "
                            f"that differ off every cut's band: {far[:8]}")
        else:
            shown = [mine.get(i, whole[0] if whole else None)
                     for i in diff][:8] or close[:5]
            notes.append(f"{msg} at {len(diff)} points, each at a decision "
                         f"within the f32 rounding band (round, name, point, "
                         f"value − cut, band): {shown}; later rounds not "
                         f"compared")
    elif not torch.equal(kern["res"][2], plain["res"][2]):
        failures.append("the returned pool is not the last round's")
    return dict(failures=failures, notes=notes, compared=compared,
                ratio=ratio, max_abs_err=err,
                accepted=int(plain["res"][1].sum()))


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
    device.  The draws have a row per hypothesis of the batched wall
    search, or per round of the one-seed search (``n_hypotheses=0``).
    Returns {device: the session's stacked outputs}."""
    g = torch.Generator().manual_seed(seed)
    traj = W.simulate(W.rectangle_room(4.0, 3.0, device="cpu"),
                      W.circle_controls(T, 0.05, 3.0, device="cpu"),
                      SimConfig(n_beams=n_beams, max_range=12.0), g)
    rows = rp.n_hypotheses or rp.wall_search_timeout
    draws = [(torch.rand((rows, n_beams), generator=g),
              torch.rand((rows, n_beams), generator=g)) for _ in range(T)]
    outs = {}
    for where in devices:
        sess = SlamSession(ekf_params=ep, ransac_params=rp, device=where)
        _, outs[where] = sess.run(traj.odom, traj.ranges, traj.beam_angles,
                                  draws=[(u.to(where), s.to(where))
                                         for u, s in draws])
    return outs


def bench_params(K: int, **overrides) -> EKFParams:
    """The EKFParams of the JAX package's batched-update benchmark at K
    landmarks (bench.py:153-156, 211-226): ML association, s_cost 1e6,
    s_thresh 1e12, f32 compute, at ``tuned_params``' schedule (at 10k:
    rows P·Hᵀ, bf16 P, the SYRK correction, 8 chunks); ``overrides``
    replace fields after that."""
    base = EKFParams(capacity=K, association="ml", s_cost=1e6,
                     s_thresh=1e12, ref_compat=False, update_mode="batched",
                     dtype=torch.float32)
    return dataclasses.replace(tuned_params(base), **overrides)


def full_state(params: EKFParams, K: int, seed: int = 0, device=None
               ) -> FilterState:
    """The benchmark's state (bench.py:111-137, make_full_state): all K
    slots active (K is ``params.capacity``), x holding landmarks drawn
    uniform in [-40, 40]² by numpy from ``seed`` (the benchmark's draws,
    so x, sig, active and n_active equal its state's), sig = 1..K, and
    P = 0.05·I + 0.02·A·Aᵀ over the 3 + 2K dims, in ``params.cov_dt``,
    with A [3 + 2K, 8]/√(3 + 2K) drawn on the CPU by a torch.Generator from
    ``seed`` (the benchmark draws A with jax.random) and the product formed
    on ``device``, made symmetric to the bit.  Under correction='syrk' D
    is padded to a multiple of 512 with zero rows, as the benchmark pads
    it for the kernel (bench.py:248-253)."""
    if K != params.capacity:
        raise ValueError(f"K={K} must be params.capacity "
                         f"({params.capacity})")
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    D = params.dim
    Dp = round_up(D, 512) if params.correction == "syrk" else D
    x = np.zeros(Dp, np.float64)
    x[3:3 + 2 * K] = rng.uniform(-40, 40, (K, 2)).reshape(-1)
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((D, 8), generator=g, dtype=params.dtype).to(device)
    A = A / torch.sqrt(torch.tensor(float(D), dtype=params.dtype,
                                    device=device))
    M = A @ A.T
    M.mul_(0.02)
    M.diagonal().add_(0.05)
    S = M + M.T                         # (a + b)·0.5 is symmetric to the bit
    del M
    S.mul_(0.5)
    P = torch.zeros((Dp, Dp), dtype=params.cov_dt, device=device)
    P[:D, :D] = S
    del S
    return FilterState(
        x=torch.tensor(x, dtype=params.dtype, device=device), P=P,
        sig=torch.arange(1, K + 1, dtype=params.dtype, device=device),
        active=torch.ones((K,), dtype=torch.bool, device=device),
        n_active=torch.tensor(K, dtype=torch.int32, device=device))


def full_measurements(x, K: int, n: int, seed: int = 1,
                      noise: Optional[Tuple[float, float]] = None
                      ) -> np.ndarray:
    """The benchmark's measurements (bench.py:139-150, make_measurements),
    in numpy to the bit: n rows (range, bearing in degrees, signature),
    each the exact predicted measurement of a landmark drawn from ``seed``,
    so the ML gate associates it and the update runs.  ``x`` is the
    state's mean (a tensor or an array).  ``noise`` (σ of range in m and
    of bearing in degrees; the benchmark has none) adds Gaussian noise
    from the same generator after the draws, so that the innovation is
    not zero and the update moves the mean."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    idx = rng.integers(0, K, n)
    lm = x[3:3 + 2 * K].reshape(K, 2)[idx]
    delta = lm - x[:2]
    r = np.hypot(delta[:, 0], delta[:, 1])
    b = np.mod(np.rad2deg(np.arctan2(delta[:, 1], delta[:, 0])) - x[2],
               360.0)
    if noise is not None:
        r = r + rng.normal(0.0, noise[0], n)
        b = np.mod(b + rng.normal(0.0, noise[1], n), 360.0)
    return np.stack([r, b, (idx + 1).astype(np.float64)], axis=-1)


def bench_batch(state: FilterState, zs: torch.Tensor, params: EKFParams
                ) -> Tuple[FilterState, torch.Tensor]:
    """One batch of the benchmark (bench.py:228-241): R = diag(z_r·rc0,
    z_φ·rc1) per measurement, the gate (``gate_batch``), then
    ``update_chunked`` of the measurements it associates.  P is updated
    in place.  Returns the new state and the gate's slots."""
    rc0, rc1 = params.rc
    Rs = torch.diag_embed(torch.stack([zs[:, 0] * rc0, zs[:, 1] * rc1],
                                      dim=-1)).to(params.dtype)
    is_new, slots = gate_batch(state, zs, Rs, params,
                               use_pallas=params.use_pallas)
    return update_chunked(state, zs, slots, Rs, ~is_new, params), slots


def sequential_params(K: int, **overrides) -> EKFParams:
    """The EKFParams of the JAX package's sequential benchmark at K
    landmarks (bench.py:189-198, ``_params(K, 1)``): ML association,
    s_cost 1e6, s_thresh 1e12, f32, P in f32, the sequential filter."""
    base = EKFParams(capacity=K, association="ml", s_cost=1e6,
                     s_thresh=1e12, ref_compat=False, dtype=torch.float32,
                     update_mode="sequential")
    return dataclasses.replace(base, **overrides)


def sequential_chain(state: FilterState, zs: torch.Tensor,
                     params: EKFParams) -> FilterState:
    """The sequential benchmark's chain (bench.py:195-208): for each row z
    of zs [n,3] in turn, R = diag(z_r·rc0, z_φ·rc1), the one-measurement
    gate, and the rank-2 update of the slot it picks, whatever the gate
    says of novelty.  Each row gates against the state the previous row
    left; P is updated in place.  Returns the new state."""
    rc0, rc1 = params.rc
    for z in zs:                         # a view per row, no host read
        R2 = torch.diag(torch.stack([z[0] * rc0, z[1] * rc1])).to(
            params.dtype)
        _, slot, _ = gate(state, z, R2, params)
        state = _ekf.update(state, z, slot, R2, params)
    return state
