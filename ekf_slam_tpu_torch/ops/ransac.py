"""RANSAC wall/landmark extraction, fixed-shape (counterpart of
ekf_slam_tpu/ops/ransac.py; RANSAC.m:14-373).

The batched-hypothesis wall search seeds NH trial lines with torch ops,
then runs the initial scoring and every greedy round in one launch of the
hand-written CUDA kernel ``ops/kernels.wall_search`` (its plain version is
``wall_search_ref`` below).  The reference's one-seed-per-round search
(``find_walls``, ``n_hypotheses=0``) is plain torch ops, as it is XLA in
the JAX package.  The candidate
table keeps the reference's semantics and quirks (two-quadrant bearing
window, increment-all-matches, promotion after promote_count sightings,
first-candidate seeding of an empty table, decay only on ticks with a
candidate, landmark = perpendicular foot from the world origin).

Where the JAX package branches on data with ``lax.cond`` or loops with
``lax.scan`` (ransac.py:337-356, 451-549), this module computes every
branch and selects with masks, so a tick runs the same ops whatever the
scan holds: no Python ``if`` on a device value, no host sync.  Indices
that come from the device are used through ``index_select``/``gather``
(indexing a tensor with a 0-dim tensor would read it back to the host).

Randomness: the JAX extractor draws u, s ~ U[0,1) ([NH, B] for the
batched search, ransac.py:314-325; [T, B] for ``find_walls``, :244-262)
from threefry, which torch cannot reproduce.  ``find_walls``,
``find_walls_batched`` and ``extract`` take the draws explicitly
(``draws=(u, s)``) and otherwise draw them from the given
``torch.Generator`` on the points' device.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import RansacParams, resolve_device
from .angles import atan2d, atand, wrap_to_360
from .kernels import score_lines, wall_search
from .observations import ObsBatch
from .scan import Scan, scan_to_world

_I32_MAX = torch.iinfo(torch.int32).max


class LandmarkTable(NamedTuple):
    """Fixed-capacity candidate table (RANSAC.m:238-241)."""
    loc: torch.Tensor      # f[C,2]  world position
    observe: torch.Tensor  # i32[C]  sighting count
    index: torch.Tensor    # i32[C]  0 = unpromoted candidate
    fresh: torch.Tensor    # i32[C]  remaining lifetime while unpromoted
    used: torch.Tensor     # bool[C] slot occupied


def init_table(params: RansacParams, device=None) -> LandmarkTable:
    device = resolve_device(device)
    C = params.table_capacity
    i32 = dict(dtype=torch.int32, device=device)
    return LandmarkTable(
        loc=torch.zeros((C, 2), dtype=params.dtype, device=device),
        observe=torch.zeros((C,), **i32),
        index=torch.zeros((C,), **i32),
        fresh=torch.zeros((C,), **i32),
        used=torch.zeros((C,), dtype=torch.bool, device=device),
    )


def _take(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-dim device index, without a host read."""
    return t.index_select(0, i.reshape(1).to(torch.int64))[0]


def _sel(mask: torch.Tensor, a, b):
    """``jnp.where`` over a NamedTuple of tensors with a scalar mask."""
    return type(a)(*(torch.where(mask, x, y) for x, y in zip(a, b)))


# ---------------------------------------------------------------------------
# Line fitting (RANSAC.m:184-215)
# ---------------------------------------------------------------------------

def _fit_sums(points: torch.Tensor, w: torch.Tensor):
    """fit_line's sums: (n, max(n, 1), Σx, Σy, Σxy and the denominator
    Σx² − (Σx)²/max(n, 1))."""
    w = w.to(points.dtype)
    px, py = points[:, 0], points[:, 1]
    n = w.sum(-1)
    n_safe = torch.clamp(n, min=1.0)
    sx = (w * px).sum(-1)
    sy = (w * py).sum(-1)
    sxx = (w * px * px).sum(-1)
    sxy = (w * px * py).sum(-1)
    return n, n_safe, sx, sy, sxy, sxx - sx * sx / n_safe


def fit_line(points: torch.Tensor, w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted least-squares y = m·x + b over masked points; ``w`` may
    carry leading batch dims ([..., B]).  Returns (m, b, ok); ok is False
    for degenerate (vertical/empty) sets."""
    n, n_safe, sx, sy, sxy, denom = _fit_sums(points, w)
    ok = (n >= 2) & (torch.abs(denom) > 1e-12)
    denom_safe = torch.where(ok, denom, 1.0)
    m = (sxy - sx * sy / n_safe) / denom_safe
    b = (sy - m * sx) / n_safe
    return m, b, ok


def point_line_dist(points: torch.Tensor, m, b) -> torch.Tensor:
    """Distance of each point to y = m·x + b (RANSAC.m:190-198)."""
    return (torch.abs(m * points[:, 0] - points[:, 1] + b)
            / torch.sqrt(m * m + 1.0))


def perpendicular_foot(m, b) -> torch.Tensor:
    """Foot of the perpendicular from the world origin to y = m·x + b
    (closed form of RANSAC.m:217-232), stacked on the last axis."""
    d = 1.0 + m * m
    return torch.stack([-m * b / d, b / d], dim=-1)


def _chord(points, m):
    """Position of each point along the line direction (1, m)/|.|."""
    return (points[:, 0] + m * points[:, 1]) / torch.sqrt(1.0 + m * m)


def _note(trace, name, value, cut, relevant=None):
    """Record one decision of a round where ``trace`` is a list: a value
    (per point [B], with the points it applies to, or a scalar) compared
    with ``cut``.  The checks use it to tell a rounding flip at a cut from
    a fault (checks.wall_search_compare)."""
    if trace is not None:
        trace.append((name, value, cut, relevant))


def split_on_gap(points: torch.Tensor, inl: torch.Tensor, m, b,
                 params: RansacParams, trace=None):
    """Split a fitted wall at the largest internal gap of its inlier chord
    (RansacParams.split_gap; two passes).  No-op when split_gap == 0."""
    if params.split_gap <= 0:
        return m, b, inl
    B = points.shape[0]
    ar = torch.arange(B - 1, device=points.device)
    for _ in range(2):
        t = _chord(points, m)
        ts = torch.sort(torch.where(inl, t, math.inf)).values
        n = inl.sum()
        gaps = torch.where(ar < n - 1, ts[1:] - ts[:-1], -math.inf)
        gi = torch.argmax(gaps)
        has_gap = _take(gaps, gi) > params.split_gap
        cut = 0.5 * (_take(ts, gi) + _take(ts, gi + 1))
        _note(trace, "largest gap", _take(gaps, gi), params.split_gap)
        _note(trace, "chord at the gap", t, cut, inl & has_gap)
        left = inl & (t < cut)
        keep = torch.where(left.sum() * 2 >= n, left, inl & (t >= cut))
        inl = torch.where(has_gap, keep, inl)
        m2, b2, ok2 = fit_line(points, inl)
        m = torch.where(has_gap & ok2, m2, m)
        b = torch.where(has_gap & ok2, b2, b)
    return m, b, inl


def split_on_kink(points: torch.Tensor, inl: torch.Tensor, m, b,
                  params: RansacParams, trace=None):
    """Split a fitted wall at the kink between two near-collinear walls
    (RansacParams.split_kink_deg; two passes).  No-op when 0."""
    if params.split_kink_deg <= 0:
        return m, b, inl
    thresh = math.radians(params.split_kink_deg)
    B = points.shape[0]
    for _ in range(2):
        t = _chord(points, m)
        ts = torch.sort(torch.where(inl, t, math.inf)).values
        n = inl.sum()
        med = _take(ts, torch.clamp(n // 2, 0, B - 1))
        left = inl & (t < med)
        right = inl & (t >= med)
        ml, bl, okl = fit_line(points, left)
        mr, br, okr = fit_line(points, right)
        kink = torch.abs(torch.atan(ml) - torch.atan(mr))
        split = okl & okr & (kink > thresh)
        dm = torch.where(torch.abs(ml - mr) < 1e-9, 1.0, ml - mr)
        xi = (br - bl) / dm
        yi = ml * xi + bl
        ti = (xi + m * yi) / torch.sqrt(1.0 + m * m)
        _note(trace, "chord at the median", t, med, inl & (t != med))
        _note(trace, "kink", kink, thresh)
        _note(trace, "slope gap", torch.abs(ml - mr), 1e-9)
        _note(trace, "chord at the kink", t, ti, inl & split)
        cut_l = inl & (t < ti)
        cut_r = inl & (t >= ti)
        keep = torch.where(cut_l.sum() >= cut_r.sum(), cut_l, cut_r)
        inl = torch.where(split, keep, inl)
        m2, b2, ok2 = fit_line(points, inl)
        m = torch.where(split & ok2, m2, m)
        b = torch.where(split & ok2, b2, b)
    return m, b, inl


def fit_rms(points: torch.Tensor, inl: torch.Tensor, m, b) -> torch.Tensor:
    """RMS perpendicular residual of the masked inliers."""
    d = point_line_dist(points, m, b)
    w = inl.to(points.dtype)
    n = torch.clamp(w.sum(), min=1.0)
    return torch.sqrt((w * d * d).sum() / n)


def refine_fit(points: torch.Tensor, avail: torch.Tensor, m, b, ok,
               params: RansacParams, trace=None):
    """``params.refine_passes`` tightened refits (band × refine_frac per
    pass); a pass that would degenerate keeps the previous fit."""
    thr = params.inlier_dist
    for _ in range(params.refine_passes):
        thr = thr * params.refine_frac
        d = point_line_dist(points, m, b)
        _note(trace, "refine distance", d, thr, avail)
        sel = avail & (d < thr)
        m2, b2, ok2 = fit_line(points, sel)
        m = torch.where(ok2, m2, m)
        b = torch.where(ok2, b2, b)
    return m, b, ok


def _finalize_wall(points, avail, inl, m, b, refit_ok,
                   params: RansacParams, trace=None):
    """Accepted-wall post-processing: splits, refits, the RMS gate and the
    fit statistics [σθ², σc², t̄] that noise_model='fit' propagates."""
    m, b, inl = split_on_gap(points, inl, m, b, params, trace)
    m, b, inl = split_on_kink(points, inl, m, b, params, trace)
    m, b, _ = refine_fit(points, avail, m, b, refit_ok, params, trace)
    rms = fit_rms(points, inl, m, b)
    if params.max_fit_rms > 0:
        _note(trace, "fit rms", rms, params.max_fit_rms)
    ok_q = (rms < params.max_fit_rms if params.max_fit_rms > 0
            else torch.ones((), dtype=torch.bool, device=points.device))
    w = inl.to(points.dtype)
    n = torch.clamp(w.sum(), min=2.0)
    t = _chord(points, m)
    tbar = (w * t).sum() / n
    vart = torch.clamp((w * (t - tbar) ** 2).sum() / n, min=1e-6)
    r2 = torch.clamp(rms, min=0.01) ** 2
    stats = torch.stack([r2 / (n * vart), r2 / n, tbar])
    return m, b, inl, ok_q, stats


# ---------------------------------------------------------------------------
# Batched-hypothesis wall search
# ---------------------------------------------------------------------------

def _bearing(points: torch.Tensor, params: RansacParams) -> torch.Tensor:
    x, y = points[:, 0], points[:, 1]
    if params.ref_compat:
        return atand(y / torch.where(x == 0, 1e-12, x))
    return atan2d(y, x)


def seed_trials(points: torch.Tensor, valid: torch.Tensor,
                params: RansacParams, n_hypotheses: int = 64,
                draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The NH trial lines [NH,2] as (m, b) of the batched wall search, each
    fitted to ``sample_points`` draws from the bearing window around a
    drawn seed point, and whether each may score (its window holds more
    than ``sample_points`` points and its fit is not degenerate): JAX
    ransac.py:307-334, step by step."""
    B = points.shape[0]
    NH = n_hypotheses
    dev = points.device
    bearing = _bearing(points, params)
    half_win = params.bearing_window_deg / 2.0

    if draws is None:
        u = torch.rand((NH, B), generator=generator, device=dev,
                       dtype=points.dtype)
        s = torch.rand((NH, B), generator=generator, device=dev,
                       dtype=points.dtype)
    else:
        u, s = draws
    seed_idx = torch.argmax(torch.where(valid[None, :], u, -1.0), dim=1)
    cb = bearing[seed_idx]                                       # [NH]
    in_win = (valid[None, :]
              & (bearing[None, :] <= cb[:, None] + half_win)
              & (bearing[None, :] >= cb[:, None] - half_win))    # [NH,B]
    enough = in_win.sum(dim=1) > params.sample_points

    # lax.top_k → torch.topk: the in-window draws are continuous, so they
    # do not tie; the -inf ties outside the window are masked off by the
    # "& in_win" below, whichever of them topk returns.
    s = torch.where(in_win, s, -math.inf)
    top_idx = torch.topk(s, params.sample_points, dim=1).indices  # [NH,S]
    sel = torch.zeros((NH, B), dtype=torch.bool, device=dev)
    sel = sel.scatter(1, top_idx, True) & in_win

    m0, b0, fit_ok = fit_line(points, sel)
    return torch.stack([m0, b0], dim=-1).contiguous(), enough & fit_ok


def wall_search_ref(points: torch.Tensor, valid: torch.Tensor,
                    trial: torch.Tensor, trial_ok: torch.Tensor,
                    params: RansacParams,
                    counts_out: Optional[torch.Tensor] = None,
                    pools_out: Optional[torch.Tensor] = None,
                    trace: Optional[list] = None):
    """Plain version of the wall-search kernel (csrc/wall_search.cu): the
    trial lines scored against the valid points, then up to T =
    wall_search_timeout greedy winners with disjoint inlier sets, each pick
    re-scoring the lines against the reduced pool (JAX ransac.py:335-356;
    the scoring through ops/kernels.score_lines, 1 + T calls).

    Returns (lines [T,2] as (m, b), ok [T], remaining pool [B], fit stats
    [T,3]).  Records for checks, where given: ``counts_out`` (int32
    [T+1, NH]) gets the counts each round picks from and, in row T, those
    after the last round; ``pools_out`` (bool [T, B]) the pool each round
    leaves; ``trace`` (a list) one list per round of the decisions it made
    (``_note``)."""
    counts = torch.where(trial_ok, score_lines(points, valid, trial,
                                               params.inlier_dist), 0)
    avail, cnts = valid, counts
    rows, pools, lines, oks, stats_all = [counts], [], [], [], []
    for _ in range(params.wall_search_timeout):
        rec = None if trace is None else []
        best = torch.argmax(cnts)          # first maximum, as jnp.argmax
        ok = _take(cnts, best) > params.line_consensus
        tb = _take(trial, best)
        d = point_line_dist(points, tb[0], tb[1])
        _note(rec, "trial distance", d, params.inlier_dist, avail)
        inl = avail & (d < params.inlier_dist)
        m1, b1, refit_ok = fit_line(points, inl)
        if rec is not None:
            _note(rec, "refit denominator", _fit_sums(points, inl)[-1].abs(),
                  1e-12)
        ok = ok & refit_ok
        m1, b1, inl, ok_q, stats = _finalize_wall(points, avail, inl,
                                                  m1, b1, refit_ok, params,
                                                  rec)
        ok = ok & ok_q
        avail = torch.where(ok, avail & ~inl, avail)
        cnts = torch.where(ok, score_lines(points, avail, trial,
                                           params.inlier_dist), cnts)
        cnts = cnts.index_fill(0, best.reshape(1), 0)
        rows.append(cnts)
        pools.append(avail)
        lines.append(torch.stack([m1, b1]))
        oks.append(ok)
        stats_all.append(stats)
        if trace is not None:
            trace.append(rec)
    if counts_out is not None:
        counts_out.copy_(torch.stack(rows))
    if pools_out is not None:
        pools_out.copy_(torch.stack(pools))
    return (torch.stack(lines), torch.stack(oks), avail,
            torch.stack(stats_all))


def find_walls_batched(points: torch.Tensor, valid: torch.Tensor,
                       params: RansacParams, n_hypotheses: int = 64,
                       draws: Optional[Tuple[torch.Tensor, torch.Tensor]]
                       = None,
                       generator: Optional[torch.Generator] = None):
    """NH seed lines fitted from their bearing windows (``seed_trials``),
    then the scoring and up to T = wall_search_timeout greedy winners with
    disjoint inlier sets in one ``wall_search`` launch on the card (the
    plain version on the CPU).

    Returns (lines [T,2] as (m, b), ok [T], remaining valid mask,
    fit stats [T,3])."""
    trial, trial_ok = seed_trials(points, valid, params, n_hypotheses,
                                  draws=draws, generator=generator)
    return wall_search(points, valid, trial, trial_ok, params)


def find_walls(points: torch.Tensor, valid: torch.Tensor,
               params: RansacParams,
               draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None):
    """The reference's wall search (RANSAC.m:109-128; JAX ransac.py:229-286):
    up to T = wall_search_timeout rounds, each drawing one seed point from
    the pool, fitting ``sample_points`` draws from its bearing window,
    taking the seed line's inliers over the whole pool and, where the
    round finds a wall, refitting it and removing its inliers.

    Plain torch ops: JAX runs this search in XLA, with no Pallas kernel.
    The draws are (u [T,B], s [T,B]) ~ U[0,1), round r's seed pick and
    window sample — JAX's threefry gives round r's pair from
    split(split(key, T)[r]) — handed in for parity, else drawn from
    ``generator``.  Every round runs whatever the pool holds, and a round
    that finds no wall leaves the pool as it was.

    Returns (lines [T,2] as (m, b), ok [T], remaining valid mask,
    fit stats [T,3])."""
    B = points.shape[0]
    T = params.wall_search_timeout
    dev = points.device
    bearing = _bearing(points, params)
    half_win = params.bearing_window_deg / 2.0
    if draws is None:
        u = torch.rand((T, B), generator=generator, device=dev,
                       dtype=points.dtype)
        s = torch.rand((T, B), generator=generator, device=dev,
                       dtype=points.dtype)
    else:
        u, s = draws
    avail = valid
    lines, oks, stats_all = [], [], []
    for r in range(T):
        run = avail.sum() > params.line_consensus    # RANSAC.m:114 guard
        # a random available point (datasample, RANSAC.m:157) and the
        # bearing window around it (RANSAC.m:160-171)
        seed_i = torch.argmax(torch.where(avail, u[r], -1.0))
        cb = _take(bearing, seed_i)
        in_win = (avail & (bearing <= cb + half_win)
                  & (bearing >= cb - half_win))
        enough = in_win.sum() > params.sample_points  # RANSAC.m:176
        # sample_points window draws; the -inf outside the window are
        # masked off by "& in_win", whichever of their ties topk returns
        top_idx = torch.topk(torch.where(in_win, s[r], -math.inf),
                             params.sample_points).indices
        sel = torch.zeros((B,), dtype=torch.bool, device=dev)
        sel = sel.index_fill(0, top_idx, True) & in_win
        # the seed line and its inliers over the pool (RANSAC.m:185-198)
        m0, b0, fit_ok = fit_line(points, sel)
        inl = avail & (point_line_dist(points, m0, b0) < params.inlier_dist)
        wall = (run & enough & fit_ok
                & (inl.sum() > params.line_consensus))   # RANSAC.m:203
        # refit on the inliers and take them from the pool (:206-209)
        m1, b1, refit_ok = fit_line(points, inl)
        wall = wall & refit_ok
        m1, b1, inl, ok_q, stats = _finalize_wall(points, avail, inl,
                                                  m1, b1, refit_ok, params)
        wall = wall & ok_q
        avail = torch.where(wall, avail & ~inl, avail)
        lines.append(torch.stack([m1, b1]))
        oks.append(wall)
        stats_all.append(stats)
    return (torch.stack(lines), torch.stack(oks), avail,
            torch.stack(stats_all))


def foot_covariance(lines: torch.Tensor, stats: torch.Tensor
                    ) -> torch.Tensor:
    """World-frame covariance [T,2,2] of each perpendicular-foot landmark
    propagated from the line-fit statistics: σ_ρ² = σ_c² + ℓ²·σ_θ² across
    the line, ρ²·σ_θ² along it (ℓ the centroid-to-foot lever arm)."""
    m, b = lines[:, 0], lines[:, 1]
    s_th2, s_c2, tbar = stats[:, 0], stats[:, 1], stats[:, 2]
    inv = 1.0 / torch.sqrt(1.0 + m * m)
    that = torch.stack([inv, m * inv], -1)
    nhat = torch.stack([-m * inv, inv], -1)
    foot = perpendicular_foot(m, b)
    rho2 = (foot * foot).sum(-1)
    t_foot = (foot * that).sum(-1)
    ell2 = (tbar - t_foot) ** 2
    s_n2 = s_c2 + ell2 * s_th2
    s_t2 = rho2 * s_th2
    return (s_n2[:, None, None] * nhat[:, :, None] * nhat[:, None, :]
            + s_t2[:, None, None] * that[:, :, None] * that[:, None, :])


# ---------------------------------------------------------------------------
# Candidate-table update (RANSAC.m:234-334)
# ---------------------------------------------------------------------------

class _ObsScratch(NamedTuple):
    """Per-table-entry record of this tick's first observation."""
    flag: torch.Tensor   # bool[C]
    dist: torch.Tensor   # f[C]
    ang: torch.Tensor    # f[C]
    loc: torch.Tensor    # f[C,2]
    stamp: torch.Tensor  # i32[C] record order
    R: torch.Tensor      # f[C,2,2]


def _empty_scratch(C: int, dt, device) -> _ObsScratch:
    return _ObsScratch(
        flag=torch.zeros((C,), dtype=torch.bool, device=device),
        dist=torch.zeros((C,), dtype=dt, device=device),
        ang=torch.zeros((C,), dtype=dt, device=device),
        loc=torch.zeros((C, 2), dtype=dt, device=device),
        stamp=torch.full((C,), _I32_MAX, dtype=torch.int32, device=device),
        R=torch.zeros((C, 2, 2), dtype=dt, device=device),
    )


def _associate(tbl: LandmarkTable, cands, cand_ok, pose, cand_cov,
               params: RansacParams) -> Tuple[LandmarkTable, _ObsScratch]:
    """The per-candidate table pass (ransac.py:448-528), candidates in
    order, each one's table pass vectorized."""
    C = params.table_capacity
    dt = params.dtype
    dev = cands.device
    ar = torch.arange(C, device=dev)
    ar32 = ar.to(torch.int32)
    scr = _empty_scratch(C, dt, dev)
    for ci in range(cands.shape[0]):
        cand = cands[ci]
        ok = cand_ok[ci]
        d = torch.linalg.norm(tbl.loc - cand[None, :], dim=-1)
        match = tbl.used & (d < params.assoc_dist) & ok
        if params.match_mode == "nearest":
            near = torch.argmin(torch.where(match, d, math.inf))
            match = match & (ar == near)
        any_match = match.any()

        # increment every match (the non-break at RANSAC.m:289)
        observe = tbl.observe + match.to(torch.int32)
        # promotion after promote_count sightings (RANSAC.m:261);
        # simultaneous promotions take sequential indices in slot order
        newly = match & (observe > params.promote_count) & (tbl.index == 0)
        order = torch.cumsum(newly.to(torch.int32), 0, dtype=torch.int32)
        index = torch.where(newly, tbl.index.max() + order, tbl.index)
        # indexed matches snap loc to the measurement (RANSAC.m:267-268)
        indexed_match = match & (index != 0)
        loc = torch.where(indexed_match[:, None], cand[None, :], tbl.loc)

        delta = cand - pose[:2]
        dist = torch.linalg.norm(delta)
        ang = wrap_to_360(atan2d(delta[1], delta[0]) - pose[2])
        if cand_cov is None:
            Rrec = torch.zeros((2, 2), dtype=dt, device=dev)
        else:
            # foot covariance → (range m, bearing deg) frame
            r_safe = torch.clamp(dist, min=1e-6)
            rhat = delta / r_safe
            phat = (180.0 / math.pi) * torch.stack([-rhat[1], rhat[0]]) \
                / r_safe
            J = torch.stack([rhat, phat])
            Rrec = J @ cand_cov[ci] @ J.T
        first_touch = indexed_match & ~scr.flag
        scr = _ObsScratch(
            flag=scr.flag | indexed_match,
            dist=torch.where(first_touch, dist.to(dt), scr.dist),
            ang=torch.where(first_touch, ang.to(dt), scr.ang),
            loc=torch.where(first_touch[:, None], cand[None, :], scr.loc),
            stamp=torch.where(first_touch, ci * C + ar32, scr.stamp),
            R=torch.where(first_touch[:, None, None], Rrec[None], scr.R),
        )

        # unmatched candidate → new entry at the first free slot
        # (RANSAC.m:295-302); dropped when the table is full
        free = ~tbl.used
        add = ok & ~any_match & free.any()
        at = (ar == torch.argmax(free.to(torch.int32))) & add
        tbl = LandmarkTable(
            loc=torch.where(at[:, None], cand[None, :], loc),
            observe=torch.where(at, 1, observe),
            index=torch.where(at, 0, index),
            fresh=torch.where(at, params.freshness, tbl.fresh),
            used=tbl.used | at,
        )
    return tbl, scr


def update_table(table: LandmarkTable, cands: torch.Tensor,
                 cand_ok: torch.Tensor, pose: torch.Tensor,
                 params: RansacParams, max_obs: int,
                 cand_cov: torch.Tensor = None
                 ) -> Tuple[ObsBatch, LandmarkTable]:
    """Associate candidates to the table; promote / snap / record / decay,
    and compact this tick's observation rows into an ObsBatch ordered by
    first touch.  ``cand_cov`` [Tc,2,2] (foot_covariance) fills
    ObsBatch.R."""
    C = params.table_capacity
    dt = params.dtype
    dev = cands.device
    cands = cands.to(dt)
    pose = pose.to(dt)
    if cand_cov is not None:
        cand_cov = cand_cov.to(dt)
    any_cand = cand_ok.any()
    table_empty = ~table.used.any()

    # Empty table: seed with the FIRST candidate only (RANSAC.m:236-241).
    first = torch.argmax(cand_ok.to(torch.int32))
    slot0 = torch.arange(C, device=dev) == 0
    seeded = LandmarkTable(
        loc=torch.where(slot0[:, None], _take(cands, first)[None, :],
                        table.loc),
        observe=torch.where(slot0, 1, table.observe),
        index=torch.where(slot0, 0, table.index),
        fresh=torch.where(slot0, params.freshness, table.fresh),
        used=table.used | slot0,
    )
    assoc, scratch = _associate(table, cands, cand_ok, pose, cand_cov,
                                params)
    # lax.cond(any & empty, seed, cond(any, associate, no-op)) as selects
    table = _sel(any_cand & table_empty, seeded,
                 _sel(any_cand, assoc, table))
    scratch = _sel(any_cand & ~table_empty, scratch,
                   _empty_scratch(C, dt, dev))

    # freshness decay on ticks with ≥1 candidate, unpromoted entries only
    # (RANSAC.m:133-148, 321-331)
    dec = table.used & (table.index == 0) & any_cand
    fresh = table.fresh - dec.to(torch.int32)
    table = table._replace(fresh=fresh,
                           used=table.used & ~(dec & (fresh == 0)))

    # compact the observation rows, ordered by stamp (stable, as
    # jnp.argsort)
    neg = scratch.flag
    order = torch.argsort(torch.where(neg, scratch.stamp, _I32_MAX),
                          stable=True)
    take = order[:max_obs]
    valid_rows = neg[take]
    vr2 = valid_rows[:, None]
    obs = ObsBatch(
        rng=torch.where(valid_rows, scratch.dist[take], 0.0).to(dt),
        bearing=torch.where(valid_rows, scratch.ang[take], 0.0).to(dt),
        index=torch.where(valid_rows, table.index[take], 0),
        loc=torch.where(vr2, scratch.loc[take], 0.0).to(dt),
        valid=valid_rows,
        R=(None if cand_cov is None else
           torch.where(vr2[:, :, None], scratch.R[take], 0.0).to(dt)),
    )
    return obs, table


# ---------------------------------------------------------------------------
# Filter-state write-back (RANSAC.m:336-373)
# ---------------------------------------------------------------------------

def writeback(table: LandmarkTable, x: torch.Tensor, n_active: torch.Tensor,
              params: RansacParams, sig: torch.Tensor = None
              ) -> LandmarkTable:
    """Copy filter-estimated landmark positions into the table
    (writeback_mode 'ref' positional with the last-only quirk of
    RANSAC.m:355, 'sig' by signature, or 'off')."""
    if params.writeback_mode == "off":
        return table
    K = (x.shape[0] - 3) // 2   # floor: x may carry padding rows
    lm = x[3:3 + 2 * K].reshape(K, 2)
    idx = table.index
    if params.writeback_mode == "sig" and sig is not None:
        slot_active = torch.arange(sig.shape[0], device=x.device) < n_active
        eq = ((sig[None, :] == idx[:, None].to(sig.dtype))
              & slot_active[None, :])                            # [C,K]
        has = eq.any(dim=1)
        slot = torch.argmax(eq.to(torch.int32), dim=1)
        target = has & table.used & (idx > 0) & (n_active > 0)
        src = lm[torch.clamp(slot, 0, K - 1)]
        return table._replace(loc=torch.where(
            target[:, None], src.to(table.loc.dtype), table.loc))
    if params.writeback_last_only:
        target = idx == n_active
    else:
        target = (idx >= 1) & (idx <= n_active)
    target = target & table.used & (n_active > 0)
    src = lm[torch.clamp(idx - 1, 0, K - 1).to(torch.int64)]
    return table._replace(loc=torch.where(
        target[:, None], src.to(table.loc.dtype), table.loc))


# ---------------------------------------------------------------------------
# Full extraction tick (RANSAC.getLandmark, RANSAC.m:14-152)
# ---------------------------------------------------------------------------

def extract(table: LandmarkTable, scan: Scan, x: torch.Tensor,
            n_active: torch.Tensor, params: RansacParams, max_obs: int,
            sig: torch.Tensor = None,
            draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None
            ) -> Tuple[ObsBatch, LandmarkTable]:
    """One extraction tick: write-back → world points → wall search →
    perpendicular-foot landmarks → table update.  The wall search is the
    batched one (``find_walls_batched``) when ``params.n_hypotheses`` > 0,
    else the reference's one seed a round (``find_walls``); ``draws`` are
    that search's ((u, s) [NH,B] each, or [T,B] each)."""
    table = writeback(table, x, n_active, params, sig=sig)
    pose = x[:3]
    pts = scan_to_world(scan, pose)
    if params.n_hypotheses > 0:
        lines, line_ok, _, stats = find_walls_batched(
            pts, scan.valid, params, params.n_hypotheses, draws=draws,
            generator=generator)
    else:
        lines, line_ok, _, stats = find_walls(
            pts, scan.valid, params, draws=draws, generator=generator)
    feet = perpendicular_foot(lines[:, 0], lines[:, 1])
    return update_table(table, feet, line_ok, pose, params, max_obs,
                        cand_cov=foot_covariance(lines, stats))
