"""Occupancy-grid mapping (counterpart of ekf_slam_tpu/ops/occupancy.py).

A log-odds grid updated from (pose, scan): each beam is sampled at S
fixed fractions of its measured range; samples before the hit mark free
space, the endpoint marks occupied.  All beams × samples of a scan become
two flat ``index_add_`` calls of log-odds increments (the free-space adds,
then the occupied adds) into the flattened grid, then one clamp of the
whole grid at ±clamp, in the JAX package's order (occupancy.py:77-79).
Samples outside the grid, and samples of invalid beams, add 0 to cell
(0, 0), as in JAX (occupancy.py:64-68): no boolean indexing, so no host
sync.

The arithmetic follows the JAX function's dtypes step for step: the
ranges times the sample fractions in the ranges' dtype (the fractions
computed in f64 and rounded to it, as JAX's weakly typed f64 is), the
rest promoted as jnp promotes arrays, and the world coordinates divided
by the resolution (a true division: on CUDA PyTorch divides by a Python
float by multiplying with its reciprocal, so the divisor is a device
tensor).  Each product and sum is its own rounding; XLA's compiled
``map_session`` fuses ``pose + r·frac·dir`` into one multiply-add, and
the two differ only for a sample within an ulp of a cell edge, as the
last ulp of the degree trig does.  Within one ``index_add_`` every
increment a cell receives is the same number (or 0), so the order of
CUDA's atomics cannot change a sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import resolve_device, rounded
from .angles import cosd, sind
from .scan import Scan, scan_from_ranges


class OccupancyGrid(NamedTuple):
    """Log-odds grid: ``logodds[i, j]`` covers the cell with world x in
    ``origin[0] + [j, j+1) * resolution`` (x → columns, y → rows)."""
    logodds: torch.Tensor   # f[H, W]
    origin: torch.Tensor    # f[2] world position of cell (0, 0)'s corner
    resolution: float       # meters per cell


def init_grid(width: int, height: int, resolution: float,
              origin=(0.0, 0.0), dtype=torch.float32,
              device=None) -> OccupancyGrid:
    """An all-unknown (log-odds 0) grid of height × width cells on
    ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    return OccupancyGrid(
        logodds=torch.zeros((height, width), dtype=dtype, device=device),
        origin=torch.as_tensor(origin, dtype=dtype).to(device),
        resolution=float(resolution),
    )


def _fractions(n_samples: int, dtype, device) -> torch.Tensor:
    """(arange(S) + 0.5) / (S + 1) in f64, rounded to ``dtype``."""
    f64 = torch.float64
    num = torch.arange(n_samples, dtype=f64, device=device) + 0.5
    return (num / torch.full((), n_samples + 1.0, dtype=f64,
                             device=device)).to(dtype)


def _fuse_(lo: torch.Tensor, origin: torch.Tensor, res: float, scan: Scan,
           pose: torch.Tensor, frac: torch.Tensor, l_free: float,
           l_occ: float, clamp: float) -> None:
    """One scan's update of ``lo`` in place (frac: the sample fractions in
    the ranges' dtype)."""
    H, W = lo.shape
    dt = lo.dtype
    th = pose[2]
    ar = scan.ranges.dtype
    wt = torch.promote_types(scan.angles_deg.dtype, pose.dtype)
    st = torch.promote_types(torch.promote_types(ar, wt), pose.dtype)
    ct = torch.promote_types(st, origin.dtype)

    r = torch.where(scan.valid, scan.ranges, 0.0)
    wa = scan.angles_deg.to(wt) + th.to(wt)
    dirx, diry = cosd(wa).to(st), sind(wa).to(st)           # [B]
    rs = r.to(st)
    px, py = pose[0].to(st), pose[1].to(st)

    # free-space samples at fixed fractions of each ray (endpoint excluded)
    rf = (r[:, None] * frac[None, :]).to(st)                # [B,S]
    sx = px + rf * dirx[:, None]
    sy = py + rf * diry[:, None]
    # endpoint (occupied)
    ex = px + rs * dirx
    ey = py + rs * diry

    res_t = torch.full((), res, dtype=ct, device=lo.device)
    ox, oy = origin[0].to(ct), origin[1].to(ct)

    def to_flat(x, y):
        j = torch.floor((x.to(ct) - ox) / res_t).to(torch.int32)
        i = torch.floor((y.to(ct) - oy) / res_t).to(torch.int32)
        ok = (i >= 0) & (i < H) & (j >= 0) & (j < W)
        flat = i.to(torch.int64) * W + j.to(torch.int64)
        return torch.where(ok, flat, 0), ok

    fidx, fok = to_flat(sx.reshape(-1), sy.reshape(-1))
    oidx, ook = to_flat(ex, ey)
    fok = fok & scan.valid[:, None].expand(rf.shape).reshape(-1)
    ook = ook & scan.valid

    flat = lo.view(-1)
    flat.index_add_(0, fidx, torch.zeros(fok.shape, dtype=dt,
                                         device=lo.device).masked_fill_(
        fok, rounded(l_free, dt)))
    flat.index_add_(0, oidx, torch.zeros(ook.shape, dtype=dt,
                                         device=lo.device).masked_fill_(
        ook, rounded(l_occ, dt)))
    c = rounded(clamp, dt)
    lo.clamp_(-c, c)


def update_grid(grid: OccupancyGrid, scan: Scan, pose: torch.Tensor,
                n_samples: int = 64, l_free: float = -0.4,
                l_occ: float = 2.0, clamp: float = 10.0) -> OccupancyGrid:
    """Fuse one scan at ``pose`` into a copy of the grid, on the grid's
    device."""
    lo = grid.logodds.clone()
    frac = _fractions(n_samples, scan.ranges.dtype, lo.device)
    _fuse_(lo, grid.origin, grid.resolution, scan, pose, frac, l_free,
           l_occ, clamp)
    return grid._replace(logodds=lo)


def occupancy_probability(grid: OccupancyGrid) -> torch.Tensor:
    """P(occupied) per cell from log-odds."""
    return torch.sigmoid(grid.logodds)


def map_session(grid: OccupancyGrid, poses: torch.Tensor,
                ranges: torch.Tensor, beam_angles: torch.Tensor,
                n_samples: int = 64) -> OccupancyGrid:
    """Fuse a whole trajectory's scans (poses [T,3], ranges [T,B]) into a
    copy of the grid, one scan after another: the clamp between scans is
    part of the result, so the scans are not merged into one scatter."""
    lo = grid.logodds.clone()
    frac = _fractions(n_samples, ranges.dtype, lo.device)
    for t in range(poses.shape[0]):
        _fuse_(lo, grid.origin, grid.resolution,
               scan_from_ranges(ranges[t], beam_angles), poses[t], frac,
               -0.4, 2.0, 10.0)
    return grid._replace(logodds=lo)
