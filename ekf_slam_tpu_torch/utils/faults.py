"""Fault injection, and failure detection with rollback (counterpart of
ekf_slam_tpu/utils/faults.py).

* **injection** (simulator side): drop whole scans, blank beam sectors,
  corrupt odometry ticks.  The JAX injectors draw from a threefry key,
  which torch cannot reproduce; here each draws from an explicit
  ``torch.Generator``, or takes its draws handed in (``drop`` [T];
  ``hit`` [T] with ``start`` [T]; ``hit`` [T] with ``noise`` [T,3], the
  unscaled normals), so a parity run hands in the JAX draws.
* **detection + rollback** (filter side): ``check_tick`` rejects a tick
  whose result is non-finite, has a negative variance, or moved the
  pose further than is plausible; ``guarded`` then restores the state
  from before the tick.  Nothing is read back to the host.

The port's measurement updates P (or the factor S) in place, so the
state before the tick no longer exists once the verdict is known: the
session copies P into a snapshot buffer before it measures and hands
that snapshot to ``guarded`` as ``before.P``.  ``guarded`` writes its
result into ``after.P`` in place by a masked select (never a blend with
the verdict as a 0/1 weight: a rejected P may hold NaN, and NaN·0 is
NaN), so a rejected tick leaves P bit for bit as the snapshot holds it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..state import FilterState


# ---------------------------------------------------------------------------
# Injection (host/sim side)
# ---------------------------------------------------------------------------

def drop_scans(ranges: torch.Tensor, generator: Optional[torch.Generator],
               p_drop: float, drop: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Blank entire scans with probability p_drop (NaN = no return, the
    simulator's no-hit encoding).  ``drop`` bool[T] replaces the draw."""
    T = ranges.shape[0]
    if drop is None:
        drop = torch.rand((T,), generator=generator,
                          device=generator.device) < p_drop
    return torch.where(drop.to(ranges.device)[:, None], torch.nan, ranges)


def blank_sectors(ranges: torch.Tensor, generator: Optional[torch.Generator],
                  p_tick: float, sector_frac: float = 0.25,
                  hit: Optional[torch.Tensor] = None,
                  start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Blank a contiguous beam sector (sensor occlusion) on random ticks:
    on a tick where ``hit`` is true, ``int(B·sector_frac)`` beams from
    ``start`` on, wrapping.  ``hit`` bool[T] and ``start`` int[T] in
    [0, B) replace the draws."""
    T, B = ranges.shape
    if hit is None:
        hit = torch.rand((T,), generator=generator,
                         device=generator.device) < p_tick
        start = torch.randint(0, B, (T,), generator=generator,
                              device=generator.device)
    hit, start = hit.to(ranges.device), start.to(ranges.device)
    width = int(B * sector_frac)
    idx = torch.arange(B, device=ranges.device)[None, :]
    in_sector = torch.remainder(idx - start[:, None], B) < width
    return torch.where(hit[:, None] & in_sector, torch.nan, ranges)


def corrupt_odometry(odom: torch.Tensor, generator: Optional[torch.Generator],
                     p_tick: float, magnitude: float = 5.0,
                     hit: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inject gross odometry outliers (wheel slip, encoder glitch): on a
    tick where ``hit`` is true, add ``noise``·[magnitude, magnitude, 90]
    to the pose.  ``hit`` bool[T] and ``noise`` [T,3] (standard normals)
    replace the draws."""
    T = odom.shape[0]
    if hit is None:
        hit = torch.rand((T,), generator=generator,
                         device=generator.device) < p_tick
        noise = torch.randn((T, 3), generator=generator, dtype=odom.dtype,
                            device=generator.device)
    hit, noise = hit.to(odom.device), noise.to(odom.device)
    scale = torch.tensor([magnitude, magnitude, 90.0], dtype=noise.dtype,
                         device=noise.device)
    return torch.where(hit[:, None], odom + noise * scale, odom)


# ---------------------------------------------------------------------------
# Detection + rollback (device side)
# ---------------------------------------------------------------------------

class TickVerdict(NamedTuple):
    ok: torch.Tensor          # bool
    finite: torch.Tensor      # bool
    diag_ok: torch.Tensor     # bool  covariance diagonal stayed positive
    jump_ok: torch.Tensor     # bool  pose step below the plausibility bound


def check_tick(before: FilterState, after: FilterState,
               max_pose_jump: float = 1.0,
               factored: bool = False) -> TickVerdict:
    """Device-side sanity verdict for one tick's filter transition.

    ``factored``: the state's P field holds a square-root factor (models/
    srekf.py, srekf_fast.py), so the variances are its row norms
    ``sum(S*S, 1)``: one more pass over S."""
    finite = torch.isfinite(after.x).all() & torch.isfinite(after.P).all()
    D = after.x.shape[0]
    idx = torch.arange(D, device=after.x.device)
    active_dim = 3 + 2 * after.n_active
    diag = ((after.P * after.P).sum(dim=1) if factored
            else torch.diagonal(after.P))
    diag_ok = torch.where(idx < active_dim, diag > -1e-6, True).all()
    d = after.x[:2] - before.x[:2]
    jump = torch.sqrt((d * d).sum())
    jump_ok = jump <= max_pose_jump
    return TickVerdict(ok=finite & diag_ok & jump_ok, finite=finite,
                       diag_ok=diag_ok, jump_ok=jump_ok)


def guarded(before: FilterState, after: FilterState,
            max_pose_jump: float = 1.0, factored: bool = False
            ) -> Tuple[FilterState, TickVerdict]:
    """Accept ``after`` only if the tick verdict passes; otherwise roll
    the filter back to ``before`` (the tick is treated as lost input).

    ``after.P`` is overwritten in place with the selected covariance;
    ``before.P`` must be a separate tensor (the session's snapshot)."""
    v = check_tick(before, after, max_pose_jump, factored=factored)
    ok = v.ok
    P = torch.where(ok, after.P, before.P, out=after.P)
    out = FilterState(
        x=torch.where(ok, after.x, before.x), P=P,
        sig=torch.where(ok, after.sig, before.sig),
        active=torch.where(ok, after.active, before.active),
        n_active=torch.where(ok, after.n_active, before.n_active))
    return out, v
