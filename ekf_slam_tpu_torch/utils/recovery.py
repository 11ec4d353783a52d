"""Crash recovery: checkpointed sessions that survive being killed
(counterpart of ekf_slam_tpu/utils/recovery.py).

* ``run_with_checkpoints`` advances a session in chunks of ``every``
  ticks and checkpoints its carry and its generator after each chunk,
  optionally dying before a chunk (``die_at_tick``) to stand in for a
  host crash;
* ``drive_ticks`` advances it tick by tick and checkpoints before the
  tick's step: the step consumes its carry (P is updated in place), so
  the host copy is taken first;
* ``resume_latest`` and ``resume_latest_ticks`` are what the restarted
  host runs: a fresh session loads the newest checkpoint and replays the
  input stream from its tick.

The session's state is its carry and its generator, which draws the
extractor's hypotheses; a checkpoint holds both, so the resumed run is
the uninterrupted one bit for bit.  The resumers build their template
with ``init_carry``, which reseeds the generator, and restore the
generator's state after it.  Every driver takes ``draws``, one (u, s)
pair per tick of the whole stream indexed by the global tick, as
``SlamSession.run`` takes them.

A carry saved on one device restores onto any other (the template's);
the generator's state restores only onto a generator of the same device
type.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from . import checkpointing as ckpt


class HostCrash(RuntimeError):
    """Simulated host death (fault injection for recovery tests)."""


def _first_carry(session, odom, ranges, start_tick: int):
    """A fresh carry anchored at the odometry before ``start_tick``."""
    return session.init_carry(
        first_odom=odom[0] if start_tick == 0 else odom[start_tick - 1],
        n_beams=(ranges.shape[1]
                 if session.control_source in ("icp", "fused") else None))


def _inputs(session, odom, ranges):
    return (torch.as_tensor(odom, device=session.device),
            torch.as_tensor(ranges, device=session.device))


def run_with_checkpoints(session, odom, ranges, beam_angles, ckpt_dir: str,
                         every: int = 25, carry=None,
                         die_at_tick: Optional[int] = None,
                         start_tick: int = 0,
                         draws: Optional[Sequence] = None):
    """Run ``session`` over the stream from ``start_tick``, checkpointing
    after every chunk of ``every`` ticks and at the end.  ``die_at_tick``
    raises HostCrash before the chunk that would pass it, losing the
    ticks after the last checkpoint.

    Returns (final carry, poses [T - start_tick, 3], next tick)."""
    odom, ranges = _inputs(session, odom, ranges)
    T = odom.shape[0]
    if carry is None:
        carry = _first_carry(session, odom, ranges, start_tick)
    if start_tick >= T:        # the snapshot already covers the stream
        return carry, odom.new_zeros((0, 3)), start_tick
    poses = []
    t = start_tick
    while t < T:
        t1 = min(t + every, T)
        if die_at_tick is not None and die_at_tick < t1:
            raise HostCrash(f"simulated crash at tick {die_at_tick} "
                            f"(last checkpoint: {t})")
        carry, outs = session.run(odom[t:t1], ranges[t:t1], beam_angles,
                                  carry=carry,
                                  draws=None if draws is None
                                  else draws[t:t1])
        poses.append(outs.pose)
        ckpt.save_checkpoint(ckpt_dir, carry, step=t1,
                             generator=session.generator)
        t = t1
    return carry, torch.cat(poses), t


def drive_ticks(session, odom, ranges, beam_angles, ckpt_dir=None,
                every: int = 0, carry=None,
                die_at_tick: Optional[int] = None, start_tick: int = 0,
                draws: Optional[Sequence] = None):
    """Tick-by-tick driver: with ``ckpt_dir``, a checkpoint before the
    step of every tick ``t > start_tick`` with ``t % every == 0`` (the
    host copy is complete before the step that consumes the carry is
    enqueued), and one at the end; ``die_at_tick`` raises HostCrash
    before that tick's step.

    Returns (final carry, poses [T - start_tick, 3], next tick)."""
    odom, ranges = _inputs(session, odom, ranges)
    T = odom.shape[0]
    if carry is None:
        carry = _first_carry(session, odom, ranges, start_tick)
    poses = []
    for t in range(start_tick, T):
        if ckpt_dir is not None and every and t > start_tick and (
                t % every == 0):
            ckpt.save_checkpoint(ckpt_dir, carry, step=t,
                                 generator=session.generator)
        if die_at_tick is not None and t == die_at_tick:
            raise HostCrash(f"simulated crash at tick {t}")
        carry, out = session.step(carry, odom[t], ranges[t], beam_angles,
                                  draws=None if draws is None else draws[t])
        poses.append(out.pose)
    if ckpt_dir is not None:
        ckpt.save_checkpoint(ckpt_dir, carry, step=T,
                             generator=session.generator)
    hist = torch.stack(poses) if poses else odom.new_zeros((0, 3))
    return carry, hist, T


def _load_latest(session, odom, ranges, ckpt_dir: str):
    """The newest checkpoint's carry, restored onto a template of
    ``session`` (built first: it reseeds the generator, whose state is
    restored after it), and its tick."""
    latest = ckpt.latest_step_dir(ckpt_dir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    template = _first_carry(session, odom, ranges, 0)
    carry = ckpt.load_checkpoint(latest, template,
                                 generator=session.generator)
    return carry, ckpt.step_of(latest)


def resume_latest_ticks(session, odom, ranges, beam_angles, ckpt_dir: str,
                        every: int = 0, draws: Optional[Sequence] = None
                        ) -> Tuple[Any, torch.Tensor, int]:
    """Restart path of the tick-by-tick driver: load the newest
    checkpoint into the fresh ``session`` and continue with
    ``drive_ticks``.  Returns (final carry, poses from the resumed tick,
    resumed tick)."""
    odom, ranges = _inputs(session, odom, ranges)
    carry, start = _load_latest(session, odom, ranges, ckpt_dir)
    final, poses, _ = drive_ticks(session, odom, ranges, beam_angles,
                                  ckpt_dir, every=every, carry=carry,
                                  start_tick=start, draws=draws)
    return final, poses, start


def resume_latest(session, odom, ranges, beam_angles, ckpt_dir: str,
                  every: int = 25, draws: Optional[Sequence] = None
                  ) -> Tuple[Any, torch.Tensor, int]:
    """Restart path: a FRESH ``session`` (the restarted host's; only the
    checkpoint directory and the replayable input stream carry state
    across the crash) loads the newest checkpoint and replays the tail
    with ``run_with_checkpoints``.  Returns (final carry, poses from the
    resumed tick, resumed tick)."""
    odom, ranges = _inputs(session, odom, ranges)
    carry, start = _load_latest(session, odom, ranges, ckpt_dir)
    final, poses, _ = run_with_checkpoints(
        session, odom, ranges, beam_angles, ckpt_dir, every=every,
        carry=carry, start_tick=start, draws=draws)
    return final, poses, start
