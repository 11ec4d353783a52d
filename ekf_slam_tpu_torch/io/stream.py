"""Streaming SLAM session (counterpart of ekf_slam_tpu/io/stream.py): the
reference's live operating mode, ``while(1) s.runSlam()`` over
``receive(laser)``/``receive(odom)`` (test_SLAM.m:16-18, SLAM.m:73-74).

Arriving ticks are buffered into windows of W ticks.  A full window is
run as W ``SlamSession.step`` calls (the JAX stream runs one ``lax.scan``
program a window); the session carry chains on the device from window to
window.  The window's outputs are stacked on the device, copied with
``non_blocking=True`` into pinned host buffers, and one CUDA event is
recorded after that copy: one device-to-host transfer a window, which
the host waits for only when it reads the results.  ``poll`` asks the
event (``Event.query()``) and waits on nothing; ``flush`` and the
``max_pending`` backpressure wait on it (``Event.synchronize()``).  On
the CPU a window is ready once it has run.

Per-tick latency is arrival to results-ready wall time (p50, p99, mean).
Dispatching a window runs its W ticks on the host, where the session's
tick enqueues its device work, so with unthrottled pushes a tick waits
for the rest of its window to arrive and for the next window's dispatch
before its results are read: about 2·W tick times.

The session's tick consumes its carry (P is updated in place), so the
stream keeps only the carry each ``step`` returns; the per-tick outputs
it hands back are numpy arrays sliced from the window's host copy.

Heartbeat checkpoints (``checkpoint_dir``): every ``checkpoint_every``
windows the carry and the session generator's state are saved, labelled
``step_%08d`` with the number of ticks that carry has run
(utils/checkpointing.py).  The carry is copied when its window is
dispatched, after the window's steps and before the next window's: with
``non_blocking=True`` into pinned host buffers, on the stream the steps
run on, before the window's event is recorded.  The file is written when
the window drains, after the event wait.  (The JAX stream saves the live
carry when a window drains, labelled with the ticks drained; by then the
carry may be up to ``max_pending`` windows newer than its label.)  The
buffers are allocated once and reused only after their file is written;
the write blocks ``poll`` for as long as it takes.  ``restore`` starts a
fresh stream from a checkpoint.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..session import StepOutput, stack_outputs
from ..utils import checkpointing as ckpt


@dataclass
class StreamStats:
    """Latency and throughput accounting of a streaming run."""
    n_ticks: int = 0
    t_first_arrival: Optional[float] = None
    t_last_done: Optional[float] = None
    latencies: List[float] = field(default_factory=list)

    def summary(self) -> dict:
        lat = np.asarray(self.latencies, np.float64)
        dur = ((self.t_last_done - self.t_first_arrival)
               if self.n_ticks and self.t_first_arrival is not None else 0.0)
        return {
            "ticks": float(self.n_ticks),
            "ticks_per_sec": self.n_ticks / dur if dur > 0 else float("inf"),
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3)
            if lat.size else 0.0,
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3)
            if lat.size else 0.0,
            "latency_mean_ms": float(lat.mean() * 1e3) if lat.size else 0.0,
        }


def _tree_map(fn, tree):
    """``fn`` on every tensor of a (nested) NamedTuple; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    return fn(tree)


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor, enqueued on the current
    stream (non-blocking)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t, non_blocking=True)


class StreamingSlamSession:
    """Live host feed into a ``session.SlamSession``.

    ``push(odom_pose, ranges)`` a tick as it arrives; completed per-tick
    outputs come back from ``push``/``poll``/``flush`` in arrival order.
    ``window`` ticks form one dispatch; up to ``max_pending`` windows are
    in flight before the host waits (backpressure).  With
    ``checkpoint_dir`` the carry is checkpointed every
    ``checkpoint_every`` windows (the module docstring)."""

    def __init__(self, session, n_beams: int, beam_angles,
                 window: int = 8, max_pending: int = 2,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 8, first_odom=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        if checkpoint_dir is not None and checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self.session = session
        self.window = window
        self.max_pending = max(1, max_pending)
        self._device = session.device
        self.beam_angles = torch.as_tensor(beam_angles, device=self._device)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.carry = session.init_carry(
            first_odom=first_odom,
            n_beams=(n_beams if session.control_source in ("icp", "fused")
                     else None))
        self._buf_odom: List[torch.Tensor] = []
        self._buf_rng: List[torch.Tensor] = []
        self._buf_draws: List[Any] = []
        self._buf_arrival: List[float] = []
        # in-flight windows: (host outputs, event or None, arrival times)
        self._pending: List[Tuple[StepOutput, Any, List[float]]] = []
        # the heartbeat of each in-flight window (None: none)
        self._beats: List[Optional[Tuple[int, List[Any], Any]]] = []
        # host buffer sets whose heartbeat has been written
        self._free_bufs: List[List[Any]] = []
        # completed per-tick outputs not yet handed to the caller
        self._ready: List[StepOutput] = []
        self._windows = 0         # windows dispatched
        self._ticks = 0           # ticks the carry has run
        self.stats = StreamStats()

    def restore(self, path: str) -> None:
        """Continue from a checkpoint of this session's configuration (a
        heartbeat ``step_%08d`` directory): its carry and generator state,
        before the first push; later heartbeats count on from its tick."""
        if self._ticks or self._buf_odom:
            raise RuntimeError("restore a stream before its first push")
        self.carry = ckpt.load_checkpoint(path, self.carry,
                                          generator=self.session.generator)
        self._ticks = ckpt.step_of(path)

    # -- feed ---------------------------------------------------------------
    def push(self, odom_pose, ranges, t_arrival: Optional[float] = None,
             draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> List[StepOutput]:
        """Feed one tick (the ``receive`` seam, SLAM.m:73-74): host arrays
        of the pose [3] and the ranges [B], cast to the session's dtype;
        ``draws`` the extractor's (u, s) for this tick, handed to
        ``SlamSession.step`` as it takes them.  Returns the per-tick
        outputs that completed, in arrival order."""
        now = time.perf_counter() if t_arrival is None else t_arrival
        if self.stats.t_first_arrival is None:
            self.stats.t_first_arrival = now
        dt = self.session.ekf_params.dtype
        self._buf_odom.append(torch.as_tensor(np.asarray(odom_pose),
                                              dtype=dt))
        self._buf_rng.append(torch.as_tensor(np.asarray(ranges), dtype=dt))
        self._buf_draws.append(draws)
        self._buf_arrival.append(now)
        if len(self._buf_odom) >= self.window:
            self._dispatch()
        return self.poll(block=False)

    def _upload(self, rows: List[torch.Tensor]) -> torch.Tensor:
        """The window's rows stacked on the session's device: through a
        pinned buffer and a non-blocking copy on CUDA."""
        x = torch.stack(rows)
        if self._device.type == "cuda":
            x = x.pin_memory().to(self._device, non_blocking=True)
        return x

    def _dispatch(self):
        """Run the buffered ticks and enqueue their outputs' copy to the
        host."""
        if not self._buf_odom:
            return
        odom = self._upload(self._buf_odom)
        rng = self._upload(self._buf_rng)
        draws, arrivals = self._buf_draws, self._buf_arrival
        self._buf_odom, self._buf_rng = [], []
        self._buf_draws, self._buf_arrival = [], []
        outs = []
        for i in range(len(arrivals)):
            self.carry, out = self.session.step(self.carry, odom[i], rng[i],
                                                self.beam_angles,
                                                draws=draws[i])
            outs.append(out)
        self._windows += 1
        self._ticks += len(arrivals)
        beat = None
        if (self.checkpoint_dir is not None
                and self._windows % self.checkpoint_every == 0):
            beat = self._heartbeat()
        host, event = self._to_host(stack_outputs(outs))
        self._pending.append((host, event, arrivals))
        self._beats.append(beat)
        # backpressure: bound the windows in flight
        while len(self._pending) > self.max_pending:
            self._drain_one(block=True)

    def _heartbeat(self) -> Tuple[int, List[Any], Any]:
        """Enqueue the copy of the carry into a free set of host buffers
        (pinned on CUDA, non-blocking; the window's event, recorded after,
        marks it complete).  Returns (its tick, the host leaves, the
        generator's state)."""
        leaves = ckpt.carry_leaves(self.carry)
        cuda = self._device.type == "cuda"
        if self._free_bufs:
            bufs = self._free_bufs.pop()
        else:
            bufs = [torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=cuda)
                    if isinstance(leaf, torch.Tensor) else None
                    for leaf in leaves]
        host = [b.copy_(leaf, non_blocking=cuda) if b is not None else leaf
                for b, leaf in zip(bufs, leaves)]
        return self._ticks, host, self.session.generator.get_state()

    def _write_heartbeat(self, beat: Tuple[int, List[Any], Any]) -> None:
        """Write a drained window's heartbeat, and free its buffers."""
        tick, host, state = beat
        ckpt.write_checkpoint(
            os.path.join(self.checkpoint_dir, f"step_{tick:08d}"), host,
            state, self.session.generator.device.type)
        self._free_bufs.append([h if isinstance(h, torch.Tensor) else None
                                for h in host])

    def _to_host(self, outs: StepOutput) -> Tuple[StepOutput, Any]:
        """The window's outputs on the host and the event that marks
        them ready (None: ready now).  On CUDA: pinned copies enqueued
        with ``non_blocking=True`` and one event recorded after them."""
        if self._device.type != "cuda":
            return outs, None
        host = _tree_map(_to_pinned, outs)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self._device))
        return host, event

    # -- results ------------------------------------------------------------
    def _drain_one(self, block: bool) -> bool:
        """Move the oldest in-flight window to the ready queue.  Returns
        whether a window completed."""
        if not self._pending:
            return False
        host, event, arrivals = self._pending[0]
        if event is not None:
            if not block and not event.query():
                return False
            event.synchronize()
        done = time.perf_counter()
        self._pending.pop(0)
        beat = self._beats.pop(0)
        if beat is not None:
            self._write_heartbeat(beat)
        self.stats.t_last_done = done
        self.stats.n_ticks += len(arrivals)
        self.stats.latencies.extend(done - a for a in arrivals)
        arrays = _tree_map(lambda t: t.numpy(), host)
        self._ready.extend(_tree_map(lambda a, i=i: a[i], arrays)
                           for i in range(len(arrivals)))
        return True

    def reset_stats(self) -> None:
        """Restart latency and throughput accounting (after a warm-up pass,
        whose first kernel builds are no latency statement)."""
        self.stats = StreamStats()

    def poll(self, block: bool = False) -> List[StepOutput]:
        """Collect completed per-tick outputs (non-blocking by default)."""
        while self._drain_one(block=block):
            block = False     # at most one blocking wait
        out, self._ready = self._ready, []
        return out

    def flush(self) -> List[StepOutput]:
        """Dispatch any partial window and wait for everything in flight."""
        self._dispatch()
        while self._pending:
            self._drain_one(block=True)
        out, self._ready = self._ready, []
        return out
