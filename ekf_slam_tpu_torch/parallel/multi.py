"""Data-parallel multi-session execution: many robots or worlds at once
(counterpart of ekf_slam_tpu/parallel/multi.py).

A fleet of N independent sessions advanced in lockstep: swarm mapping,
Monte-Carlo runs over tuning constants, batched replay of recorded logs.
The carry is one ``SessionCarry`` whose tensors carry a leading N axis, as
JAX's stacked carry does, and robot i draws from its own generator seeded
``seed + i`` (JAX gives robot i ``PRNGKey(seed + i)``, multi.py:71-73).

Where JAX compiles one vmapped program, this fleet advances the robots
one after another: one inner ``SlamSession`` steps robot i on its slice of
the stacked carry, with robot i's generator swapped in.  So a fleet tick
launches each of the tick's kernels once per robot, and the fault guard's
snapshot of P (one buffer of the inner session) serves every robot.  P is
updated in place in its slice; a field the step hands back in other
storage (the small fields every tick; P only where an eviction or a
recompression reallocates it) is copied into its slice, and
``copied_bytes`` counts what the last ``step`` copied.  Each robot's slice
of every field starts on a 512-byte boundary, as a tensor of its own
does, so the library calls on a slice pick the kernels they pick on a
solo session's tensors.  A tick reads nothing back to the host.

The mesh-sharded fleet waits for the sharded half of the distributed
layer: a ``mesh`` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..config import EKFParams, RansacParams
from ..session import SessionCarry, SlamSession, StepOutput

_ALIGN = 512      # bytes: the CUDA caching allocator's block alignment

SHARDED_HALF = ("a mesh-sharded fleet is the sharded half of ROADMAP §1 "
                "item 3 (MeshConfig, mesh.py, sharded.py, shard_update.py), "
                "not ported yet; pass mesh=None")


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensor leaves of a (nested) NamedTuple and the
    matching leaves of ``rest``; None and host ints (``sr_tick``) are
    taken from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, a, *(r[k] for r in rest))
                            for k, a in enumerate(tree)))
    return tree


def stack_aligned(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``torch.stack(xs)`` with each slice starting on a 512-byte
    boundary: one buffer, viewed with a padded leading stride."""
    x0 = xs[0]
    isz = x0.element_size()
    per = -(-max(x0.numel(), 1) * isz // _ALIGN) * _ALIGN // isz
    buf = torch.empty(len(xs) * per, dtype=x0.dtype, device=x0.device)
    inner = torch.empty(x0.shape, device="meta").stride()
    out = buf.as_strided((len(xs),) + tuple(x0.shape), (per,) + inner)
    for i, x in enumerate(xs):
        out[i].copy_(x)
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


@dataclasses.dataclass
class FleetSlamSession:
    """N independent sessions advanced in lockstep (on CUDA unless given
    ``device='cpu'``)."""

    n_sessions: int
    algorithm: str = "EKF_SLAM_UC"
    ekf_params: Optional[EKFParams] = None
    ransac_params: Optional[RansacParams] = None
    mesh: Optional[object] = None
    seed: int = 0
    device: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(SHARDED_HALF)
        self._inner = SlamSession(
            algorithm=self.algorithm, ekf_params=self.ekf_params,
            ransac_params=self.ransac_params, seed=self.seed,
            device=self.device)
        self.ekf_params = self._inner.ekf_params
        self.ransac_params = self._inner.ransac_params
        self.device = self._inner.device
        self.generators: List[torch.Generator] = [
            torch.Generator(device=self.device)
            for _ in range(self.n_sessions)]
        self.copied_bytes = 0

    def init_carry(self, first_odoms=None) -> SessionCarry:
        """The stacked initial carry (every tensor [N, ...]); reseeds
        robot i's generator with ``seed + i``."""
        one = self._inner.init_carry()    # reseeds the inner generator
        for i, g in enumerate(self.generators):
            g.manual_seed(self.seed + i)
        carry = tree_map(lambda a: stack_aligned([a] * self.n_sessions),
                         one)
        if first_odoms is not None:
            carry.old_odom.copy_(torch.as_tensor(
                first_odoms, device=self.device).to(self.ekf_params.dtype))
        return carry

    def step(self, carry: SessionCarry, odom_poses, ranges, beam_angles,
             draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]]
             = None) -> Tuple[SessionCarry, StepOutput]:
        """One tick for all sessions: odom [N,3], ranges [N,B]; ``draws``
        optionally one (u, s) pair per robot.  Consumes ``carry`` (its
        slices are updated in place) and returns it with the outputs
        stacked on a leading N axis."""
        dev = self.device
        odom_poses = torch.as_tensor(odom_poses, device=dev)
        ranges = torch.as_tensor(ranges, device=dev)
        beam_angles = torch.as_tensor(beam_angles, device=dev)
        outs, copied, sr_tick = [], [0], carry.sr_tick

        def write_back(dst, src):
            if not _same(dst, src):
                dst.copy_(src)
                copied[0] += src.numel() * src.element_size()

        for i in range(self.n_sessions):
            self._inner.generator = self.generators[i]
            ci = tree_map(lambda a: a[i], carry)
            new, out = self._inner.step(
                ci, odom_poses[i], ranges[i], beam_angles,
                draws=None if draws is None else draws[i])
            tree_map(write_back, ci, new)
            outs.append(out)
            sr_tick = new.sr_tick
        self.copied_bytes = copied[0]
        return (carry._replace(sr_tick=sr_tick),
                tree_map(lambda *xs: torch.stack(xs), *outs))

    def run(self, odom_poses, ranges, beam_angles,
            carry: Optional[SessionCarry] = None,
            draws: Optional[Sequence] = None
            ) -> Tuple[SessionCarry, StepOutput]:
        """Full sequences for all sessions: odom [T,N,3], ranges [T,N,B];
        ``draws`` optionally [T][N] pairs.  Returns the final carry and the
        outputs stacked [T,N,...]."""
        odom_poses = torch.as_tensor(odom_poses, device=self.device)
        ranges = torch.as_tensor(ranges, device=self.device)
        if carry is None:
            carry = self.init_carry(first_odoms=odom_poses[0])
        outs = []
        for t in range(odom_poses.shape[0]):
            carry, out = self.step(carry, odom_poses[t], ranges[t],
                                   beam_angles,
                                   draws=None if draws is None else draws[t])
            outs.append(out)
        return carry, tree_map(lambda *xs: torch.stack(xs), *outs)
