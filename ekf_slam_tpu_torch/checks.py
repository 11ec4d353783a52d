"""Inputs and runs shared by the port's on-card checks (``chip_smoke.py``
and ``tests/test_torch_cuda.py``): the K3 scoring case and one session run
on several devices with the same inputs.  Each caller keeps its own
shapes and tolerances."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

from .config import EKFParams, RansacParams, SimConfig
from .session import SlamSession
from .sim import world as W


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
