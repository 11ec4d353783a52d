"""Matplotlib rendering with visual parity to the reference's plot stack
(counterpart of ekf_slam_tpu/viz.py, for the port's FilterState).

Reproduces the reference's live display elements so runs are visually
comparable (SURVEY.md §5 metrics/observability):

* robot glyph: circle + heading arrow, rotated/translated (drawRobot.m:1-39;
  note the reference pre-rotates by −90°, drawRobot.m:3)
* landmark markers: blue 'x' for state landmarks (EKF_SLAM.m:162-164), gray
  'x' for unpromoted candidates, red observation rays (RANSAC.m:376-404)
* covariance ellipses with the hard-coded chi-square 2.2788 and the
  0.25/0.50 robot/landmark scale factors (EKF_SLAM.m:179-229)
* world-frame scan scatter (SLAM.m:129-135)

Import is lazy-safe: matplotlib is only required when a plot function is
called (headless metric pipelines, and a card's machine without
matplotlib, never pay for it).  Tensors on any device are read back as
float64 numpy arrays (``np.asarray(a, float)`` in the JAX package), which
also reads a bf16 P, whose dtype numpy lacks.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import FilterState

_CHI_SQUARE = 2.2788          # EKF_SLAM.m:183 (hard-coded in the reference)
_ROBOT_ELLIPSE_SCALE = 0.25   # EKF_SLAM.m:198
_LM_ELLIPSE_SCALE = 0.50      # EKF_SLAM.m:224


def _np(a) -> np.ndarray:
    """A tensor (any device, bf16 included) or array as a host array:
    floating point as float64, booleans and integers as they are."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.double() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(float) if a.dtype.kind == "f" else a


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def robot_glyph(x, y, theta_deg, radius=0.25):
    """Circle + heading-arrow polylines (drawRobot.m geometry)."""
    th = np.deg2rad(theta_deg - 90.0)       # drawRobot.m:3 pre-rotation
    ang = np.deg2rad(np.arange(0, 361, 5))
    circ = np.stack([np.cos(ang), np.sin(ang)], -1) * radius
    p1, p2, p3, p4 = [0.2, -0.4], [0.2, 0.4], [0.6, 0.4], [0.0, 1.0]
    inv = np.array([-1.0, 1.0])
    arrow = np.array([p1, p2, p3, p4, inv * p3, inv * p2, inv * p1, p1])
    arrow = arrow * radius
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    t = np.array([x, y])
    return circ @ R.T + t, arrow @ R.T + t


def covariance_ellipse(mu, sigma, scale):
    """Ellipse polyline from a 2x2 covariance (EKF_SLAM.m:182-202 math,
    including its larger-eigenvalue-major convention)."""
    eigval, eigvec = np.linalg.eigh(np.asarray(sigma, float))
    # eigh sorts ascending; reference picks axes by comparing eigval order
    major = 2.0 * np.sqrt(max(_CHI_SQUARE * eigval[1], 0.0))
    minor = 2.0 * np.sqrt(max(_CHI_SQUARE * eigval[0], 0.0))
    arc = np.arctan2(eigvec[1, 1], eigvec[0, 1])
    t = np.arange(-np.pi, np.pi, 0.01)
    xy = np.stack([major * np.cos(t), minor * np.sin(t)], -1)
    R = np.array([[np.cos(arc), -np.sin(arc)], [np.sin(arc), np.cos(arc)]])
    return xy @ R.T * scale + np.asarray(mu, float)


def plot_state(state: FilterState, table=None, obs=None, scan_world=None,
               truth=None, ax=None, limits=(-5.0, 5.0, -4.0, 4.0)):
    """One reference-style frame: robot, landmarks, candidates, ellipses,
    observation rays, scan scatter (EKF_SLAM_UC.plot + RANSAC.plot +
    SLAM.runSlam plotting, composited)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 6))

    x = _np(state.x)
    n = int(state.n_active)
    P = _np(state.P[:3 + 2 * n, :3 + 2 * n])   # the blocks drawn, not all P

    if scan_world is not None:
        s = _np(scan_world)
        ax.scatter(s[:, 0], s[:, 1], s=1.0, c="magenta", alpha=0.4,
                   label="scan")

    circ, arrow = robot_glyph(x[0], x[1], x[2])
    ax.plot(circ[:, 0], circ[:, 1], "b-", lw=1)
    ax.plot(arrow[:, 0], arrow[:, 1], "r-", lw=1)

    ell = covariance_ellipse(x[:2], P[:2, :2], _ROBOT_ELLIPSE_SCALE)
    ax.plot(ell[:, 0], ell[:, 1], "g-", lw=0.8)

    for k in range(n):
        c = 3 + 2 * k
        ax.scatter(x[c], x[c + 1], marker="x", c="blue")
        ell = covariance_ellipse(x[c:c + 2], P[c:c + 2, c:c + 2],
                                 _LM_ELLIPSE_SCALE)
        ax.plot(ell[:, 0], ell[:, 1], "c-", lw=0.8)

    if table is not None:
        used = _np(table.used)
        idx = _np(table.index)
        loc = _np(table.loc)
        cand = used & (idx == 0)
        if cand.any():
            ax.scatter(loc[cand, 0], loc[cand, 1], marker="x",
                       c=[[0.5, 0.5, 0.5]], label="candidates")

    if obs is not None:
        v = _np(obs.valid)
        if v.any():
            r = _np(obs.rng)[v]
            b = _np(obs.bearing)[v]
            ex = x[0] + r * np.cos(np.deg2rad(b + x[2]))
            ey = x[1] + r * np.sin(np.deg2rad(b + x[2]))
            for xx, yy in zip(ex, ey):
                ax.plot([x[0], xx], [x[1], yy], "r-", lw=0.6)

    if truth is not None:
        t = _np(truth)
        ax.plot(t[:, 0], t[:, 1], "k--", lw=0.8, label="truth")

    ax.axis(limits)
    ax.set_aspect("equal")
    return ax


def save_frame(path: str, *args, **kwargs):
    plt = _plt()
    ax = plot_state(*args, **kwargs)
    ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(ax.figure)
    return path


class LiveView:
    """Per-tick live display — the reference's plot loop (EKF_SLAM.m:
    154-234 redrawn from SLAM.runSlam every tick, SLAM.m:131-139).

    On an interactive matplotlib backend the window updates in place
    (``plt.ion`` + draw/pause); on headless backends (Agg — this repo's
    default) the same loop can record an animated GIF instead
    (``gif_path``), so the live view exists everywhere the engine runs.

        view = viz.LiveView(gif_path="run.gif")
        for t in range(T):
            carry, out = sess.step(carry, odom[t], ranges[t], beams)
            view.update(carry.filt, table=carry.table, obs=out.obs)
        view.close()
    """

    def __init__(self, limits=(-5.0, 5.0, -4.0, 4.0), pause: float = 0.001,
                 gif_path=None, fps: int = 10, figsize=(7, 6), dpi: int = 80):
        plt = _plt()
        import matplotlib
        self._plt = plt
        self.limits = limits
        self.pause = pause
        self.fig, self.ax = plt.subplots(figsize=figsize, dpi=dpi)
        self.interactive = matplotlib.get_backend().lower() not in (
            "agg", "pdf", "svg", "ps", "cairo", "template")
        if self.interactive:
            plt.ion()
            self.fig.show()
        self._writer = None
        if gif_path is not None:
            from matplotlib.animation import PillowWriter
            self._writer = PillowWriter(fps=fps)
            self._writer.setup(self.fig, gif_path, dpi=dpi)
        self.frames = 0

    def update(self, state: FilterState, table=None, obs=None,
               scan_world=None, truth=None) -> None:
        """Redraw one tick (clears and repaints, like the reference's
        cla/plot cycle)."""
        self.ax.clear()
        plot_state(state, table=table, obs=obs, scan_world=scan_world,
                   truth=truth, ax=self.ax, limits=self.limits)
        self.ax.set_title(f"tick {self.frames}  "
                          f"landmarks {int(state.n_active)}")
        if self._writer is not None:
            self._writer.grab_frame()
        if self.interactive:
            self.fig.canvas.draw_idle()
            self._plt.pause(self.pause)
        self.frames += 1

    def close(self):
        """Finish the GIF (if recording) and release the figure."""
        if self._writer is not None:
            self._writer.finish()
            self._writer = None
        self._plt.close(self.fig)
