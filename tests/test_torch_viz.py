"""ekf_slam_tpu_torch.viz against ekf_slam_tpu.viz on the CPU (matplotlib's
Agg backend): the robot glyph and covariance ellipse geometry equal the
JAX package's; save_frame draws a port session's state (its f64 state,
and a bf16-P state, which numpy cannot hold) into a PNG; LiveView writes
a multi-frame GIF; importing the module does not import matplotlib."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ekf_slam_tpu import viz as jviz
from ekf_slam_tpu_torch import SlamSession
from ekf_slam_tpu_torch import config as tc
from ekf_slam_tpu_torch import viz
from ekf_slam_tpu_torch.ops.observations import ObsBatch
from ekf_slam_tpu_torch.ops.scan import scan_from_ranges, scan_to_world
from ekf_slam_tpu_torch.sim import world as tw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("pose", [(0.0, 0.0, 0.0), (1.5, -2.0, 33.0),
                                  (-0.3, 4.0, 359.9)])
def test_robot_glyph_equals_the_jax_packages(pose):
    for a, b in zip(viz.robot_glyph(*pose), jviz.robot_glyph(*pose)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(viz.robot_glyph(*pose, radius=0.4),
                    jviz.robot_glyph(*pose, radius=0.4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_covariance_ellipse_equals_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 0.3, (2, 2))
    sigma = A @ A.T
    mu = rng.uniform(-3, 3, 2)
    for scale in (0.25, 0.5):
        np.testing.assert_array_equal(
            viz.covariance_ellipse(mu, sigma, scale),
            jviz.covariance_ellipse(mu, sigma, scale))
    # the port's reads a tensor block as the JAX package reads an array
    np.testing.assert_array_equal(
        viz.covariance_ellipse(mu, torch.from_numpy(sigma), 0.5),
        jviz.covariance_ellipse(mu, sigma, 0.5))
    ell = viz.covariance_ellipse([0, 0], np.eye(2) * 0.04, 1.0)
    np.testing.assert_allclose(np.hypot(ell[:, 0], ell[:, 1]),
                               2 * np.sqrt(2.2788 * 0.04), atol=1e-6)


def _session(cov_dtype=None, T=40):
    """A T-tick run of the port's batched session (capacity 16) on the
    CPU: its carry, outputs and trajectory."""
    kw = dict(pht_mode="rows", correction="syrk",
              cov_dtype=cov_dtype) if cov_dtype is not None else {}
    ep = tc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode="batched", dtype=torch.float64, **kw)
    rp = tc.RansacParams(line_consensus=60, bearing_window_deg=15.0,
                         wall_search_timeout=4, table_capacity=32,
                         promote_count=5, ref_compat=False,
                         dtype=torch.float64)
    cfg = tc.SimConfig(n_beams=720, max_range=12.0, dtype=torch.float64)
    g = torch.Generator()
    g.manual_seed(0)
    traj = tw.simulate(tw.rectangle_room(4.0, 3.0, device="cpu"),
                       tw.circle_controls(T, 0.05, 3.0, device="cpu"), cfg,
                       g)
    sess = SlamSession(ekf_params=ep, ransac_params=rp, seed=1, device="cpu")
    carry, outs = sess.run(traj.odom, traj.ranges, traj.beam_angles)
    return carry, outs, traj


@pytest.mark.parametrize("cov_dtype", [None, torch.bfloat16],
                         ids=["f64", "bf16 P"])
def test_save_frame_of_a_session_state(tmp_path, cov_dtype):
    carry, outs, traj = _session(cov_dtype)
    if cov_dtype is not None:
        assert carry.filt.P.dtype == torch.bfloat16
    assert int(carry.filt.n_active) > 0
    last_obs = ObsBatch(*(None if a is None else a[-1] for a in outs.obs))
    sw = scan_to_world(scan_from_ranges(traj.ranges[-1], traj.beam_angles),
                       outs.pose[-1])
    p = viz.save_frame(str(tmp_path / "frame.png"), carry.filt,
                       table=carry.table, obs=last_obs, scan_world=sw,
                       truth=traj.truth)
    assert p == str(tmp_path / "frame.png")
    assert os.path.getsize(p) > 5000
    with open(p, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


def test_live_view_writes_a_multi_frame_gif(tmp_path):
    from PIL import Image
    carry, outs, traj = _session(T=6)
    gif = str(tmp_path / "live.gif")
    view = viz.LiveView(gif_path=gif)
    assert not view.interactive
    for k in range(3):
        view.update(carry.filt, table=carry.table,
                    obs=ObsBatch(*(None if a is None else a[k]
                                   for a in outs.obs)),
                    truth=traj.truth[:k + 1])
    view.close()
    assert view.frames == 3
    assert os.path.getsize(gif) > 1000
    with Image.open(gif) as im:
        assert im.format == "GIF" and im.n_frames == 3


def test_import_leaves_matplotlib_out():
    """Neither the package nor its viz module imports matplotlib (the
    card's machine has none)."""
    code = ("import sys; import ekf_slam_tpu_torch, ekf_slam_tpu_torch.viz; "
            "import ekf_slam_tpu_torch.examples.live_view; "
            "sys.exit(1 if 'matplotlib' in sys.modules else 0)")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
