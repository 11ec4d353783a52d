"""ekf_slam_tpu_torch.ops.icp against ekf_slam_tpu.ops.icp on the CPU.

The same point sets, made with numpy from a seed, go through both
packages' fixed-iteration ICP: a known rigid transform, partial overlap
with padded (masked) tails, an empty previous scan (the session's first
tick), at f64 and f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops import icp as J
from ekf_slam_tpu_torch.ops import icp as I

from torch_parity_helpers import n, t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def room_points(m, seed, noise):
    """Points on the four walls of a 4 m × 3 m room (tests/test_icp.py's
    room_points)."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 4, m)
    side = rng.integers(0, 4, m)
    pts = np.zeros((m, 2))
    for k, (fx, fy) in enumerate((
            (lambda u: u - 2, lambda u: np.full_like(u, -1.5)),
            (lambda u: u - 2, lambda u: np.full_like(u, 1.5)),
            (lambda u: np.full_like(u, -2.0), lambda u: u * 0.75 - 1.5),
            (lambda u: np.full_like(u, 2.0), lambda u: u * 0.75 - 1.5))):
        sel = side == k
        pts[sel] = np.stack([fx(s[sel]), fy(s[sel])], -1)
    return pts + rng.normal(0, noise, (m, 2))


def apply_pose(pts, pose):
    th = np.deg2rad(pose[2])
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return pts @ R.T + pose[:2]


def _both(src, sv, dst, dv, dtype, **kw):
    jr = J.icp(jnp.asarray(src, dtype), jnp.asarray(sv),
               jnp.asarray(dst, dtype), jnp.asarray(dv), **kw)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tk = {k: (t(np.asarray(v, dtype)) if k == "init_pose" else v)
          for k, v in kw.items()}
    tr = I.icp(t(src, tdt), t(sv), t(dst, tdt), t(dv), **tk)
    return jr, tr


TOL = {np.float64: 1e-9, np.float32: 2e-4}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_icp_known_transform(dtype):
    """A known transform (tests/test_icp.py:27-36): the port's pose equals
    JAX's (≤ 1e-9 at f64; within f32 rounding at f32), the inlier count
    equals, the RMSE agrees, and both recover the truth."""
    src = room_points(300, seed=1, noise=0.005)
    true_pose = np.array([0.3, -0.2, 8.0])
    dst = apply_pose(src, true_pose)
    ones = np.ones(300, bool)
    jr, tr = _both(src, ones, dst, ones, dtype, iters=25)
    assert tr.pose.dtype == (torch.float64 if dtype == np.float64
                             else torch.float32)
    assert np.abs(n(tr.pose) - n(jr.pose)).max() <= TOL[dtype]
    assert int(tr.n_inliers) == int(jr.n_inliers) > 250
    assert tr.n_inliers.dtype == torch.int32
    assert abs(float(tr.rmse) - float(jr.rmse)) <= TOL[dtype]
    np.testing.assert_allclose(n(tr.pose), true_pose, atol=0.05)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_icp_partial_overlap_and_masks(dtype):
    """Different point sets with padded tails masked out and an explicit
    initial pose (tests/test_icp.py:39-50), with the defaults iters=20
    and max_pair_dist=0.75 and with other values."""
    src = room_points(400, seed=2, noise=0.01)
    true_pose = np.array([-0.2, 0.15, -5.0])
    dst = apply_pose(room_points(400, seed=3, noise=0.01), true_pose)
    sv = np.ones(400, bool)
    sv[350:] = False
    dv = np.ones(400, bool)
    dv[370:] = False
    for kw in (dict(init_pose=np.zeros(3)),
               dict(init_pose=np.array([0.05, 0.0, 2.0]), iters=30,
                    max_pair_dist=0.5)):
        jr, tr = _both(src, sv, dst, dv, dtype, **kw)
        assert np.abs(n(tr.pose) - n(jr.pose)).max() <= TOL[dtype]
        assert int(tr.n_inliers) == int(jr.n_inliers)
        assert abs(float(tr.rmse) - float(jr.rmse)) <= TOL[dtype]
        np.testing.assert_allclose(n(tr.pose)[:2], true_pose[:2], atol=0.1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_icp_empty_previous_scan(dtype):
    """No valid destination point (the session's first tick): every
    distance is the 1e9 sentinel, the nearest index is 0 as jnp.argmin
    gives it, no pair is kept, and the pose stays at the seed, in both
    packages; rmse 0 and no inlier."""
    src = room_points(64, seed=5, noise=0.0)
    none = np.zeros(64, bool)
    for seed in (np.zeros(3), np.array([0.04, 0.01, 3.0])):
        jr, tr = _both(src, np.ones(64, bool), np.zeros((64, 2)), none,
                       dtype, init_pose=seed, iters=15)
        np.testing.assert_array_equal(n(tr.pose), n(jr.pose))
        np.testing.assert_array_equal(n(tr.pose), seed.astype(dtype))
        assert int(tr.n_inliers) == int(jr.n_inliers) == 0
        assert float(tr.rmse) == float(jr.rmse) == 0.0


def test_transform_is_elementwise_and_matches():
    """``_transform`` writes the rotation out elementwise (no matrix
    product, so no TF32 path on the card): at f64 it equals JAX's
    ``pts @ rot.T + t`` within an ulp of the coordinates."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(-8, 8, (100, 2))
    pose = np.array([0.7, -1.3, 37.5])
    jo = J._transform(jnp.asarray(pts), jnp.asarray(pose))
    to = I._transform(t(pts), t(pose))
    assert np.abs(n(to) - n(jo)).max() <= 8 * np.finfo(np.float64).eps * 16
