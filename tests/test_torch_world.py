"""ekf_slam_tpu_torch.sim.world's large-world helpers against
ekf_slam_tpu.sim.world on the CPU.

The helpers are host-side numpy in both packages, so they agree bit for
bit: the multi-room floorplan and the obstacle room (f64 worlds, as the
JAX package builds them under x64), the ground-truth feet and their
clustering, both map-accuracy scores, the serpentine route, its
pure-pursuit controls and the SE(2) alignment."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.sim import world as JW
from ekf_slam_tpu_torch.sim import world as TW

from torch_parity_helpers import n, t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _pair(nx, ny, seed, **kw):
    return (JW.floorplan_world(nx, ny, seed=seed, **kw),
            TW.floorplan_world(nx, ny, seed=seed, dtype=torch.float64,
                               device="cpu", **kw))


def _dict_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and np.isnan(a[k]):
            assert np.isnan(b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("nx,ny,seed,kw", [
    (3, 3, 0, {}), (4, 2, 5, {}), (2, 3, 1, dict(boxes=False)),
    (3, 2, 2, dict(room=6.0, door=1.2, wall_jitter_deg=2.0,
                   base_angle_deg=30.0, box_half=0.6))])
def test_floorplan_world_bit_equal(nx, ny, seed, kw):
    jw, tw = _pair(nx, ny, seed, **kw)
    np.testing.assert_array_equal(n(tw.segments), np.asarray(jw.segments))
    assert tw.segments.dtype == torch.float64


def test_floorplan_world_f32_and_obstacles():
    """A float32 world holds the f64 segments rounded once; the obstacle
    room equals JAX's."""
    jw = JW.floorplan_world(3, 3, seed=0)
    tw = TW.floorplan_world(3, 3, seed=0, device="cpu")
    assert tw.segments.dtype == torch.float32
    np.testing.assert_array_equal(
        n(tw.segments), np.asarray(jw.segments).astype(np.float32))
    boxes = ((1.0, 1.0, 0.5), (-2.0, 0.5, 0.3))
    np.testing.assert_array_equal(
        n(TW.world_with_obstacles(4.0, 3.0, boxes, dtype=torch.float64,
                                  device="cpu").segments),
        np.asarray(JW.world_with_obstacles(4.0, 3.0, boxes).segments))


@pytest.mark.parametrize("radius", [0.3, 0.5, 1.0])
def test_feet_and_clusters_bit_equal(radius):
    jw, tw = _pair(4, 4, 3)
    jf, tf = JW.true_feet(jw), TW.true_feet(tw)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(TW.cluster_feet(tf, radius),
                                  JW.cluster_feet(jf, radius))


def test_map_accuracy_bit_equal():
    """Both scores on estimates made from the feet with noise, a few
    spurious points, and no estimate at all."""
    jw, tw = _pair(3, 3, 4)
    gt = JW.cluster_feet(JW.true_feet(jw), 0.5)
    rng = np.random.default_rng(0)
    est = np.concatenate([gt[::2] + rng.normal(0, 0.2, gt[::2].shape),
                          rng.uniform(-20, 20, (5, 2))])
    for tol in (0.3, 0.6):
        _dict_equal(TW.map_accuracy(est, gt, tol), JW.map_accuracy(est, gt,
                                                                   tol))
        _dict_equal(TW.map_accuracy_lines(est, tw, tol),
                    JW.map_accuracy_lines(est, jw, tol))
    _dict_equal(TW.map_accuracy(np.zeros((0, 2)), gt),
                JW.map_accuracy(np.zeros((0, 2)), gt))
    _dict_equal(TW.map_accuracy_lines(np.zeros((0, 2)), tw),
                JW.map_accuracy_lines(np.zeros((0, 2)), jw))


@pytest.mark.parametrize("nx,ny,step,max_ticks", [
    (3, 3, 0.25, None), (4, 2, 0.3, 200), (2, 2, 0.25, 5000)])
def test_route_and_controls_bit_equal(nx, ny, step, max_ticks):
    wp_t, wp_j = (TW.serpentine_waypoints(nx, ny),
                  JW.serpentine_waypoints(nx, ny))
    np.testing.assert_array_equal(wp_t, wp_j)
    ct, st = TW.waypoint_controls(wp_t, step=step, max_ticks=max_ticks)
    cj, sj = JW.waypoint_controls(wp_j, step=step, max_ticks=max_ticks)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(st, sj)
    if max_ticks is not None:
        assert ct.shape == (max_ticks, 2)


def test_align_se2_bit_equal_and_recovers_a_transform():
    rng = np.random.default_rng(2)
    truth = rng.uniform(-10, 10, (50, 2))
    th = np.deg2rad(13.0)
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    est = (truth - [1.0, 2.0]) @ R + rng.normal(0, 0.01, truth.shape)
    Rt, tt = TW.align_se2(est, truth)
    Rj, tj = JW.align_se2(est, truth)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)
    assert np.abs(est @ Rt.T + tt - truth).max() < 0.05


def test_raycast_on_the_floorplan_matches():
    """The port's ray cast on a floorplan world equals JAX's noise-free
    ray cast at a few poses (f64, within 1e-9 m)."""
    jw, tw = _pair(3, 3, 0)
    ang = np.arange(0, 360, 2.0)
    for pose in ([0.0, 0.0, 0.0], [3.1, -2.2, 71.0], [-6.0, 5.5, 200.0]):
        a = JW.raycast(jw, jnp.asarray(pose), jnp.asarray(ang), 10.0)
        b = TW.raycast(tw, t(np.asarray(pose)), t(ang), 10.0)
        np.testing.assert_array_equal(np.isnan(n(b)), np.isnan(np.asarray(a)))
        ok = ~np.isnan(np.asarray(a))
        assert np.abs(n(b)[ok] - np.asarray(a)[ok]).max() <= 1e-9


@pytest.mark.parametrize("capacity,control", [(10000, "fused"),
                                              (1000, "odometry"),
                                              (256, "icp")])
def test_campaign_params_match_the_example(capacity, control):
    """checks.campaign_params is the port's copy of examples/
    large_world_slam.py:37-80 followed by tuned_params(..., batch=max_obs)
    (experiments/chip_r5_world.py:73): field for field the JAX package's
    configuration; at 10k landmarks rows P·Hᵀ, bf16 P and the SYRK
    correction; and the campaign's route helper gives the floorplan and
    controls of experiments/chip_r5_world.py:51-63."""
    import os
    import runpy
    from ekf_slam_tpu.utils.schedule import tuned_params as jtuned
    from ekf_slam_tpu_torch.checks import campaign_params, campaign_route
    from torch_parity_helpers import port
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ex = runpy.run_path(os.path.join(root, "examples", "large_world_slam.py"))
    jep, jrp = ex["campaign_params"](capacity, jnp.float32, control, 0.5)
    jep = jtuned(jep, batch=jep.max_obs)
    tep, trp = campaign_params(capacity, torch.float32, control, 0.5)
    assert tep == port(jep) and trp == port(jrp)
    if capacity == 10000:
        assert (tep.pht_mode, tep.cov_dtype, tep.correction,
                tep.guard_max_jump, trp.table_capacity,
                trp.n_hypotheses) == ("rows", torch.bfloat16, "syrk", 0.5,
                                      20000, 192)
    world, ctrl, start = campaign_route(3, 50)
    jw = JW.floorplan_world(3, 3, seed=0)
    jc, js = JW.waypoint_controls(JW.serpentine_waypoints(3, 3), step=0.25)
    np.testing.assert_array_equal(n(world.segments), np.asarray(jw.segments))
    np.testing.assert_array_equal(ctrl, jc[:50])
    np.testing.assert_array_equal(start, js)


def test_evict_case_spreads_the_traces():
    """checks.evict_case: the benchmark's full state with per-slot
    variances raised, so a cut at a quantile of the traces drops about
    that share of slots, also in bf16; P stays bit-symmetric."""
    from ekf_slam_tpu_torch.checks import bench_params, evict_case
    from ekf_slam_tpu_torch.models.maintenance import (_slot_traces,
                                                       prune_by_uncertainty)
    for cov in (None, torch.bfloat16):
        ep = bench_params(200, cov_dtype=cov, correction="gemm"
                          if cov is None else "syrk")
        st = evict_case(ep, seed=0, device="cpu")
        assert torch.equal(st.P, st.P.T)
        tr = _slot_traces(st, False).float()
        cut = float(torch.quantile(tr, 0.75))
        frac = float(prune_by_uncertainty(st, cut).float().mean())
        assert 0.2 <= frac <= 0.3, frac
