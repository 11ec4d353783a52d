"""ekf_slam_tpu_torch.parallel.submaps against ekf_slam_tpu's on the CPU at
f64, on tests/test_submaps.py's loop trajectory (two circles in the
8 m × 6 m room, 720 beams, capacity 16).

Every segment's carry starts from a fresh ``init_carry``, so in JAX each
segment draws from ``PRNGKey(seed)`` again; the port is handed exactly
those draws, one pair a tick (``run(..., draws=)``).  Checked: the global
poses, the graph (nodes and edges), each frozen submap (anchor, landmark
count, end pose, filter state, stored scans) under odometry and ICP
control; both loop-closure detectors (anchor proximity with and without
ICP, and the trajectory detector) adding the same closures; ``optimize``,
``global_poses``, ``global_landmarks`` and ``global_trajectory_nodes``
after them, within 1e-9.  Port-only: without draws each segment equals a
fresh session's run over its ticks (the generator reseeded by every
``init_carry``), and a frozen submap's P shares no storage with the next
segment's P or the guard's snapshot."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.parallel.submaps import SubmapSlam as JSubmaps
from ekf_slam_tpu_torch import SlamSession as TSession
from ekf_slam_tpu_torch import config as tc
from ekf_slam_tpu_torch.parallel import submaps as tsm
from ekf_slam_tpu_torch.sim import world as tw

from torch_parity_helpers import n, port, session_draws
from test_sim_session import SIM_RANSAC
from test_submaps import make_loop_traj


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


EP = EKFParams(capacity=16, max_obs=8, ref_compat=False, dtype=jnp.float64)
SEED = 1


def segment_draws(rp, T: int, L: int, beams: int, seed: int = SEED):
    """The draws of a SubmapSlam run of T ticks in L-tick segments: each
    segment's carry restarts from PRNGKey(seed)."""
    out = []
    for t0 in range(0, T, L):
        out += session_draws(rp, seed, min(L, T - t0), beams)
    return out


def _inputs(traj):
    return (np.array(traj.odom), np.array(traj.ranges),
            np.array(traj.beam_angles))


def _run_both(traj, L, **kw):
    odom, ranges, beams = _inputs(traj)
    js = JSubmaps(ekf_params=EP, ransac_params=SIM_RANSAC,
                  ticks_per_submap=L, seed=SEED, **kw)
    jp = js.run(odom, ranges, traj.beam_angles)
    ts = tsm.SubmapSlam(ekf_params=port(EP), ransac_params=port(SIM_RANSAC),
                        ticks_per_submap=L, seed=SEED, device="cpu", **kw)
    tp = ts.run(odom, ranges, beams,
                draws=segment_draws(SIM_RANSAC, len(odom), L,
                                    ranges.shape[1]))
    return js, ts, jp, tp


def _assert_graphs(jg, tg, tol=1e-9):
    assert tg.n_nodes == int(jg.n_nodes) and tg.n_edges == int(jg.n_edges)
    for f in ("node_valid", "edge_ij", "edge_valid"):
        np.testing.assert_array_equal(n(getattr(tg, f)), n(getattr(jg, f)),
                                      err_msg=f)
    for f in ("nodes", "edge_z", "edge_info"):
        np.testing.assert_allclose(n(getattr(tg, f)), n(getattr(jg, f)),
                                   rtol=0, atol=tol, err_msg=f)


CONTROLS = {"odometry": {}, "icp": dict(session_kwargs=dict(
    control_source="icp"))}


@pytest.fixture(scope="module", params=sorted(CONTROLS))
def loop_runs(request):
    """Both pipelines over the 120-tick loop in 40-tick segments."""
    traj = make_loop_traj(T=120)
    return _run_both(traj, 40, **CONTROLS[request.param])


def test_poses_match(loop_runs):
    js, ts, jp, tp = loop_runs
    assert tp.shape == jp.shape == (120, 3)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9)
    assert len(ts._segment_local) == len(js._segment_local) == 3
    for a, b in zip(ts._segment_local, js._segment_local):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-9)


def test_graph_matches(loop_runs):
    js, ts, _, _ = loop_runs
    assert ts.graph.n_nodes == 4 and ts.graph.n_edges == 3
    _assert_graphs(js.graph, ts.graph)


def test_frozen_submaps_match(loop_runs):
    """Each frozen submap: anchor, node, landmark count (the decisions),
    end pose and filter state, its landmark table bit-equal."""
    js, ts, _, _ = loop_runs
    assert len(ts.submaps) == len(js.submaps) == 3
    for a, b in zip(ts.submaps, js.submaps):
        assert a.node_id == b.node_id and a.n_landmarks == b.n_landmarks
        assert a.n_landmarks > 0
        np.testing.assert_allclose(a.anchor, b.anchor, rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.end_local_pose, b.end_local_pose,
                                   rtol=0, atol=1e-9)
        for f in ("x", "P", "sig"):
            np.testing.assert_allclose(n(getattr(a.carry.filt, f)),
                                       n(getattr(b.carry.filt, f)), rtol=0,
                                       atol=1e-9, err_msg=f)
        np.testing.assert_array_equal(n(a.carry.filt.active),
                                      n(b.carry.filt.active))
        for f in ("observe", "index", "fresh", "used"):
            np.testing.assert_array_equal(n(getattr(a.carry.table, f)),
                                          n(getattr(b.carry.table, f)))


def test_stored_scans_match(loop_runs):
    """The representative scan in the submap frame and the keyframe scans
    (every 40 ticks: one a segment here) with their local poses."""
    js, ts, _, _ = loop_runs
    for a, b in zip(ts.submaps, js.submaps):
        np.testing.assert_array_equal(a.scan_valid, np.asarray(b.scan_valid))
        np.testing.assert_allclose(a.scan_pts, np.asarray(b.scan_pts),
                                   rtol=0, atol=1e-12)
        np.testing.assert_array_equal(a.kf_valid, b.kf_valid)
        np.testing.assert_allclose(a.kf_pts, b.kf_pts, rtol=0, atol=1e-12)
        np.testing.assert_allclose(a.kf_pose, b.kf_pose, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def detected():
    """Two circles in 30-tick segments (eight submaps, keyframes every 10
    ticks): run, then the anchor detector without and with ICP, the
    trajectory detector and optimize, in both packages; the graphs after
    each step."""
    traj = make_loop_traj(T=240)
    js, ts, jp, tp = _run_both(traj, 30, kf_every=10)
    _, ranges, beams = _inputs(traj)
    steps = {}
    for name, call in (
            ("anchor", lambda s: s.detect_loop_closures(radius=1.0)),
            ("anchor_icp", lambda s: s.detect_loop_closures(
                radius=1.0, use_icp=True, icp_max_rmse=0.15,
                icp_min_inliers=100)),
            ("traj", lambda s: s.detect_loop_closures_traj(
                ranges, beams, radius=1.0))):
        steps[name] = (call(js), call(ts), js.graph, ts.graph)
    opt = (js.optimize(iters=10), ts.optimize(iters=10))
    return js, ts, jp, tp, steps, opt


@pytest.mark.parametrize("step", ["anchor", "anchor_icp", "traj"])
def test_loop_closures_match(detected, step):
    """The same closures from each detector: the count (at least one) and
    every edge within 1e-9."""
    *_, steps, _ = detected
    jn, tn, jg, tg = steps[step]
    assert tn == jn and tn >= 1
    _assert_graphs(jg, tg)


def test_optimize_and_global_map_match(detected):
    js, ts, jp, tp, _, opt = detected
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9)
    assert opt == (True, True)
    _assert_graphs(js.graph, ts.graph)
    for a, b in zip(ts.submaps, js.submaps):
        np.testing.assert_allclose(a.anchor, b.anchor, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.global_trajectory_nodes(),
                               np.asarray(js.global_trajectory_nodes()),
                               rtol=0, atol=1e-9)
    gp = ts.global_poses()
    assert gp.shape == (240, 3)
    np.testing.assert_allclose(gp, js.global_poses(), rtol=0, atol=1e-9)
    gl, jl = ts.global_landmarks(), js.global_landmarks()
    assert gl.shape == jl.shape and gl.shape[0] > 8
    np.testing.assert_allclose(gl, jl, rtol=0, atol=1e-9)


def test_compose_inverse_and_transform_match():
    from ekf_slam_tpu.parallel import submaps as jsm
    rng = np.random.default_rng(3)
    for _ in range(8):
        a = np.array([*rng.normal(0, 4, 2), rng.uniform(0, 360)])
        b = np.array([*rng.normal(0, 4, 2), rng.uniform(-180, 360)])
        pts = rng.normal(0, 3, (5, 2))
        np.testing.assert_array_equal(tsm.compose(a, b), jsm.compose(a, b))
        np.testing.assert_array_equal(tsm.inverse_pose(a),
                                      jsm.inverse_pose(a))
        np.testing.assert_array_equal(tsm.transform_points(a, pts),
                                      jsm.transform_points(a, pts))
        ident = tsm.compose(a, tsm.inverse_pose(a))
        np.testing.assert_allclose(ident[:2], 0.0, atol=1e-12)


def _port_loop(T=90, B=256):
    cfg = tc.SimConfig(n_beams=B, max_range=12.0, range_noise_std=0.01,
                       odom_xy_noise_std=0.0005, odom_theta_noise_std=0.02,
                       dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    return tw.simulate(tw.rectangle_room(4.0, 3.0, torch.float64, "cpu"),
                       tw.circle_controls(T, 0.05, 6.0, torch.float64,
                                          "cpu"), cfg, g)


def _batched_guarded():
    """The batched tick with the fault guard on (so the session holds a
    snapshot buffer), tests/test_torch_session.py's extractor."""
    ep = dataclasses.replace(port(EP), update_mode="batched",
                             guard_max_jump=1.0)
    rp = tc.RansacParams(line_consensus=20, bearing_window_deg=20.0,
                         sample_points=8, wall_search_timeout=4,
                         table_capacity=32, promote_count=2,
                         ref_compat=False, n_hypotheses=16,
                         dtype=torch.float64)
    return ep, rp


def test_segments_without_draws_equal_fresh_sessions():
    """Without draws every segment restarts the session's generator from
    seed, so segment k equals a fresh session's run over its ticks from
    the same initial carry."""
    tr = _port_loop()
    ep, rp = _batched_guarded()
    sm = tsm.SubmapSlam(ekf_params=ep, ransac_params=rp, seed=3,
                        ticks_per_submap=30, device="cpu")
    sm.run(tr.odom, tr.ranges, tr.beam_angles)
    assert len(sm.submaps) == 3
    for k in range(3):
        t0 = 30 * k
        s = TSession(ekf_params=ep, ransac_params=rp, seed=3, device="cpu")
        c = s.init_carry(first_odom=tr.odom[max(t0 - 1, 0)])
        c, o = s.run(tr.odom[t0:t0 + 30], tr.ranges[t0:t0 + 30],
                     tr.beam_angles, carry=c)
        np.testing.assert_array_equal(sm._segment_local[k], n(o.pose))
        assert torch.equal(sm.submaps[k].carry.filt.P, c.filt.P)
        assert sm.submaps[k].n_landmarks == int(c.filt.n_active) > 0


def test_frozen_submap_shares_no_storage_with_the_next_segment():
    """A frozen submap's P is its own: not the next segment's P, not the
    guard's snapshot buffer, which the session reuses across segments."""
    tr = _port_loop()
    ep, rp = _batched_guarded()
    sm = tsm.SubmapSlam(ekf_params=ep, ransac_params=rp, seed=3,
                        ticks_per_submap=30, device="cpu")
    sm.run(tr.odom, tr.ranges, tr.beam_angles)
    snap = sm.session._snap
    assert snap is not None

    def ptr(t):
        return t.untyped_storage().data_ptr()
    ptrs = [ptr(s.carry.filt.P) for s in sm.submaps]
    assert len(set(ptrs)) == len(ptrs) and ptr(snap) not in ptrs
    frozen = [s.carry.filt.P.clone() for s in sm.submaps]
    sm.run(tr.odom[:60], tr.ranges[:60], tr.beam_angles)   # two more
    for s, want in zip(sm.submaps[:3], frozen):
        assert torch.equal(s.carry.filt.P, want)


def test_submaps_need_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsm.SubmapSlam(ekf_params=port(EP))
