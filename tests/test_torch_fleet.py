"""ekf_slam_tpu_torch.parallel's fleet modules against ekf_slam_tpu's on the
CPU at f64: FleetSlamSession (robot i drawing from PRNGKey(seed + i) in
JAX, handed those draws here) on tests/test_multi.py's streams, under the
sequential and the batched tick; the fleet against solo port sessions
with seeds seed + i (no draws handed in); robot_map_from_carry and
merge_maps on tests/test_fleet_merge.py's displaced starts (anchors within
1e-9, the same scan-match edges and landmarks); _dedupe;
ParallelSubmapSlam against JAX's and against the port's SubmapSlam; and
the sharded half (``mesh=``) raising."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import EKFParams, SimConfig
from ekf_slam_tpu.parallel import fleet_merge as jfm
from ekf_slam_tpu.parallel.multi import FleetSlamSession as JFleet
from ekf_slam_tpu.parallel.parallel_submaps import (
    ParallelSubmapSlam as JParallel)
from ekf_slam_tpu.sim import world as W
from ekf_slam_tpu_torch import SlamSession as TSession
from ekf_slam_tpu_torch import convert
from ekf_slam_tpu_torch.parallel import fleet_merge as tfm
from ekf_slam_tpu_torch.parallel import multi as tmu
from ekf_slam_tpu_torch.parallel import parallel_submaps as tps
from ekf_slam_tpu_torch.parallel import submaps as tsm

from torch_parity_helpers import n, port, session_draws
from test_fleet_merge import STARTS
from test_multi import fleet_streams
from test_sim_session import SIM_RANSAC
from test_submaps import make_loop_traj


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


N, T, SEED = 3, 30, 10
MODES = {"sequential": {}, "batched": dict(update_mode="batched")}


def _ep(mode):
    return EKFParams(capacity=16, max_obs=8, ref_compat=False,
                     dtype=jnp.float64, **MODES[mode])


def _rp(mode):
    return (SIM_RANSAC if mode == "sequential"
            else dataclasses.replace(SIM_RANSAC, n_hypotheses=16))


def fleet_draws(rp, seed, ticks, robots, beams):
    """[T][N] (u, s) pairs: robot i's stream from PRNGKey(seed + i)."""
    per = [session_draws(rp, seed + i, ticks, beams) for i in range(robots)]
    return [[per[i][t] for i in range(robots)] for t in range(ticks)]


@pytest.fixture(scope="module")
def streams():
    trajs, odom, ranges, beams = fleet_streams(N, T=T)
    return trajs, np.array(odom), np.array(ranges), np.array(beams)


@pytest.fixture(scope="module", params=sorted(MODES))
def fleets(request, streams):
    mode = request.param
    _, odom, ranges, beams = streams
    jf = JFleet(n_sessions=N, ekf_params=_ep(mode), ransac_params=_rp(mode),
                seed=SEED)
    jc, jo = jf.run(odom, ranges, beams)
    tf = tmu.FleetSlamSession(n_sessions=N, ekf_params=port(_ep(mode)),
                              ransac_params=port(_rp(mode)), seed=SEED,
                              device="cpu")
    tcar, to = tf.run(odom, ranges, beams,
                      draws=fleet_draws(_rp(mode), SEED, T, N,
                                        ranges.shape[2]))
    return mode, (jc, jo), (tf, tcar, to)


def test_fleet_matches_jax(fleets):
    """Every robot's poses each tick, and its final state, within 1e-9;
    n_active each tick equal."""
    _, (jc, jo), (_, tcar, to) = fleets
    assert tuple(to.pose.shape) == (T, N, 3)
    np.testing.assert_allclose(n(to.pose), n(jo.pose), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(n(to.n_active), n(jo.n_active))
    np.testing.assert_array_equal(n(to.n_obs), n(jo.n_obs))
    assert int(n(to.n_active)[-1].min()) > 0
    for f in ("x", "P", "sig"):
        np.testing.assert_allclose(n(getattr(tcar.filt, f)),
                                   n(getattr(jc.filt, f)), rtol=0,
                                   atol=1e-9, err_msg=f)
    np.testing.assert_array_equal(n(tcar.filt.active), n(jc.filt.active))
    for f in ("observe", "index", "used"):
        np.testing.assert_array_equal(n(getattr(tcar.table, f)),
                                      n(getattr(jc.table, f)))


def test_fleet_carry_is_stacked_and_aligned(fleets):
    """A leading N axis on every tensor, each robot's slice 512 bytes
    past a multiple of the first's (the CUDA allocator aligns the first to
    512 bytes), P updated in place (no copy of P back into its slice)."""
    _, _, (tf, tcar, _) = fleets
    for leaf in (tcar.filt.x, tcar.filt.P, tcar.filt.n_active,
                 tcar.table.loc, tcar.old_odom):
        assert leaf.shape[0] == N
        for i in range(N):
            assert (leaf[i].data_ptr() - leaf[0].data_ptr()) % 512 == 0
            assert leaf[i].is_contiguous()
    D = tcar.filt.P.shape[1]
    assert 0 < tf.copied_bytes < N * D * D * 8


def test_fleet_matches_solo_port_sessions(streams):
    """Without draws robot i draws from its own generator seeded seed + i:
    the fleet equals solo sessions of those seeds bit for bit; and a
    second run of the same fleet (init_carry reseeds) equals the first."""
    trajs, odom, ranges, beams = streams
    ep, rp = port(_ep("batched")), port(_rp("batched"))
    tf = tmu.FleetSlamSession(n_sessions=N, ekf_params=ep, ransac_params=rp,
                              seed=SEED, device="cpu")
    c1, o1 = tf.run(odom, ranges, beams)
    c2, o2 = tf.run(odom, ranges, beams)
    assert torch.equal(o1.pose, o2.pose) and torch.equal(c1.filt.P, c2.filt.P)
    for i in range(N):
        s = TSession(ekf_params=ep, ransac_params=rp, seed=SEED + i,
                     device="cpu")
        ci, oi = s.run(odom[:, i], ranges[:, i], beams)
        assert torch.equal(o2.pose[:, i], oi.pose)
        assert torch.equal(o2.n_active[:, i], oi.n_active)
        assert torch.equal(c2.filt.P[i], ci.filt.P)
        assert torch.equal(c2.filt.x[i], ci.filt.x)


def test_fleet_step_with_draws_equals_solo_steps(streams):
    """One fleet tick with draws handed in equals each robot's solo step
    on the same draws."""
    _, odom, ranges, beams = streams
    ep, rp = port(_ep("batched")), port(_rp("batched"))
    d = fleet_draws(_rp("batched"), 5, 2, N, ranges.shape[2])
    tf = tmu.FleetSlamSession(n_sessions=N, ekf_params=ep, ransac_params=rp,
                              device="cpu")
    c = tf.init_carry(first_odoms=odom[0])
    for t in range(2):
        c, o = tf.step(c, odom[t], ranges[t], beams, draws=d[t])
    for i in range(N):
        s = TSession(ekf_params=ep, ransac_params=rp, device="cpu")
        ci = s.init_carry(first_odom=odom[0, i])
        for t in range(2):
            ci, oi = s.step(ci, odom[t, i], ranges[t, i], beams,
                            draws=d[t][i])
        assert torch.equal(o.pose[i], oi.pose)
        assert torch.equal(c.filt.P[i], ci.filt.P)


# -- the fleet map merge ------------------------------------------------------
@pytest.fixture(scope="module")
def robot_maps():
    """tests/test_fleet_merge.py's three robots from displaced starts in the
    room with obstacles (80 ticks each, the batched JAX fleet), and the
    noisy deployment guesses; each robot's RobotMap from both packages'
    robot_map_from_carry on the same carry."""
    cfg = SimConfig(n_beams=720, max_range=12.0, range_noise_std=0.005,
                    odom_xy_noise_std=0.0005, odom_theta_noise_std=0.02)
    room = W.world_with_obstacles(4.0, 3.0)
    trajs = [W.simulate(room, W.circle_controls(80, 0.05, 3.0 + i), cfg,
                        jax.random.PRNGKey(i), start_pose=tuple(STARTS[i]))
             for i in range(3)]
    fleet = JFleet(n_sessions=3, ekf_params=_ep("batched"),
                   ransac_params=SIM_RANSAC, seed=1)
    carry, _ = fleet.run(jnp.stack([t.odom for t in trajs], axis=1),
                         jnp.stack([t.ranges for t in trajs], axis=1),
                         trajs[0].beam_angles)
    rng = np.random.default_rng(7)
    jmaps, tmaps = [], []
    for k in range(3):
        guess = STARTS[k] + np.concatenate([rng.normal(0, 0.25, 2),
                                            rng.normal(0, 8.0, 1)])
        ck = jax.tree_util.tree_map(lambda a, k=k: np.array(a[k]), carry)
        r0, beams = np.array(trajs[k].ranges[0]), np.array(
            trajs[0].beam_angles)
        jmaps.append(jfm.robot_map_from_carry(ck, r0, beams, guess))
        tmaps.append(tfm.robot_map_from_carry(
            convert.carry_from_numpy(ck, device="cpu"), r0, beams, guess))
    return jmaps, tmaps


def test_robot_map_from_carry_matches(robot_maps):
    jmaps, tmaps = robot_maps
    for a, b in zip(tmaps, jmaps):
        np.testing.assert_array_equal(a.anchor_guess, b.anchor_guess)
        np.testing.assert_array_equal(a.scan_valid, np.asarray(b.scan_valid))
        np.testing.assert_allclose(a.scan_pts, np.asarray(b.scan_pts),
                                   rtol=0, atol=1e-12)
        assert a.landmarks.shape == b.landmarks.shape
        assert a.landmarks.shape[0] > 0
        np.testing.assert_array_equal(a.landmarks, b.landmarks)


@pytest.mark.parametrize("robots", [3, 2, 1])
def test_merge_maps_matches(robot_maps, robots):
    """The same maps through both merges (tests/test_fleet_merge.py's
    gates): anchors within 1e-9, the same scan-match edges, the same
    merged landmarks within 1e-9, the same graph."""
    jmaps, _ = robot_maps
    maps = jmaps[:robots]
    tmaps = [tfm.RobotMap(anchor_guess=np.array(m.anchor_guess),
                          scan_pts=np.array(m.scan_pts),
                          scan_valid=np.array(m.scan_valid),
                          landmarks=np.array(m.landmarks)) for m in maps]
    want = jfm.merge_maps(maps, icp_min_inliers=80, icp_max_rmse=0.2)
    got = tfm.merge_maps(tmaps, icp_min_inliers=80, icp_max_rmse=0.2,
                         device="cpu")
    assert got.graph.nodes.dtype == torch.float64
    assert got.n_icp_edges == want.n_icp_edges
    assert got.n_icp_edges >= (1 if robots > 1 else 0)
    np.testing.assert_allclose(got.anchors, want.anchors, rtol=0, atol=1e-9)
    assert got.n_before_merge == want.n_before_merge
    assert got.landmarks.shape == want.landmarks.shape
    np.testing.assert_allclose(got.landmarks, want.landmarks, rtol=0,
                               atol=1e-9)
    assert got.graph.n_edges == int(want.graph.n_edges)
    np.testing.assert_allclose(n(got.graph.edge_z), n(want.graph.edge_z),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("radius", [0.2, 0.5, 3.0])
def test_dedupe_matches(radius):
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.normal(0, 2, (20, 2)),
                          rng.normal(0, 2, (20, 2)) * 0.01 + 1.0])
    want = jfm._dedupe(pts, radius)
    got = tfm._dedupe(pts, radius)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert tfm._dedupe(np.zeros((0, 2)), radius).shape == (0, 2)


# -- concurrent submaps -------------------------------------------------------
S, TP = 4, 120


@pytest.fixture(scope="module")
def parallel_runs():
    traj = make_loop_traj(T=TP)
    odom, ranges = np.array(traj.odom), np.array(traj.ranges)
    beams = np.array(traj.beam_angles)
    ep = _ep("sequential")
    js = JParallel(ekf_params=ep, ransac_params=SIM_RANSAC, n_submaps=S,
                   seed=1)
    jp = js.run(odom, ranges, traj.beam_angles)
    L = TP // S
    per = [session_draws(SIM_RANSAC, 1 + s, L, ranges.shape[1])
           for s in range(S)]
    draws = [d for s in range(S) for d in per[s]]
    ts = tps.ParallelSubmapSlam(ekf_params=port(ep),
                                ransac_params=port(SIM_RANSAC), n_submaps=S,
                                seed=1, device="cpu")
    tp = ts.run(odom, ranges, beams, draws=draws)
    # the serial pipeline over the same draws: segment s's ticks
    ser = tsm.SubmapSlam(ekf_params=port(ep), ransac_params=port(SIM_RANSAC),
                         ticks_per_submap=L, seed=1, device="cpu")
    sp = ser.run(odom, ranges, beams, draws=draws)
    return (js, jp), (ts, tp), (ser, sp)


def test_parallel_submaps_match_jax(parallel_runs):
    (js, jp), (ts, tp), _ = parallel_runs
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-9)
    assert len(ts.submaps) == S and ts.graph.n_nodes == S + 1
    assert ts.graph.n_edges == int(js.graph.n_edges) == S
    np.testing.assert_allclose(n(ts.graph.nodes), n(js.graph.nodes), rtol=0,
                               atol=1e-9)
    for a, b in zip(ts.submaps, js.submaps):
        assert a.n_landmarks == b.n_landmarks
        np.testing.assert_allclose(a.anchor, b.anchor, rtol=0, atol=1e-9)
        np.testing.assert_allclose(n(a.carry.filt.x), n(b.carry.filt.x),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(a.scan_pts, np.asarray(b.scan_pts),
                                   rtol=0, atol=1e-12)
    assert ts._last_carry.filt.P.shape[0] == S


def test_parallel_submaps_equal_the_serial_pipeline(parallel_runs):
    """Given the same draws a tick, segment s of the concurrent run is the
    serial pipeline's segment s bit for bit: poses, anchors, graph,
    frozen filter states."""
    _, (ts, tp), (ser, sp) = parallel_runs
    np.testing.assert_array_equal(tp, sp)
    assert torch.equal(ts.graph.nodes, ser.graph.nodes)
    for a, b in zip(ts.submaps, ser.submaps):
        np.testing.assert_array_equal(a.anchor, b.anchor)
        assert torch.equal(a.carry.filt.x, b.carry.filt.x)
        assert torch.equal(a.carry.filt.P, b.carry.filt.P)


def test_parallel_submaps_loop_closure_matches_jax(parallel_runs):
    """The anchor detector with ICP and optimize on the concurrent
    submaps, both packages (this adds edges to the fixture's pipelines, so
    it runs after the other checks of them)."""
    (js, _), (ts, _), _ = parallel_runs
    jn = js.detect_loop_closures(radius=3.0, min_separation=1,
                                 use_icp=True, icp_max_rmse=0.2,
                                 icp_min_inliers=100)
    tn = ts.detect_loop_closures(radius=3.0, min_separation=1,
                                 use_icp=True, icp_max_rmse=0.2,
                                 icp_min_inliers=100)
    assert tn == jn
    assert js.optimize(iters=10) and ts.optimize(iters=10)
    np.testing.assert_allclose(n(ts.graph.nodes), n(js.graph.nodes),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.global_landmarks(), js.global_landmarks(),
                               rtol=0, atol=1e-9)


def test_parallel_submaps_reject_ragged_t():
    traj = make_loop_traj(T=120)
    slam = tps.ParallelSubmapSlam(ekf_params=port(_ep("sequential")),
                                  ransac_params=port(SIM_RANSAC),
                                  n_submaps=7, seed=1, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        slam.run(np.array(traj.odom), np.array(traj.ranges),
                 np.array(traj.beam_angles))


@pytest.mark.parametrize("which", ["fleet", "parallel_submaps"])
def test_mesh_raises_not_implemented(which):
    """The sharded half of the distributed layer is not ported: a mesh
    raises, naming it, and never runs unsharded."""
    kw = dict(ekf_params=port(_ep("sequential")), mesh=object(),
              device="cpu")
    with pytest.raises(NotImplementedError, match="sharded half"):
        if which == "fleet":
            tmu.FleetSlamSession(n_sessions=2, **kw)
        else:
            tps.ParallelSubmapSlam(n_submaps=2, **kw)


def test_fleet_needs_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmu.FleetSlamSession(n_sessions=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.merge_maps([])
