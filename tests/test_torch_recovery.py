"""ekf_slam_tpu_torch's crash recovery (utils/recovery.py) on the CPU, at
f64 and capacity 16 on tests/test_recovery.py's trajectories.

A session checkpointed by ``run_with_checkpoints`` or ``drive_ticks`` is
killed (``die_at_tick``); a FRESH session resumes from the newest
checkpoint and must end bit for bit where an uninterrupted run ends: x,
P, n_active, the table and the generator's state, and the replayed
poses.  The runs draw from the session's generator (no ``draws=``), so a
resume that restored the generator before ``init_carry`` reseeds it
would draw the seed's first numbers again and part.  Against the JAX
package's drivers on the same stream, the port is handed the JAX
session's draws: the same checkpoints (steps, n_active, x and P within
1e-9), the same resumed tick and the same poses."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import EKFParams as JParams
from ekf_slam_tpu.session import SlamSession as JSession
from ekf_slam_tpu.utils import checkpointing as jckpt
from ekf_slam_tpu.utils import recovery as jrec
from ekf_slam_tpu.utils.faults import corrupt_odometry
from ekf_slam_tpu_torch import SlamSession
from ekf_slam_tpu_torch import session as session_mod
from ekf_slam_tpu_torch.utils import checkpointing as ckpt
from ekf_slam_tpu_torch.utils import recovery

from test_sim_session import SIM_RANSAC, make_traj
from torch_parity_helpers import n, port, session_draws


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traj80():
    tr, _ = make_traj(T=80)
    return tr


def arrays(tr):
    return np.array(tr.odom), np.array(tr.ranges), np.array(tr.beam_angles)


def jparams(guard=None, **kw):
    kw = dict(dict(update_mode="batched"), **kw)
    return JParams(capacity=16, max_obs=8, ref_compat=False,
                   dtype=jnp.float64, guard_max_jump=guard, **kw)


def make_session(seed=1, guard=None, ekf_kw=None, **kw):
    return SlamSession(algorithm="EKF_SLAM_UC",
                       ekf_params=port(jparams(guard, **(ekf_kw or {}))),
                       ransac_params=port(SIM_RANSAC), seed=seed,
                       device="cpu", **kw)


def assert_same_end(got, want):
    """Two final carries (and generators) bit-equal, leaf by leaf."""
    (c1, g1), (c2, g2) = got, want
    l1, l2 = ckpt.carry_leaves(c1), ckpt.carry_leaves(c2)
    assert len(l1) == len(l2)
    for i, (a, b) in enumerate(zip(l1, l2)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), i
        else:
            assert a == b, i
    assert torch.equal(g1.get_state(), g2.get_state())


def test_crash_resume_is_bit_continuous(traj80, tmp_path):
    """Kill at tick 47 (checkpoints every 20 → the last at 40); a fresh
    session resumes from it and replays the tail: the end state, the
    generator's state and the replayed poses equal an uninterrupted run's
    bit for bit (tests/test_recovery.py:31)."""
    odom, ranges, beams = arrays(traj80)
    ref = make_session()
    ref_carry, ref_poses, t_end = recovery.run_with_checkpoints(
        ref, odom, ranges, beams, str(tmp_path / "ref"), every=20)
    assert t_end == 80 and ref_poses.shape == (80, 3)
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(recovery.HostCrash):
        recovery.run_with_checkpoints(make_session(), odom, ranges, beams,
                                      crash_dir, every=20, die_at_tick=47)
    assert sorted(os.listdir(crash_dir)) == ["step_00000020",
                                             "step_00000040"]
    fresh = make_session()
    final, tail, start = recovery.resume_latest(fresh, odom, ranges, beams,
                                                crash_dir, every=20)
    assert start == 40
    assert_same_end((final, fresh.generator), (ref_carry, ref.generator))
    assert int(final.filt.n_active) >= 3
    assert torch.equal(tail, ref_poses[40:])
    # the uninterrupted run without checkpoints ends there too
    plain = make_session()
    c_plain, o_plain = plain.run(odom, ranges, beams)
    assert_same_end((c_plain, plain.generator), (ref_carry, ref.generator))
    assert torch.equal(o_plain.pose, ref_poses)


def test_resume_after_the_end_returns_the_snapshot(traj80, tmp_path):
    """Where the newest checkpoint already covers the stream, the resume
    returns its carry, no poses and the stream's length (recovery.py:59-60
    of the JAX package)."""
    odom, ranges, beams = arrays(traj80)
    odom, ranges = odom[:30], ranges[:30]
    carry, _, _ = recovery.run_with_checkpoints(
        make_session(), odom, ranges, beams, str(tmp_path), every=16)
    assert sorted(os.listdir(tmp_path)) == ["step_00000016",
                                            "step_00000030"]
    final, poses, start = recovery.resume_latest(
        make_session(), odom, ranges, beams, str(tmp_path), every=16)
    assert start == 30 and poses.shape == (0, 3)
    assert_same_end((final, torch.Generator()), (carry, torch.Generator()))


def test_recovery_composes_with_fault_injection(traj80, tmp_path):
    """Fused control, the guard (1 m) and odometry with wheel-slip
    outliers (the JAX package's corrupt_odometry, handed in as numpy);
    killed at tick 50 with checkpoints every 16, resumed from 48: finite,
    near the truth at the end (tests/test_recovery.py:66), and bit-equal
    to the uninterrupted run."""
    _, ranges, beams = arrays(traj80)
    bad_odom = np.array(corrupt_odometry(jnp.asarray(traj80.odom),
                                         jax.random.PRNGKey(7), p_tick=0.05,
                                         magnitude=3.0))
    assert np.any(bad_odom != np.asarray(traj80.odom))

    def fused_session():
        return make_session(guard=1.0, control_source="fused", icp_iters=15,
                            icp_max_pair_dist=0.5)
    ref = fused_session()
    ref_carry, ref_out = ref.run(bad_odom, ranges, beams)
    crash_dir = str(tmp_path / "faulty")
    with pytest.raises(recovery.HostCrash):
        recovery.run_with_checkpoints(fused_session(), bad_odom, ranges,
                                      beams, crash_dir, every=16,
                                      die_at_tick=50)
    fresh = fused_session()
    final, tail, start = recovery.resume_latest(fresh, bad_odom, ranges,
                                                beams, crash_dir, every=16)
    assert start == 48
    assert fresh._snap is not None          # the guard's own buffer
    assert bool(torch.isfinite(final.filt.x).all())
    pose = final.filt.x[:2].numpy()
    truth = np.asarray(traj80.truth[-1, :2])
    assert np.linalg.norm(pose - truth) < 0.75, (pose, truth)
    assert_same_end((final, fresh.generator), (ref_carry, ref.generator))
    assert torch.equal(tail, ref_out.pose[48:])


def test_drive_ticks_crash_resume_bit_continuous(tmp_path):
    """The tick-by-tick driver: a checkpoint before the step at every
    multiple of 20 past the start and one at the end; killed before the
    step of tick 47, resumed from 40 by ``resume_latest_ticks``, bit-equal
    to the uninterrupted driver (tests/test_recovery.py:109)."""
    tr, _ = make_traj(T=60)
    odom, ranges, beams = arrays(tr)
    ref = make_session()
    ref_carry, ref_poses, t_end = recovery.drive_ticks(
        ref, odom, ranges, beams, str(tmp_path / "ref"), every=20)
    assert t_end == 60
    assert sorted(os.listdir(tmp_path / "ref")) == [
        "step_00000020", "step_00000040", "step_00000060"]
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(recovery.HostCrash):
        recovery.drive_ticks(make_session(), odom, ranges, beams, crash_dir,
                             every=20, die_at_tick=47)
    assert sorted(os.listdir(crash_dir)) == ["step_00000020",
                                             "step_00000040"]
    fresh = make_session()
    final, tail, start = recovery.resume_latest_ticks(
        fresh, odom, ranges, beams, crash_dir, every=20)
    assert start == 40
    assert_same_end((final, fresh.generator), (ref_carry, ref.generator))
    assert torch.equal(tail, ref_poses[40:])
    assert sorted(os.listdir(crash_dir))[-1] == "step_00000060"


@pytest.mark.parametrize("resume", ["resume_latest", "resume_latest_ticks"])
def test_resume_without_checkpoint_raises(tmp_path, resume):
    tr, _ = make_traj(T=10)
    odom, ranges, beams = arrays(tr)
    with pytest.raises(FileNotFoundError):
        getattr(recovery, resume)(make_session(), odom, ranges, beams,
                                  str(tmp_path / "empty"))


def test_srekf_fast_resume_across_a_recompression(traj80, tmp_path,
                                                  monkeypatch):
    """The square-root session (16-column noise buffer: a recompression
    on every 16th tick), killed at 47 with checkpoints every 20: the
    resume starts at 40 with sr_tick 40 (a host int), recompresses on
    ticks 48, 64 and 80 (counted), and ends bit-equal to the
    uninterrupted run."""
    odom, ranges, beams = arrays(traj80)
    sr = dict(update_mode="srekf_fast", sr_noise_buffer=16)
    ref = make_session(ekf_kw=sr)
    ref_carry, ref_poses, _ = recovery.run_with_checkpoints(
        ref, odom, ranges, beams, str(tmp_path / "ref"), every=20)
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(recovery.HostCrash):
        recovery.run_with_checkpoints(make_session(ekf_kw=sr), odom, ranges,
                                      beams, crash_dir, every=20,
                                      die_at_tick=47)
    fresh = make_session(ekf_kw=sr)
    at40 = ckpt.load_checkpoint(
        ckpt.latest_step_dir(crash_dir),
        fresh.init_carry(first_odom=odom[0]))
    assert at40.sr_tick == 40 and type(at40.sr_tick) is int
    calls = []
    real = session_mod.sr_recompress

    def counted(filt):
        calls.append(1)
        return real(filt)
    monkeypatch.setattr(session_mod, "sr_recompress", counted)
    final, tail, start = recovery.resume_latest(fresh, odom, ranges, beams,
                                                crash_dir, every=20)
    assert start == 40 and len(calls) == 3 and final.sr_tick == 80
    assert_same_end((final, fresh.generator), (ref_carry, ref.generator))
    assert torch.equal(tail, ref_poses[40:])


def _jax_session(seed=1):
    return JSession(algorithm="EKF_SLAM_UC", ekf_params=jparams(),
                    ransac_params=SIM_RANSAC, seed=seed)


@pytest.mark.parametrize("driver", ["chunks", "ticks"])
def test_drivers_match_jax(traj80, tmp_path, driver):
    """The port's drivers, handed the JAX session's draws (one pair per
    tick of the whole stream, indexed by the global tick), against the
    JAX package's drivers on the same stream: killed at 47 and resumed,
    the same checkpoint steps, n_active equal at every checkpoint with x
    and P within 1e-9, the same resumed tick, and the final x, P and the
    replayed poses within 1e-9."""
    odom, ranges, beams = arrays(traj80)
    draws = session_draws(SIM_RANSAC, 1, 80, ranges.shape[1])
    run, resume = {"chunks": ("run_with_checkpoints", "resume_latest"),
                   "ticks": ("drive_ticks", "resume_latest_ticks")}[driver]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    with pytest.raises(jrec.HostCrash):
        getattr(jrec, run)(_jax_session(), odom, ranges, beams, jdir,
                           every=20, die_at_tick=47)
    jfinal, jtail, jstart = getattr(jrec, resume)(
        _jax_session(), odom, ranges, beams, jdir, every=20)
    with pytest.raises(recovery.HostCrash):
        getattr(recovery, run)(make_session(), odom, ranges, beams, tdir,
                               every=20, die_at_tick=47, draws=draws)
    tfinal, ttail, tstart = getattr(recovery, resume)(
        make_session(), odom, ranges, beams, tdir, every=20, draws=draws)
    assert tstart == jstart == 40
    steps = sorted(os.listdir(tdir))
    assert steps == sorted(d for d in os.listdir(jdir)
                           if d.startswith("step_"))
    assert len(steps) == 4
    jtmpl = _jax_session().init_carry(first_odom=jnp.asarray(odom[0]))
    ttmpl = make_session().init_carry(first_odom=odom[0])
    for s in steps:
        jc = jckpt.load_checkpoint(os.path.join(jdir, s), jtmpl)
        tc = ckpt.load_checkpoint(os.path.join(tdir, s), ttmpl)
        assert int(tc.filt.n_active) == int(jc.filt.n_active), s
        assert np.abs(n(tc.filt.x) - n(jc.filt.x)).max() <= 1e-9, s
        assert np.abs(n(tc.filt.P) - n(jc.filt.P)).max() <= 1e-9, s
    assert int(tfinal.filt.n_active) == int(jfinal.filt.n_active) >= 3
    assert np.abs(n(tfinal.filt.x) - n(jfinal.filt.x)).max() <= 1e-9
    assert np.abs(n(tfinal.filt.P) - n(jfinal.filt.P)).max() <= 1e-9
    assert ttail.shape == (40, 3)
    assert np.abs(n(ttail) - n(jtail)).max() <= 1e-9
