"""ekf_slam_tpu_torch's streaming session (io/stream.py) against the port's
own offline run and against ekf_slam_tpu's streaming session, on the CPU.

Pushed one tick at a time through windows of W ticks, the stream must
give the offline ``run``'s outputs bit for bit (the session tick consumes
its carry, so this also shows that no tick's output aliases what a later
tick overwrites).  Against the JAX stream (f64) the port is handed the
JAX session's extractor draws through ``push(..., draws=)``; every
decision is then equal and the pose within 1e-9.  The CUDA path's event
wait is exercised with a stand-in event that is ready only when waited
on, so backpressure must wait.  The heartbeat checkpoints hold the carry
after exactly the ticks of their label, with windows still in flight at
the drain, and a fresh stream restored from one continues the run."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.io.stream import StreamStats as JStats
from ekf_slam_tpu.io.stream import StreamingSlamSession as JStream
from ekf_slam_tpu.session import SlamSession as JSession
from ekf_slam_tpu.sim import world as jw
from ekf_slam_tpu_torch import SlamSession as TSession
from ekf_slam_tpu_torch.io.stream import StreamingSlamSession as TStream
from ekf_slam_tpu_torch.io.stream import StreamStats as TStats
from ekf_slam_tpu_torch.utils import checkpointing as ckpt

from torch_parity_helpers import port, t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


T, B, NH, SEED = 60, 256, 16, 1


@pytest.fixture(scope="module")
def traj():
    """A 60-tick loop in the 8 m × 6 m room, simulated by the JAX package:
    odometry [T,3] and ranges [T,B] as f64 numpy, the beam angles."""
    cfg = jc.SimConfig(n_beams=B, max_range=12.0, range_noise_std=0.01,
                       odom_xy_noise_std=0.0005, odom_theta_noise_std=0.02)
    tr = jw.simulate(jw.rectangle_room(4.0, 3.0),
                     jw.circle_controls(T, 0.05, 3.0), cfg,
                     jax.random.PRNGKey(0))
    return np.array(tr.odom), np.array(tr.ranges), np.array(tr.beam_angles)


def _params(**ekf_kw):
    kw = dict(capacity=16, max_obs=8, ref_compat=False,
              update_mode="batched", dtype=jnp.float64, pht_mode="rows",
              correction="syrk")
    kw.update(ekf_kw)
    ep = jc.EKFParams(**kw)
    rp = jc.RansacParams(line_consensus=20, bearing_window_deg=20.0,
                         sample_points=8, wall_search_timeout=4,
                         table_capacity=32, promote_count=2,
                         ref_compat=False, n_hypotheses=NH,
                         dtype=jnp.float64)
    return ep, rp


def _session(ep, rp, **kw):
    return TSession(ekf_params=port(ep), ransac_params=port(rp), seed=SEED,
                    device="cpu", **kw)


def _push_all(stream, odom, ranges, draws=None):
    got = []
    for i in range(odom.shape[0]):
        kw = {} if draws is None else dict(draws=draws[i])
        got.extend(stream.push(odom[i], ranges[i], **kw))
    got.extend(stream.flush())
    return got


def _leaves(outs, prefix=""):
    """{name: value} of every field of a (nested) StepOutput."""
    out = {}
    for name, v in zip(outs._fields, outs):
        if isinstance(v, tuple):
            out.update(_leaves(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v
    return out


CONFIGS = {
    # the tuned path's shape at small size: rows + SYRK, padded P
    "batched": (dict(), dict()),
    # the carry holds the previous scan: n_beams reaches init_carry
    "fused": (dict(), dict(control_source="fused", icp_iters=5)),
    # recompression every 16 ticks (a host read inside a window)
    "srekf_fast": (dict(update_mode="srekf_fast", pht_mode="dense",
                        correction="gemm", sr_noise_buffer=16), dict()),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stream_matches_offline_run(traj, config):
    """60 ticks pushed one at a time through windows of 8 (60 is not a
    multiple of 8, so the flush runs a remainder window): every field of
    every tick's output bit-equal to the offline run's."""
    odom, ranges, beams = traj
    ekf_kw, sess_kw = CONFIGS[config]
    ep, rp = _params(**ekf_kw)
    _, off = _session(ep, rp, **sess_kw).run(odom, ranges, beams)
    stream = TStream(_session(ep, rp, **sess_kw), n_beams=B,
                     beam_angles=beams, window=8, max_pending=2,
                     first_odom=odom[0])
    got = _push_all(stream, odom, ranges)
    assert len(got) == T and not stream._pending
    want = _leaves(off)
    for i, o in enumerate(got):
        for name, v in _leaves(o).items():
            if v is None:
                assert want[name] is None, name
                continue
            assert isinstance(v, (np.ndarray, np.generic)), name
            np.testing.assert_array_equal(v, want[name][i].numpy(),
                                          err_msg=f"{name} tick {i}")
    assert int(off.n_active[-1]) >= 3           # the walls were mapped
    s = stream.stats.summary()
    assert s["ticks"] == T and s["ticks_per_sec"] > 0
    assert s["latency_p99_ms"] >= s["latency_p50_ms"] >= 0
    assert len(stream.stats.latencies) == T


def jax_draws(seed: int, ticks: int):
    """The (u, s) pairs the JAX session's extractor draws on each tick,
    in its carry's key chain (session.py:320, ransac.py:314-325)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(ticks):
        key, sub = jax.random.split(key)
        k_pick, k_sample = jax.random.split(sub)
        out.append((t(jax.random.uniform(k_pick, (NH, B))),
                    t(jax.random.uniform(k_sample, (NH, B)))))
    return out


def test_stream_matches_jax_stream_f64(traj):
    """20 ticks through both packages' streams at window 8 (windows of 8,
    8 and the flushed 4), f64, the JAX draws handed to the port: on every
    tick n_active, n_obs and the observations' validity and slots equal,
    the pose within 1e-9 (m and degrees)."""
    odom, ranges, beams = traj
    Tj = 20
    ep, rp = _params()
    js = JStream(JSession(ekf_params=ep, ransac_params=rp, seed=SEED),
                 n_beams=B, beam_angles=jnp.asarray(beams), window=8,
                 first_odom=odom[0])
    jgot = _push_all(js, odom[:Tj], ranges[:Tj])
    ts = TStream(_session(ep, rp), n_beams=B, beam_angles=beams, window=8,
                 first_odom=odom[0])
    tgot = _push_all(ts, odom[:Tj], ranges[:Tj], draws=jax_draws(SEED, Tj))
    assert len(jgot) == len(tgot) == Tj
    for f in ("n_active", "n_obs"):
        np.testing.assert_array_equal(
            np.stack([getattr(o, f) for o in tgot]),
            np.stack([np.asarray(getattr(o, f)) for o in jgot]), err_msg=f)
    for f in ("valid", "index"):
        np.testing.assert_array_equal(
            np.stack([getattr(o.obs, f) for o in tgot]),
            np.stack([np.asarray(getattr(o.obs, f)) for o in jgot]),
            err_msg=f)
    tp = np.stack([o.pose for o in tgot])
    jp = np.stack([np.asarray(o.pose) for o in jgot])
    assert np.abs(tp - jp).max() <= 1e-9
    assert int(tgot[-1].n_active) >= 3


class _HeldEvent:
    """Stands in for a CUDA event whose copy has not finished: ``query``
    says not ready until the host has waited on it."""

    def __init__(self, waits):
        self.done, self.waits = False, waits

    def query(self):
        return self.done

    def synchronize(self):
        self.waits.append(1)
        self.done = True


@pytest.mark.parametrize("max_pending", [1, 2, 3])
def test_stream_backpressure_bounds_pending(traj, max_pending):
    """With windows that are never ready until waited on, no window is
    handed back by ``push``; after each push at most ``max_pending``
    windows are in flight, the host waiting once a window beyond that;
    ``flush`` hands back every tick in order."""
    odom, ranges, beams = traj
    ep, rp = _params()
    stream = TStream(_session(ep, rp), n_beams=B, beam_angles=beams,
                     window=4, max_pending=max_pending, first_odom=odom[0])
    waits = []
    real = stream._to_host
    stream._to_host = lambda outs: (real(outs)[0], _HeldEvent(waits))
    Tb = 40
    handed = []
    for i in range(Tb):
        handed.extend(stream.push(odom[i], ranges[i]))
        assert len(stream._pending) <= max_pending
    assert len(waits) == Tb // 4 - max_pending
    assert len(handed) == 4 * len(waits)
    handed.extend(stream.flush())
    assert len(handed) == Tb and not stream._pending
    _, off = _session(ep, rp).run(odom[:Tb], ranges[:Tb], beams)
    np.testing.assert_array_equal(np.stack([o.pose for o in handed]),
                                  off.pose.numpy())
    assert stream.stats.n_ticks == Tb


def test_stream_poll_hands_back_a_ready_window(traj):
    """``poll`` without blocking hands back nothing while the oldest
    window is not ready and its ticks once it is."""
    odom, ranges, beams = traj
    ep, rp = _params()
    stream = TStream(_session(ep, rp), n_beams=B, beam_angles=beams,
                     window=2, max_pending=4, first_odom=odom[0])
    real = stream._to_host
    stream._to_host = lambda outs: (real(outs)[0], _HeldEvent([]))
    for i in range(4):
        assert stream.push(odom[i], ranges[i]) == []
    held = [e for _, e, _ in stream._pending]
    assert len(held) == 2 and stream.poll() == []
    held[0].done = True
    assert len(stream.poll()) == 2 and len(stream._pending) == 1
    assert len(stream.poll(block=True)) == 2 and not stream._pending


def test_stream_rejects_bad_window(traj):
    ep, rp = _params()
    with pytest.raises(ValueError, match="window"):
        TStream(_session(ep, rp), n_beams=B, beam_angles=traj[2], window=0)


def test_stream_heartbeat_checkpoints(traj, tmp_path):
    """``checkpoint_every=2`` at window 8 over 48 ticks: heartbeats at
    ticks 16, 32 and 48 (tests/test_stream.py:71); the newest restores
    into a fresh session's template as the stream's final carry, with
    the session generator's state."""
    odom, ranges, beams = traj
    ep, rp = _params()
    cdir = str(tmp_path / "hb")
    stream = TStream(_session(ep, rp), n_beams=B, beam_angles=beams,
                     window=8, checkpoint_dir=cdir, checkpoint_every=2,
                     first_odom=odom[0])
    _push_all(stream, odom[:48], ranges[:48])
    assert sorted(os.listdir(cdir)) == ["step_00000016", "step_00000032",
                                        "step_00000048"]
    latest = ckpt.latest_step_dir(cdir)
    assert ckpt.step_of(latest) == 48
    fresh = _session(ep, rp)
    restored = ckpt.load_checkpoint(latest, fresh.init_carry(
        first_odom=odom[0]), generator=fresh.generator)
    for a, b in zip(ckpt.carry_leaves(restored),
                    ckpt.carry_leaves(stream.carry)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(fresh.generator.get_state(),
                       stream.session.generator.get_state())
    assert bool(torch.isfinite(restored.filt.P).all())


def _offline_carries(ep, rp, odom, ranges, beams, ticks):
    """The offline run's carry (cloned: the next tick updates P in place)
    and generator state after each tick in ``ticks``."""
    sess = _session(ep, rp)
    carry = sess.init_carry(first_odom=odom[0])
    out = {}
    for i in range(max(ticks)):
        carry, _ = sess.step(carry, odom[i], ranges[i], beams)
        if i + 1 in ticks:
            out[i + 1] = ([v.clone() if isinstance(v, torch.Tensor) else v
                           for v in ckpt.carry_leaves(carry)],
                          sess.generator.get_state())
    return out


@pytest.mark.parametrize("every", [1, 2])
def test_stream_heartbeat_holds_its_labelled_carry(traj, tmp_path, every):
    """With windows that are ready only once waited on and two in flight
    (``max_pending=2``), a window drains when two later windows have been
    dispatched, so the live carry is ahead of the drained ticks.  Every
    heartbeat must hold the carry after exactly the ticks of its label,
    bit for bit, and that tick's generator state (the JAX stream saves the
    live carry under the drained count, stream.py:161-166, and fails
    this).  At ``checkpoint_every=1`` three heartbeats are in flight at
    once, so no buffer may be reused before its file is written."""
    odom, ranges, beams = traj
    ep, rp = _params()
    cdir = str(tmp_path / "hb")
    stream = TStream(_session(ep, rp), n_beams=B, beam_angles=beams,
                     window=8, max_pending=2, checkpoint_dir=cdir,
                     checkpoint_every=every, first_odom=odom[0])
    real = stream._to_host
    stream._to_host = lambda outs: (real(outs)[0], _HeldEvent([]))
    labels = []
    for i in range(40):
        stream.push(odom[i], ranges[i])
        got = sorted(os.listdir(cdir)) if os.path.isdir(cdir) else []
        if got and (not labels or got[-1] != labels[-1]):
            labels.append(got[-1])
            # written when its window drained: the live carry is ahead
            assert stream._ticks > ckpt.step_of(got[-1])
    stream.flush()
    want_ticks = list(range(8 * every, 41, 8 * every))
    assert sorted(os.listdir(cdir)) == [f"step_{k:08d}" for k in want_ticks]
    assert len(stream._free_bufs) <= -(-2 // every) + 1
    want = _offline_carries(ep, rp, odom, ranges, beams, want_ticks)
    tmpl = _session(ep, rp)
    for k in want_ticks:
        got = ckpt.load_checkpoint(os.path.join(cdir, f"step_{k:08d}"),
                                   tmpl.init_carry(first_odom=odom[0]),
                                   generator=tmpl.generator)
        leaves, state = want[k]
        for j, (a, b) in enumerate(zip(ckpt.carry_leaves(got), leaves)):
            assert (a is None and b is None) or torch.equal(a, b), (k, j)
        assert torch.equal(tmpl.generator.get_state(), state), k


def test_stream_restores_from_a_heartbeat(traj, tmp_path):
    """A stream abandoned after 44 ticks (its newest heartbeat on disk is
    tick 32); a fresh stream restores that heartbeat before its first
    push and runs the ticks after it: bit-equal to the offline run's, its
    own heartbeats labelled on from 32 (48, and 60 at the flushed
    remainder); a restore after a push raises."""
    odom, ranges, beams = traj
    ep, rp = _params()
    cdir = str(tmp_path / "hb")
    dead = TStream(_session(ep, rp), n_beams=B, beam_angles=beams,
                   window=8, checkpoint_dir=cdir, checkpoint_every=2,
                   first_odom=odom[0])
    for i in range(44):
        dead.push(odom[i], ranges[i])
    latest = ckpt.latest_step_dir(cdir)
    start = ckpt.step_of(latest)
    assert start == 32
    stream = TStream(_session(ep, rp), n_beams=B, beam_angles=beams,
                     window=8, checkpoint_dir=cdir, checkpoint_every=2,
                     first_odom=odom[0])
    stream.restore(latest)
    got = _push_all(stream, odom[start:], ranges[start:])
    _, off = _session(ep, rp).run(odom, ranges, beams)
    want = _leaves(off)
    assert len(got) == T - start
    for i, o in enumerate(got):
        for name in ("pose", "n_active", "n_obs", "obs.index"):
            np.testing.assert_array_equal(_leaves(o)[name],
                                          want[name][start + i].numpy(),
                                          err_msg=f"{name} tick {start + i}")
    # the fresh stream's windows 2 and 4 (the flushed remainder)
    assert sorted(os.listdir(cdir)) == ["step_00000016", "step_00000032",
                                        "step_00000048", "step_00000060"]
    with pytest.raises(RuntimeError, match="before its first push"):
        stream.restore(latest)


STATS_CASES = {
    "empty": dict(),
    "one": dict(n_ticks=1, t_first_arrival=10.0, t_last_done=10.25,
                latencies=[0.25]),
    "many": dict(n_ticks=7, t_first_arrival=3.5, t_last_done=4.75,
                 latencies=[0.1, 0.031, 0.5, 0.2, 0.0125, 0.9, 0.3]),
    "instant": dict(n_ticks=2, t_first_arrival=1.0, t_last_done=1.0,
                    latencies=[0.0, 0.0]),
}


@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_stream_stats_summary_matches_jax(case):
    """The same latencies and times give the JAX summary exactly."""
    kw = STATS_CASES[case]
    got = TStats(**{k: (list(v) if isinstance(v, list) else v)
                    for k, v in kw.items()}).summary()
    want = JStats(**{k: (list(v) if isinstance(v, list) else v)
                     for k, v in kw.items()}).summary()
    assert got == want
    assert list(got) == list(want)


def test_stream_reset_stats(traj):
    """``reset_stats`` starts the accounting afresh, as after a warm-up."""
    odom, ranges, beams = traj
    ep, rp = _params()
    stream = TStream(_session(ep, rp), n_beams=B, beam_angles=beams,
                     window=4, first_odom=odom[0])
    _push_all(stream, odom[:8], ranges[:8])
    assert stream.stats.n_ticks == 8
    stream.reset_stats()
    assert stream.stats.summary() == JStats().summary()
    _push_all(stream, odom[8:12], ranges[8:12])
    assert stream.stats.n_ticks == 4
