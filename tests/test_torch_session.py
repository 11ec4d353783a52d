"""The slices as a whole: ekf_slam_tpu_torch's SlamSession against
ekf_slam_tpu's on the CPU.

Both sessions run the batched odometry-driven tick (rows P·Hᵀ + SYRK
correction, batched-hypothesis extractor; and the kernel path: fused
gate, pair gather, gemm correction through cov_update), the
general-factor square-root tick (update_mode='srekf_fast', with its
periodic recompression), the sequential tick of the JAX package's
default session (EKF_SLAM_UC and EKF_SLAM, the one-seed wall search) and
the QR square-root tick (update_mode='srekf'), over the same simulated
sequence.  The JAX session draws its extractor randomness from
threefry; the port is handed exactly those draws (session.py:320 then
ransac.py:314-325), so the two runs take the same decisions tick by
tick.  Also: the simulator's noise-free ray cast, the padded initial
carry, every session option constructing and stepping, and the control
and robustness modes: ICP and fused control (the fused gate's choice
tick by tick), the fault guard (its verdict tick by tick, on the
reference's 0/360 seam glitch) and map maintenance (the evictions tick
by tick), on the batched and the square-root paths.  The JAX session's
decisions are recorded by wrapping its icp, guarded and maintain with
ordered debug callbacks (its StepOutput does not carry them)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.session import SlamSession as JSession
from ekf_slam_tpu.sim import world as jw
from ekf_slam_tpu_torch import SlamSession as TSession
from ekf_slam_tpu_torch import config as tc
from ekf_slam_tpu_torch import convert
from ekf_slam_tpu_torch.sim import world as tw

from torch_parity_helpers import (find_walls_draws, max_rel, n, port,
                                  session_draws, t)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


T, B, NH, SEED = 12, 256, 16, 1


@pytest.fixture(scope="module")
def traj():
    """A 12-tick loop in the 8 m × 6 m room, simulated by the JAX
    package (noise from its own key)."""
    cfg = jc.SimConfig(n_beams=B, max_range=12.0, range_noise_std=0.01,
                       odom_xy_noise_std=0.0005, odom_theta_noise_std=0.02)
    return jw.simulate(jw.rectangle_room(4.0, 3.0),
                       jw.circle_controls(T, 0.05, 3.0), cfg,
                       jax.random.PRNGKey(0))


def jax_draws(seed: int, ticks: int):
    """The (u, s) pairs the JAX session's extractor draws on each tick:
    key, sub = split(key); k_pick, k_sample = split(sub)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(ticks):
        key, sub = jax.random.split(key)
        k_pick, k_sample = jax.random.split(sub)
        out.append((t(jax.random.uniform(k_pick, (NH, B))),
                    t(jax.random.uniform(k_sample, (NH, B)))))
    return out


def _params(dtype, cov_dtype=None, correction="syrk", **ekf_kw):
    ep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode="batched", dtype=dtype, pht_mode="rows",
                      correction=correction, cov_dtype=cov_dtype, **ekf_kw)
    rp = jc.RansacParams(line_consensus=20, bearing_window_deg=20.0,
                         sample_points=8, wall_search_timeout=4,
                         table_capacity=32, promote_count=2,
                         ref_compat=False, n_hypotheses=NH, dtype=dtype)
    return ep, rp


def _run_both(traj, dtype, cov_dtype=None, collect_nis=False, **ekf_kw):
    ep, rp = _params(dtype, cov_dtype, **ekf_kw)
    js = JSession(ekf_params=ep, ransac_params=rp, seed=SEED,
                  collect_nis=collect_nis)
    c0 = js.init_carry(first_odom=traj.odom[0])
    jcarry, jouts = js.run(traj.odom, traj.ranges, traj.beam_angles,
                           carry=c0)
    ts = TSession(ekf_params=port(ep), ransac_params=port(rp), seed=SEED,
                  collect_nis=collect_nis, device="cpu")
    tc0 = convert.carry_from_numpy(jax.tree.map(np.asarray, c0),
                                   device="cpu")
    tcarry, touts = ts.run(np.array(traj.odom), np.array(traj.ranges),
                           t(traj.beam_angles), carry=tc0,
                           draws=jax_draws(SEED, T))
    return (jcarry, jouts), (tcarry, touts)


def _same_decisions(jouts, touts):
    for f in ("n_active", "n_obs"):
        np.testing.assert_array_equal(n(getattr(touts, f)),
                                      n(getattr(jouts, f)), err_msg=f)
    np.testing.assert_array_equal(n(touts.obs.valid), n(jouts.obs.valid))
    np.testing.assert_array_equal(n(touts.obs.index), n(jouts.obs.index))
    assert n(touts.n_active)[-1] >= 3           # the room's walls were mapped


def test_session_parity_f64(traj):
    """f64: per-tick pose ≤ 1e-9, every decision equal, final x and P
    ≤ 1e-9 relative, per-observation NIS ≤ 1e-9 relative."""
    (jc_, jo), (tc_, to) = _run_both(traj, jnp.float64, collect_nis=True)
    _same_decisions(jo, to)
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-9
    assert max_rel(tc_.filt.x, jc_.filt.x) <= 1e-9
    assert max_rel(tc_.filt.P, jc_.filt.P) <= 1e-9
    assert tc_.filt.P.shape == (512, 512)       # syrk pads D = 35 to 512
    nis_t, nis_j = n(to.nis), n(jo.nis)
    np.testing.assert_array_equal(np.isnan(nis_t), np.isnan(nis_j))
    assert np.isfinite(nis_j).any()
    ok = np.isfinite(nis_j)
    assert max_rel(nis_t[ok], nis_j[ok]) <= 1e-9
    for f in ("observe", "index", "fresh", "used"):
        np.testing.assert_array_equal(n(getattr(tc_.table, f)),
                                      n(getattr(jc_.table, f)), err_msg=f)


def test_session_parity_kernel_path_f64(traj):
    """The kernel path (use_pallas, rows_gather='pallas', gemm correction,
    unpadded P) at f64, the kernels' plain versions standing in for them
    on the CPU and the JAX Pallas kernels in interpret mode: per-tick pose
    ≤ 1e-9, every decision equal, final x and P ≤ 1e-9 relative."""
    (jc_, jo), (tc_, to) = _run_both(traj, jnp.float64, correction="gemm",
                                     use_pallas=True, rows_gather="pallas")
    _same_decisions(jo, to)
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-9
    assert max_rel(tc_.filt.x, jc_.filt.x) <= 1e-9
    assert max_rel(tc_.filt.P, jc_.filt.P) <= 1e-9
    assert tc_.filt.P.shape == (35, 35)         # not padded under gemm


def test_session_parity_bf16_storage(traj):
    """bf16 P with f32 compute.  Both packages accumulate the large
    products in f32, but XLA and PyTorch sum in different orders, so an
    f32 result near a bf16 rounding boundary can land on the other
    neighbour: one bf16 ulp (2⁻⁸ relative) in a P entry, which reaches the
    mean through the gain at f32 precision.  Tolerances: P within two bf16
    ulps of |P|max, x and the pose within 1e-4; every decision equal."""
    (jc_, jo), (tc_, to) = _run_both(traj, jnp.float32, jnp.bfloat16)
    assert tc_.filt.P.dtype == torch.bfloat16
    _same_decisions(jo, to)
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-4
    assert max_rel(tc_.filt.x, jc_.filt.x) <= 1e-4
    assert max_rel(tc_.filt.P, jc_.filt.P) <= 2.0 ** -7


def test_session_default_draws_are_seeded():
    """Without explicit draws the port draws from the session's
    torch.Generator: the same seed gives the same run."""
    cfg = tc.SimConfig(n_beams=B, max_range=12.0, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    tr = tw.simulate(tw.rectangle_room(4.0, 3.0, torch.float64, "cpu"),
                     tw.circle_controls(6, 0.05, 3.0, torch.float64, "cpu"),
                     cfg, g)
    ep, rp = (port(p) for p in _params(jnp.float64))
    runs = [TSession(ekf_params=ep, ransac_params=rp, seed=3,
                     device="cpu").run(tr.odom, tr.ranges, tr.beam_angles)
            for _ in range(2)]
    (c1, o1), (c2, o2) = runs
    assert torch.equal(o1.pose, o2.pose) and torch.equal(c1.filt.P, c2.filt.P)
    assert int(o1.n_active[-1]) > 0


def test_init_carry_reseeds_the_generator():
    """Every init_carry restarts the extractor's draws from ``seed``, as
    every JAX carry starts from PRNGKey(seed) (session.py:239): two runs of
    one session without draws, each making its own carry, are bit-equal."""
    cfg = tc.SimConfig(n_beams=B, max_range=12.0, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    tr = tw.simulate(tw.rectangle_room(4.0, 3.0, torch.float64, "cpu"),
                     tw.circle_controls(6, 0.05, 3.0, torch.float64, "cpu"),
                     cfg, g)
    ep, rp = (port(p) for p in _params(jnp.float64))
    s = TSession(ekf_params=ep, ransac_params=rp, seed=3, device="cpu")
    c1, o1 = s.run(tr.odom, tr.ranges, tr.beam_angles)
    c2, o2 = s.run(tr.odom, tr.ranges, tr.beam_angles)
    assert torch.equal(o1.pose, o2.pose) and torch.equal(c1.filt.P, c2.filt.P)
    assert torch.equal(o1.obs.valid, o2.obs.valid)
    assert int(o1.n_active[-1]) > 0


@pytest.mark.parametrize("pose", [(0.0, 0.0, 0.0), (1.3, -0.7, 37.0),
                                  (-2.5, 2.1, 300.0)])
def test_raycast_matches(pose):
    """Noise-free ray cast in the rectangle room, f64: the same hits and
    misses (NaN beyond max_range), ranges within 1e-12."""
    beams = np.arange(B) * (360.0 / B)
    want = jw.raycast(jw.rectangle_room(4.0, 3.0), jnp.asarray(pose),
                      jnp.asarray(beams), 4.5)
    got = tw.raycast(tw.rectangle_room(4.0, 3.0, torch.float64, "cpu"),
                     torch.tensor(pose, dtype=torch.float64),
                     torch.from_numpy(beams), 4.5)
    np.testing.assert_array_equal(np.isnan(n(got)), np.isnan(n(want)))
    assert np.isnan(n(want)).any() and not np.isnan(n(want)).all()
    np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-12)


def test_simulate_noise_free_matches():
    """With every noise std at 0, the two simulators give the same truth,
    odometry and scans (the noise draws differ; they are multiplied by 0)."""
    T6 = 6
    jcfg = jc.SimConfig(n_beams=64, max_range=12.0, range_noise_std=0.0,
                        odom_xy_noise_std=0.0, odom_theta_noise_std=0.0)
    want = jw.simulate(jw.rectangle_room(4.0, 3.0),
                       jw.circle_controls(T6, 0.05, 3.0), jcfg,
                       jax.random.PRNGKey(0))
    got = tw.simulate(tw.rectangle_room(4.0, 3.0, torch.float64, "cpu"),
                      tw.circle_controls(T6, 0.05, 3.0, torch.float64, "cpu"),
                      dataclasses.replace(port(jcfg), dtype=torch.float64),
                      torch.Generator().manual_seed(0))
    for f in ("truth", "odom", "ranges", "beam_angles"):
        np.testing.assert_allclose(n(getattr(got, f)), n(getattr(want, f)),
                                   rtol=0, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("syrk", [True, False])
def test_init_carry_matches(syrk):
    """The initial carry, padded to a multiple of 512 under syrk, equals
    the JAX session's leaf for leaf; init_pose anchors the filter."""
    ep, rp = _params(jnp.float64)
    if not syrk:
        ep = dataclasses.replace(ep, correction="gemm")
    odo, pose0 = np.array([0.2, -0.1, 15.0]), np.array([1.0, 2.0, 30.0])
    jcarry = JSession(ekf_params=ep, ransac_params=rp).init_carry(
        first_odom=odo, init_pose=pose0)
    tcarry = TSession(ekf_params=port(ep), ransac_params=port(rp),
                      device="cpu").init_carry(first_odom=odo,
                                               init_pose=pose0)
    assert tcarry.filt.P.shape[0] == (512 if syrk else ep.dim)
    for part in ("filt", "table"):
        for f in getattr(tcarry, part)._fields:
            np.testing.assert_array_equal(
                n(getattr(getattr(tcarry, part), f)),
                n(getattr(getattr(jcarry, part), f)), err_msg=f)
    np.testing.assert_array_equal(n(tcarry.old_odom), n(jcarry.old_odom))


@pytest.mark.parametrize("kw,mode", [
    (dict(control_source="icp"), "icp"),
    (dict(maintain_max_trace=1.0), "maintenance"),
    (dict(ekf=dict(update_mode="sequential")), "update_mode"),
    (dict(ekf=dict(update_mode="srekf")), "update_mode"),
    (dict(ekf=dict(guard_max_jump=1.0)), "guard"),
])
def test_modes_construct_and_step(kw, mode):
    """Every mode that once raised NotImplementedError now constructs and
    steps: ICP control (the carry then holds the previous scan and
    control, and init_carry needs n_beams), map maintenance, the fault
    guard, and the 'sequential' and 'srekf' update modes."""
    kw = dict(kw)
    ep = tc.EKFParams(**{"update_mode": "batched", **kw.pop("ekf", {})})
    rp = tc.RansacParams(n_hypotheses=8)
    sess = TSession(ekf_params=ep, ransac_params=rp, device="cpu", **kw)
    if mode == "icp":
        with pytest.raises(ValueError, match="n_beams"):
            sess.init_carry()
        carry0 = sess.init_carry(n_beams=B)
        assert carry0.prev_pts.shape == (B, 2) and not carry0.prev_valid.any()
    else:
        carry0 = sess.init_carry()
        assert carry0.prev_pts is None and carry0.prev_u is None
    carry, out = sess.step(carry0, torch.zeros(3), torch.full((B,), 2.0),
                           torch.arange(B) * (360.0 / B))
    assert out.pose.shape == (3,) and carry.sr_tick is None
    assert (out.guard_ok is not None) == (mode == "guard")
    assert (out.n_evicted is not None) == (mode == "maintenance")
    if mode == "icp":
        assert carry.prev_valid.all() and torch.equal(out.u, carry.prev_u)
        assert torch.equal(out.u, torch.zeros(2))      # empty previous scan


T_SR = 60


@pytest.fixture(scope="module")
def traj_sr():
    """A 60-tick loop in the same room (the square-root session's run)."""
    cfg = jc.SimConfig(n_beams=B, max_range=12.0, range_noise_std=0.01,
                       odom_xy_noise_std=0.0005, odom_theta_noise_std=0.02)
    return jw.simulate(jw.rectangle_room(4.0, 3.0),
                       jw.circle_controls(T_SR, 0.05, 3.0), cfg,
                       jax.random.PRNGKey(0))


def _sr_params(rows_gather="take", buffer=8):
    ep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode="srekf_fast", sr_noise_buffer=buffer,
                      rows_gather=rows_gather, dtype=jnp.float64)
    return ep, _params(jnp.float64)[1]


@pytest.mark.parametrize("rows_gather", ["take", "pallas"])
def test_session_parity_srekf_fast_f64(traj_sr, rows_gather):
    """update_mode='srekf_fast' at f64 for 60 ticks with an 8-column noise
    buffer, so 7 recompressions run: per-tick pose ≤ 1e-9, every decision
    equal, final x and factor S ≤ 1e-9 relative, NIS ≤ 1e-9 relative, and
    the same tick count, carried as a host int.  With 'pallas' the port
    gathers S's row pairs through the pair-gather kernel's plain version;
    the JAX package gathers them with take at this unpadded D (it warns),
    so the values are the same."""
    ep, rp = _sr_params(rows_gather)
    js = JSession(ekf_params=ep, ransac_params=rp, seed=SEED,
                  collect_nis=True)
    c0 = js.init_carry(first_odom=traj_sr.odom[0])
    jcarry, jo = js.run(traj_sr.odom, traj_sr.ranges, traj_sr.beam_angles,
                        carry=c0)
    ts = TSession(ekf_params=port(ep), ransac_params=port(rp), seed=SEED,
                  collect_nis=True, device="cpu")
    tcarry, to = ts.run(np.array(traj_sr.odom), np.array(traj_sr.ranges),
                        t(traj_sr.beam_angles),
                        carry=convert.carry_from_numpy(
                            jax.tree.map(np.asarray, c0), device="cpu"),
                        draws=jax_draws(SEED, T_SR))
    _same_decisions(jo, to)
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-9
    assert max_rel(tcarry.filt.x, jcarry.filt.x) <= 1e-9
    assert max_rel(tcarry.filt.P, jcarry.filt.P) <= 1e-9
    assert tcarry.sr_tick == int(jcarry.sr_tick) == T_SR
    assert isinstance(tcarry.sr_tick, int)
    assert tcarry.filt.P.shape == (3 + 2 * 16 + 8,) * 2     # not padded
    nis_t, nis_j = n(to.nis), n(jo.nis)
    np.testing.assert_array_equal(np.isnan(nis_t), np.isnan(nis_j))
    ok = np.isfinite(nis_j)
    assert ok.any() and max_rel(nis_t[ok], nis_j[ok]) <= 1e-9


def test_session_srekf_fast_recompresses_on_schedule(traj_sr, monkeypatch):
    """The recompression runs on ticks 8, 16, ... (the host counter's
    (sr_tick + 1) % sr_noise_buffer == 0) and leaves the factor lower
    triangular with the buffer columns exactly 0; the noise column of
    each predict walks through the buffer."""
    from ekf_slam_tpu_torch import session as tsess
    ep, rp = (port(p) for p in _sr_params(buffer=4))
    seen, cols = [], []
    real_rc, real_pf = tsess.sr_recompress, tsess.sr_predict_fast

    def rc(filt):
        seen.append(len(cols))
        return real_rc(filt)

    def pf(filt, u, params, col):
        cols.append(col)
        return real_pf(filt, u, params, col)
    monkeypatch.setattr(tsess, "sr_recompress", rc)
    monkeypatch.setattr(tsess, "sr_predict_fast", pf)
    ts = TSession(ekf_params=ep, ransac_params=rp, seed=SEED, device="cpu")
    carry = ts.init_carry(first_odom=np.array(traj_sr.odom[0]))
    draws = jax_draws(SEED, 12)
    for k in range(12):
        carry, _ = ts.step(carry, np.array(traj_sr.odom[k]),
                           np.array(traj_sr.ranges[k]),
                           t(traj_sr.beam_angles), draws=draws[k])
    assert seen == [4, 8, 12]
    assert cols == [ep.dim + k % 4 for k in range(12)]
    S = n(carry.filt.P)
    assert np.array_equal(S, np.tril(S)) and np.all(S[:, ep.dim:] == 0)


def test_init_carry_srekf_fast_matches():
    """The square-root initial carry: the factor of the padded initial P
    (D = 3 + 2K + sr_noise_buffer), sr_tick 0, the same as JAX's."""
    ep, rp = _sr_params()
    odo = np.array([0.2, -0.1, 15.0])
    jcarry = JSession(ekf_params=ep, ransac_params=rp).init_carry(
        first_odom=odo)
    tcarry = TSession(ekf_params=port(ep), ransac_params=port(rp),
                      device="cpu").init_carry(first_odom=odo)
    assert tcarry.filt.P.shape == (ep.dim + 8,) * 2
    assert tcarry.sr_tick == int(jcarry.sr_tick) == 0
    for f in tcarry.filt._fields:
        np.testing.assert_allclose(n(getattr(tcarry.filt, f)),
                                   n(getattr(jcarry.filt, f)), rtol=1e-15,
                                   atol=0, err_msg=f)


def jax_seq_draws(seed: int, ticks: int, rounds: int):
    """The (u, s) pairs [rounds, B] the JAX session's one-seed wall search
    draws on each tick: key, sub = split(key), then round r's k_pick,
    k_sample = split(split(sub, rounds)[r]) (session.py:320,
    ransac.py:244-262)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(ticks):
        key, sub = jax.random.split(key)
        out.append(find_walls_draws(sub, rounds, B))
    return out


def _seq_rp():
    """The extractor of the sequential sessions: _params' settings with
    the one-seed wall search (n_hypotheses 0, the default)."""
    return dataclasses.replace(_params(jnp.float64)[1], n_hypotheses=0)


def _run_pair(traj, algorithm, ep, rp, draws, collect_nis=True):
    js = JSession(algorithm=algorithm, ekf_params=ep, ransac_params=rp,
                  seed=SEED, collect_nis=collect_nis)
    c0 = js.init_carry(first_odom=traj.odom[0])
    jcarry, jouts = js.run(traj.odom, traj.ranges, traj.beam_angles,
                           carry=c0)
    ts = TSession(algorithm=algorithm, ekf_params=port(ep),
                  ransac_params=port(rp), seed=SEED,
                  collect_nis=collect_nis, device="cpu")
    tc0 = convert.carry_from_numpy(jax.tree.map(np.asarray, c0),
                                   device="cpu")
    tcarry, touts = ts.run(np.array(traj.odom), np.array(traj.ranges),
                           t(traj.beam_angles), carry=tc0, draws=draws)
    return (jcarry, jouts), (tcarry, touts)


@pytest.mark.parametrize("algorithm", ["EKF_SLAM_UC", "EKF_SLAM"])
def test_session_parity_sequential_f64(traj, algorithm):
    """The JAX package's default session, update_mode='sequential' with
    the algorithm's preset as constructed (capacity 128, max_obs 16,
    ref_compat=True: the signature gate for EKF_SLAM_UC, known
    association with the loop-counter slots for EKF_SLAM) at f64, and the
    one-seed wall search: per-tick pose ≤ 1e-9, every decision equal,
    final x and P ≤ 1e-9 relative, NIS ≤ 1e-9 relative."""
    from ekf_slam_tpu.session import ALGORITHMS as JALG
    ep = JALG[algorithm](dtype=jnp.float64)
    assert (ep.update_mode, ep.capacity, ep.ref_compat) == (
        "sequential", 128, True)
    rp = _seq_rp()
    (jc_, jo), (tc_, to) = _run_pair(
        traj, algorithm, ep, rp,
        jax_seq_draws(SEED, T, rp.wall_search_timeout))
    _same_decisions(jo, to)
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-9
    assert max_rel(tc_.filt.x, jc_.filt.x) <= 1e-9
    assert max_rel(tc_.filt.P, jc_.filt.P) <= 1e-9
    assert tc_.filt.P.shape == (ep.dim, ep.dim)          # not padded
    nis_t, nis_j = n(to.nis), n(jo.nis)
    np.testing.assert_array_equal(np.isnan(nis_t), np.isnan(nis_j))
    ok = np.isfinite(nis_j)
    if ok.any():
        assert max_rel(nis_t[ok], nis_j[ok]) <= 1e-9


def test_session_parity_srekf_f64(traj):
    """update_mode='srekf', the QR square-root session (the batched
    extractor), at f64: per-tick pose ≤ 1e-9, every decision equal, final
    x and factor L (after the sign fix) ≤ 1e-9 relative, NIS from the
    triangular strips ≤ 1e-9 relative; L lower triangular, diag ≥ 0,
    inactive rows exactly 0."""
    ep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode="srekf", dtype=jnp.float64)
    rp = _params(jnp.float64)[1]
    (jc_, jo), (tc_, to) = _run_pair(traj, "EKF_SLAM_UC", ep, rp,
                                     jax_draws(SEED, T))
    _same_decisions(jo, to)
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-9
    assert max_rel(tc_.filt.x, jc_.filt.x) <= 1e-9
    assert max_rel(tc_.filt.P, jc_.filt.P) <= 1e-9
    L = n(tc_.filt.P)
    assert L.shape == (ep.dim, ep.dim)
    assert np.array_equal(L, np.tril(L)) and (np.diag(L) >= 0).all()
    assert np.all(L[3 + 2 * int(tc_.filt.n_active):] == 0)
    nis_t, nis_j = n(to.nis), n(jo.nis)
    np.testing.assert_array_equal(np.isnan(nis_t), np.isnan(nis_j))
    ok = np.isfinite(nis_j)
    assert ok.any() and max_rel(nis_t[ok], nis_j[ok]) <= 1e-9


def test_default_session_runs():
    """SlamSession(device='cpu') with no other argument (EKF_SLAM_UC, f32,
    capacity 128, the sequential filter, RansacParams() with the one-seed
    search) runs a sequence without raising: finite state, the unpadded
    f32 P."""
    sess = TSession(device="cpu")
    assert sess.ekf_params.update_mode == "sequential"
    assert sess.ransac_params.n_hypotheses == 0
    cfg = tc.SimConfig(n_beams=B, max_range=12.0)
    tr = tw.simulate(tw.rectangle_room(4.0, 3.0, device="cpu"),
                     tw.circle_controls(4, 0.05, 3.0, device="cpu"), cfg,
                     torch.Generator().manual_seed(0))
    carry, outs = sess.run(tr.odom, tr.ranges, tr.beam_angles)
    assert outs.pose.shape == (4, 3)
    assert carry.filt.P.shape == (259, 259)
    assert carry.filt.P.dtype == torch.float32
    assert bool(torch.isfinite(carry.filt.P).all())


@pytest.mark.parametrize("mode", ["sequential", "srekf"])
def test_carry_from_numpy_new_modes(traj, mode):
    """convert.carry_from_numpy takes a JAX carry of the sequential and
    the QR square-root session after three ticks (the factor in the P
    field under 'srekf'): every leaf equal, no tick counter, and the
    port's next tick from it equals JAX's next tick (pose ≤ 1e-9)."""
    ep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode=mode, dtype=jnp.float64)
    rp = _seq_rp() if mode == "sequential" else _params(jnp.float64)[1]
    js = JSession(ekf_params=ep, ransac_params=rp, seed=SEED)
    jcarry, _ = js.run(traj.odom[:4], traj.ranges[:4], traj.beam_angles,
                       carry=js.init_carry(first_odom=traj.odom[0]))
    tcarry = convert.carry_from_numpy(jax.tree.map(np.asarray, jcarry),
                                      device="cpu")
    assert tcarry.sr_tick is None
    assert int(tcarry.filt.n_active) > 0
    for part in ("filt", "table"):
        for f in getattr(tcarry, part)._fields:
            np.testing.assert_array_equal(
                n(getattr(getattr(tcarry, part), f)),
                n(getattr(getattr(jcarry, part), f)), err_msg=f)
    if mode == "srekf":
        L = n(tcarry.filt.P)
        assert np.array_equal(L, np.tril(L))
    draws = (jax_seq_draws(SEED, 5, rp.wall_search_timeout)
             if mode == "sequential" else jax_draws(SEED, 5))[4]
    jnext, jo = js.step(jcarry, traj.odom[4], traj.ranges[4],
                        traj.beam_angles)
    ts = TSession(ekf_params=port(ep), ransac_params=port(rp), seed=SEED,
                  device="cpu")
    tnext, to = ts.step(tcarry, np.array(traj.odom[4]),
                        np.array(traj.ranges[4]), t(traj.beam_angles),
                        draws=draws)
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-9
    assert int(tnext.filt.n_active) == int(jnext.filt.n_active)


def test_init_carry_srekf_matches():
    """The QR square-root initial carry: the Cholesky factor of the
    unpadded initial P, the same as JAX's, and no tick counter."""
    ep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode="srekf", dtype=jnp.float64)
    rp = _params(jnp.float64)[1]
    odo = np.array([0.2, -0.1, 15.0])
    jcarry = JSession(ekf_params=ep, ransac_params=rp).init_carry(
        first_odom=odo)
    tcarry = TSession(ekf_params=port(ep), ransac_params=port(rp),
                      device="cpu").init_carry(first_odom=odo)
    assert tcarry.filt.P.shape == (ep.dim, ep.dim)
    assert tcarry.sr_tick is None and jcarry.sr_tick is None
    for f in tcarry.filt._fields:
        np.testing.assert_allclose(n(getattr(tcarry.filt, f)),
                                   n(getattr(jcarry.filt, f)), rtol=1e-15,
                                   atol=0, err_msg=f)


# -- control and robustness: ICP/fused control, the guard, maintenance -----

def _record_jax(monkeypatch):
    """Wrap the JAX session's icp, guarded and maintain (imported inside
    its step at trace time) so that each tick's ICP quality figures, the
    guard's verdict and the eviction count are recorded, in tick order,
    by ordered debug callbacks."""
    import ekf_slam_tpu.models.maintenance as jm
    import ekf_slam_tpu.ops.icp as jicp
    import ekf_slam_tpu.utils.faults as jf
    rec = {"icp": [], "guard": [], "evicted": []}
    real = (jicp.icp, jf.guarded, jm.maintain)

    def icp(*a, **k):
        r = real[0](*a, **k)
        jax.debug.callback(
            lambda ni, rm: rec["icp"].append((int(ni), float(rm))),
            r.n_inliers, r.rmse, ordered=True)
        return r

    def guarded(*a, **k):
        out, v = real[1](*a, **k)
        jax.debug.callback(lambda ok: rec["guard"].append(bool(ok)), v.ok,
                           ordered=True)
        return out, v

    def maintain(*a, **k):
        out, cnt = real[2](*a, **k)
        jax.debug.callback(lambda c: rec["evicted"].append(int(c)), cnt,
                           ordered=True)
        return out, cnt
    monkeypatch.setattr(jicp, "icp", icp)
    monkeypatch.setattr(jf, "guarded", guarded)
    monkeypatch.setattr(jm, "maintain", maintain)
    return rec


def _run_recorded(monkeypatch, traj, ranges, ep, rp, init_pose=None,
                  **skw):
    """The JAX session (decisions recorded) and the port's, from the same
    initial carry (anchored at ``init_pose``, if given) with the JAX
    draws, over ``ranges``."""
    rec = _record_jax(monkeypatch)
    ranges = np.asarray(ranges)
    Tn, nb = ranges.shape
    icp_on = skw.get("control_source", "odometry") != "odometry"
    js = JSession(ekf_params=ep, ransac_params=rp, seed=SEED, **skw)
    c0 = js.init_carry(first_odom=traj.odom[0],
                       n_beams=nb if icp_on else None, init_pose=init_pose)
    jcarry, jo = js.run(traj.odom, jnp.asarray(ranges), traj.beam_angles,
                        carry=c0)
    jax.effects_barrier()
    ts = TSession(ekf_params=port(ep), ransac_params=port(rp), seed=SEED,
                  device="cpu", **skw)
    tc0 = convert.carry_from_numpy(jax.tree.map(np.asarray, c0),
                                   device="cpu")
    tcarry, to = ts.run(np.array(traj.odom), ranges, t(traj.beam_angles),
                        carry=tc0, draws=session_draws(rp, SEED, Tn, nb))
    return (jcarry, jo, rec), (tcarry, to)


T_CTL = 30


@pytest.fixture(scope="module")
def traj_ctl():
    """A 30-tick loop in the room (the control and robustness runs)."""
    cfg = jc.SimConfig(n_beams=B, max_range=12.0, range_noise_std=0.01,
                       odom_xy_noise_std=0.0005, odom_theta_noise_std=0.02)
    return jw.simulate(jw.rectangle_room(4.0, 3.0),
                       jw.circle_controls(T_CTL, 0.05, 3.0), cfg,
                       jax.random.PRNGKey(0))


def _assert_tracks(jo, to, tol=1e-9):
    np.testing.assert_array_equal(n(to.n_active), n(jo.n_active))
    np.testing.assert_array_equal(n(to.n_obs), n(jo.n_obs))
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= tol
    assert np.abs(n(to.u) - n(jo.u)).max() <= tol


@pytest.mark.parametrize("signed", [True, False])
def test_session_parity_icp_f64(traj_ctl, monkeypatch, signed):
    """control_source='icp' (batched, f64, 15 iterations, pairing radius
    0.5 m): the odometry is ignored, the first tick's u is 0, and the
    per-tick u and pose equal JAX's (≤ 1e-9), with every decision equal
    and the same ICP inlier count a tick; the carried previous scan and
    control equal JAX's."""
    ep, rp = _params(jnp.float64)
    (jc_, jo, rec), (tc_, to) = _run_recorded(
        monkeypatch, traj_ctl, traj_ctl.ranges, ep, rp,
        control_source="icp", icp_iters=15, icp_max_pair_dist=0.5,
        icp_signed=signed)
    _assert_tracks(jo, to)
    assert not n(to.u)[0].any()
    assert n(to.n_active)[-1] >= 3
    assert len(rec["icp"]) == T_CTL and rec["icp"][0][0] == 0
    assert min(ni for ni, _ in rec["icp"][1:]) > 30
    assert to.icp_ok is None
    np.testing.assert_array_equal(n(tc_.prev_valid), n(jc_.prev_valid))
    assert np.abs(n(tc_.prev_pts) - n(jc_.prev_pts)).max() <= 1e-12
    assert np.abs(n(tc_.prev_u) - n(jc_.prev_u)).max() <= 1e-9


@pytest.mark.parametrize("mode", ["batched", "srekf_fast"])
def test_session_parity_fused_f64(traj_ctl, monkeypatch, mode):
    """control_source='fused' with scans blanked mid-run (tests/
    test_icp.py:142-170): the per-tick choice, ICP or odometry, equals
    the one JAX's gates make from its own ICP figures, ticks of both
    kinds occur (the first tick, the blanked ticks and the tick after
    them take the odometry), and pose and u equal JAX's (≤ 1e-9)."""
    if mode == "batched":
        ep, rp = _params(jnp.float64)
    else:
        ep, rp = _sr_params(buffer=8)
    ranges = np.asarray(traj_ctl.ranges).copy()
    ranges[12:17] = np.nan                  # sensor dropout: ICP must lose
    (jc_, jo, rec), (tc_, to) = _run_recorded(
        monkeypatch, traj_ctl, ranges, ep, rp, control_source="fused",
        icp_iters=15, icp_max_pair_dist=0.5, icp_min_inliers=30,
        icp_max_rmse=0.25)
    _assert_tracks(jo, to)
    jax_ok = np.array([ni >= 30 and rm <= 0.25 for ni, rm in rec["icp"]])
    got = n(to.icp_ok)
    np.testing.assert_array_equal(got, jax_ok)
    assert got.any() and not got.all()
    assert not got[0] and not got[12:18].any()
    odom = np.asarray(traj_ctl.odom)
    dd = np.hypot(np.diff(odom[:, 0]), np.diff(odom[:, 1]))
    np.testing.assert_allclose(n(to.u)[13:17, 0], dd[12:16], rtol=1e-12)


@pytest.mark.parametrize("max_jump", [1.0, 0.005])
def test_session_parity_guard_seam_f64(monkeypatch, max_jump):
    """The guard on the seam run of tests/test_faults.py:59-72: the
    ref-compat sequential session (capacity 16, one-seed search) over 150
    ticks of 720 beams, with JAX's guard_max_jump of 1 m and with a tight
    5 mm.  The port, given JAX's draws, takes JAX's verdict on every tick,
    tracks JAX's pose within 1e-9 and stays on track (ATE < 1 m).  At 1 m
    JAX's guard rejects no tick, so the run is the unguarded one: the
    seam glitch its test names no longer throws the pose in this JAX
    package.  At 5 mm the guard rejects the ticks whose correction moves
    the pose further (7 of 150), on both sides alike."""
    from test_sim_session import SIM_RANSAC, make_traj
    traj, _ = make_traj(T=150)
    ep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=True,
                      guard_max_jump=max_jump, dtype=jnp.float64)
    (jc_, jo, rec), (tc_, to) = _run_recorded(
        monkeypatch, traj, traj.ranges, ep, SIM_RANSAC)
    jax_ok = np.array(rec["guard"])
    got = n(to.guard_ok)
    assert len(jax_ok) == 150
    rejected = np.flatnonzero(~got)
    np.testing.assert_array_equal(got, jax_ok,
                                  err_msg=f"port rejects {rejected}")
    assert len(rejected) == (7 if max_jump < 1 else 0)
    _assert_tracks(jo, to)
    truth = np.asarray(traj.truth)
    ate = np.sqrt(np.mean(np.sum((n(to.pose)[:, :2] - truth[:, :2]) ** 2,
                                 -1)))
    assert ate < 1.0


@pytest.mark.parametrize("mode", ["batched", "srekf_fast"])
def test_guarded_session_leaves_rejected_ticks_bit_for_bit(traj_ctl,
                                                            monkeypatch,
                                                            mode):
    """A session whose guard is tight (0.2 mm), so that some ticks are
    rejected: on each rejected tick the filter's x and P (or S) after the
    tick are, bit for bit, what the measurement was handed (copied by a
    spy before it could write in place); accepted ticks leave what the
    measurement made."""
    from ekf_slam_tpu_torch import session as tsess
    if mode == "batched":
        ep, rp = (port(p) for p in _params(jnp.float64))
        name = "measure_batched"
    else:
        ep, rp = (port(p) for p in _sr_params(buffer=64))
        name = "sr_measure_fast"
    ep = dataclasses.replace(ep, guard_max_jump=2e-4)
    real = getattr(tsess, name)
    seen = {}

    def spy(filt, obs, u, params):
        seen["in"] = (filt.x.clone(), filt.P.clone())
        out = real(filt, obs, u, params)
        seen["out"] = (out.x.clone(), out.P.clone())
        return out
    monkeypatch.setattr(tsess, name, spy)
    ts = TSession(ekf_params=ep, ransac_params=rp, seed=SEED, device="cpu")
    draws = session_draws(_params(jnp.float64)[1], SEED, T_CTL, B)
    carry = ts.init_carry(first_odom=np.array(traj_ctl.odom[0]))
    verdicts = []
    for k in range(T_CTL):
        carry, out = ts.step(carry, np.array(traj_ctl.odom[k]),
                             np.array(traj_ctl.ranges[k]),
                             t(traj_ctl.beam_angles), draws=draws[k])
        ok = bool(out.guard_ok)
        verdicts.append(ok)
        x, P = seen["out"] if ok else seen["in"]
        assert torch.equal(carry.filt.x.view(torch.int64), x.view(torch.int64))
        assert torch.equal(carry.filt.P.view(torch.int64), P.view(torch.int64))
    assert any(verdicts) and not all(verdicts)


@pytest.mark.parametrize("mode", ["batched", "srekf_fast"])
def test_session_parity_maintenance_f64(traj_ctl, monkeypatch, mode):
    """Map maintenance on the batched and the square-root (srekf_fast,
    8-column buffer, so recompressions as well) sessions at f64, with a
    merge radius and a trace cap that evict: the evictions each tick
    equal JAX's (some ticks evict), n_active equal every tick, pose ≤
    1e-9; the final state within 1e-9 of JAX's."""
    if mode == "batched":
        ep, rp = _params(jnp.float64)
    else:
        ep, rp = _sr_params(buffer=8)
    (jc_, jo, rec), (tc_, to) = _run_recorded(
        monkeypatch, traj_ctl, traj_ctl.ranges, ep, rp,
        maintain_merge_radius=3.0, maintain_max_trace=0.02)
    got = n(to.n_evicted)
    np.testing.assert_array_equal(got, np.array(rec["evicted"]))
    assert got.sum() > 0 and (got > 0).sum() < T_CTL
    _assert_tracks(jo, to)
    assert max_rel(tc_.filt.x, jc_.filt.x) <= 1e-9
    assert max_rel(tc_.filt.P, jc_.filt.P) <= 1e-9


T_CAMP = 50


def test_session_parity_campaign_f64(monkeypatch):
    """The large-world campaign's session with every feature at once, as
    chip_smoke.py's phase 10 runs it at 10k landmarks, here at capacity
    128 and f64: checks.campaign_params (ML gate, the fitted R, the
    guard at 0.5 m, NH = 192 with refits and splits, 'nearest' matching,
    'sig' write-back) with tuned_params, fused control with the
    campaign's ICP gates and maintenance at 0.4 m (checks.
    CAMPAIGN_SESSION), over the first 50 ticks of checks.campaign_route
    (3 × 3 rooms, 1024 beams, heading noise 0.5°), the sim run by JAX,
    with scans 20-22 blanked and the odometry moved 0.6 m at tick 21, so
    that ticks 20-23 fall back to the odometry and the mapped duplicates
    are merged.  The port, given JAX's draws, makes JAX's choice of
    control, the guard's verdict (every tick accepted) and the evictions
    on every tick, and its pose and u stay within 1e-9 of JAX's."""
    import os
    import runpy
    from ekf_slam_tpu.utils.schedule import tuned_params as jtuned
    from ekf_slam_tpu_torch.checks import (CAMPAIGN_SESSION, campaign_params,
                                           campaign_route)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ex = runpy.run_path(os.path.join(root, "examples", "large_world_slam.py"))
    ep, rp = ex["campaign_params"](128, jnp.float64, "fused", 0.5)
    ep = jtuned(ep, batch=ep.max_obs)
    assert (port(ep), port(rp)) == campaign_params(128, torch.float64,
                                                   "fused", 0.5)
    world, ctrl, start = campaign_route(3, T_CAMP)
    cfg = jc.SimConfig(n_beams=1024, max_range=10.0, range_noise_std=0.01,
                       odom_xy_noise_std=0.004, odom_theta_noise_std=0.5,
                       dtype=jnp.float64)
    traj = jw.simulate(jw.World(jnp.asarray(n(world.segments))),
                       jnp.asarray(ctrl), cfg, jax.random.PRNGKey(0),
                       start_pose=tuple(start))
    ranges = np.array(traj.ranges)
    ranges[20:23] = np.nan              # dropout: ticks 20-23 use odometry
    odom = np.array(traj.odom)
    odom[21:, 0] += 0.6              # a 0.6 m odometry jump at tick 21
    traj = traj._replace(odom=jnp.asarray(odom))
    (jc_, jo, rec), (tc_, to) = _run_recorded(
        monkeypatch, traj, ranges, ep, rp, init_pose=start,
        control_source="fused", **CAMPAIGN_SESSION)
    jax_ok = np.array([ni >= 200 and rm <= 0.08 for ni, rm in rec["icp"]])
    np.testing.assert_array_equal(n(to.icp_ok), jax_ok)
    np.testing.assert_array_equal(n(to.guard_ok), np.array(rec["guard"]))
    np.testing.assert_array_equal(n(to.n_evicted), np.array(rec["evicted"]))
    _assert_tracks(jo, to)
    np.testing.assert_array_equal(np.flatnonzero(~jax_ok), [0, 20, 21, 22, 23])
    assert n(to.n_evicted).sum() > 0
    assert n(to.n_active)[-1] >= 3


def test_carry_from_numpy_icp_carry(traj_ctl):
    """convert.carry_from_numpy takes a fused JAX carry after four ticks:
    the previous scan, its mask and the previous control arrive with
    every other leaf equal, and the port's next tick from it equals
    JAX's (pose and u ≤ 1e-9)."""
    ep, rp = _params(jnp.float64)
    kw = dict(control_source="fused", icp_iters=15, icp_max_pair_dist=0.5)
    js = JSession(ekf_params=ep, ransac_params=rp, seed=SEED, **kw)
    jcarry, _ = js.run(traj_ctl.odom[:4], traj_ctl.ranges[:4],
                       traj_ctl.beam_angles,
                       carry=js.init_carry(first_odom=traj_ctl.odom[0],
                                           n_beams=B))
    tcarry = convert.carry_from_numpy(jax.tree.map(np.asarray, jcarry),
                                      device="cpu")
    for f in ("prev_pts", "prev_valid", "prev_u", "old_odom"):
        np.testing.assert_array_equal(n(getattr(tcarry, f)),
                                      n(getattr(jcarry, f)), err_msg=f)
    assert tcarry.prev_valid.dtype == torch.bool
    for part in ("filt", "table"):
        for f in getattr(tcarry, part)._fields:
            np.testing.assert_array_equal(
                n(getattr(getattr(tcarry, part), f)),
                n(getattr(getattr(jcarry, part), f)), err_msg=f)
    jnext, jo = js.step(jcarry, traj_ctl.odom[4], traj_ctl.ranges[4],
                        traj_ctl.beam_angles)
    ts = TSession(ekf_params=port(ep), ransac_params=port(rp), seed=SEED,
                  device="cpu", **kw)
    tnext, to = ts.step(tcarry, np.array(traj_ctl.odom[4]),
                        np.array(traj_ctl.ranges[4]),
                        t(traj_ctl.beam_angles),
                        draws=session_draws(rp, SEED, 5, B)[4])
    assert np.abs(n(to.pose) - n(jo.pose)).max() <= 1e-9
    assert np.abs(n(to.u) - n(jo.u)).max() <= 1e-9
