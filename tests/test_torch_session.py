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
carry, and the modes this slice does not port."""
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

from torch_parity_helpers import find_walls_draws, max_rel, n, port, t


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


@pytest.mark.parametrize("kw,match", [
    (dict(control_source="icp"), "control_source"),
    (dict(maintain_max_trace=1.0), "maintenance"),
    (dict(ekf=dict(update_mode="sequential")), "update_mode"),
    (dict(ekf=dict(update_mode="srekf")), "update_mode"),
    (dict(ekf=dict(guard_max_jump=1.0)), "guard"),
])
def test_modes_of_later_slices_raise(kw, match):
    """ICP/fused control, map maintenance and the fault guard raise,
    naming the mode.  The two update modes this test listed as later
    slices, 'sequential' and 'srekf', are ported: they construct and
    step instead."""
    kw = dict(kw)
    ep = tc.EKFParams(**{"update_mode": "batched", **kw.pop("ekf", {})})
    rp = tc.RansacParams(n_hypotheses=8)
    if match == "update_mode":
        sess = TSession(ekf_params=ep, ransac_params=rp, device="cpu", **kw)
        carry, out = sess.step(sess.init_carry(), torch.zeros(3),
                               torch.full((B,), 2.0),
                               torch.arange(B) * (360.0 / B))
        assert out.pose.shape == (3,) and carry.sr_tick is None
        return
    with pytest.raises(NotImplementedError, match=match):
        TSession(ekf_params=ep, ransac_params=rp, device="cpu", **kw)


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
