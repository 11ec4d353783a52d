"""ekf_slam_tpu_torch.models.srekf_fast against ekf_slam_tpu.models.srekf_fast
on the CPU at f64: every function of the general-factor filter against
its JAX twin on the same inputs (numpy from a seed, through the JAX test
helpers), the zero-column invariant, the recompression on a factor whose
Gram is singular (the QR branch, in both packages), and the f32 tiny-R
stress.  The port's ``rows_gather='pallas'`` runs the pair-gather
kernel's plain version here; the JAX package gathers with ``take`` at
this mode's unpadded D."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import srekf as js
from ekf_slam_tpu.models import srekf_fast as jf
from ekf_slam_tpu.ops.blocked_chol import chol_for_state
from ekf_slam_tpu.ops.observations import obs_from_rows
from ekf_slam_tpu_torch.models import srekf_fast as tf
from ekf_slam_tpu_torch.ops.observations import obs_from_rows as tobs

from test_batched import measurement_of
from test_ekf_core import make_pair
from test_srekf_fast import BUF, PARAMS, batch_of, general_factor, with_buffer
from torch_parity_helpers import max_rel, n, port, t, torch_state

SR = dataclasses.replace(PARAMS, update_mode="srekf_fast")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _tp(params=SR, **kw):
    return port(dataclasses.replace(params, **kw))


def _batch(jb):
    return tuple(t(a) for a in jb)


def _same(got, want, tol=1e-10):
    """x, S, signatures ≤ tol relative; active and count equal."""
    for f in ("x", "P", "sig"):
        assert max_rel(getattr(got, f), getattr(want, f)) <= tol, f
    np.testing.assert_array_equal(n(got.active), n(want.active))
    assert int(got.n_active) == int(want.n_active)


def test_buffer_geometry():
    state, _ = make_pair(2, seed=1)
    sr = torch_state(with_buffer(state))
    assert tf.buffer_start(sr) == 3 + 2 * PARAMS.capacity
    assert tf.buffer_size(sr) == BUF


@pytest.mark.parametrize("gather", ["take", "pallas"])
def test_hs_rows_and_sqrt_noise_match_jax(gather):
    """H·S from the gathered row pairs and ν, with a masked lane; the
    closed-form factor of the block-diagonal noise."""
    state, _ = make_pair(4, seed=2)
    sr = general_factor(with_buffer(state))
    zs, slots, Rs, _ = batch_of(state, [0, 2, 3])
    valid = jnp.array([True, False, True])
    HS_w, nu_w = jf._hs_rows(sr.P, sr.x, zs, slots, valid, SR, jnp.float64)
    HS_g, nu_g = tf._hs_rows(t(sr.P), t(sr.x), t(zs), t(slots), t(valid),
                             _tp(rows_gather=gather), torch.float64)
    np.testing.assert_allclose(n(HS_g), n(HS_w), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(n(nu_g), n(nu_w), rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(
        n(tf._sqrt_noise_block(t(Rs), t(valid), torch.float64)),
        n(jf._sqrt_noise_block(Rs, valid, jnp.float64)))


@pytest.mark.parametrize("general", [False, True])
def test_update_andrews_matches_jax(general):
    """The closed-form update on a triangular and on a general factor."""
    state, _ = make_pair(4, seed=2)
    b = batch_of(state, [0, 2, 3])
    sr0 = (general_factor(with_buffer(state)) if general
           else js.factor_from_state(with_buffer(state)))
    want = jf.sr_update_andrews(sr0, *b, SR)
    got = tf.sr_update_andrews(torch_state(sr0), *_batch(b), _tp())
    _same(got, want)


def test_update_masked_lanes_match_jax():
    """A masked lane changes nothing, in both packages."""
    state, _ = make_pair(3, seed=4)
    zs, slots, Rs, _ = batch_of(state, [0, 1, 2])
    valid = jnp.array([True, False, True])
    sr0 = general_factor(with_buffer(state))
    want = jf.sr_update_andrews(sr0, zs, slots, Rs, valid, SR)
    got = tf.sr_update_andrews(torch_state(sr0), t(zs), t(slots), t(Rs),
                               t(valid), _tp())
    _same(got, want)
    keep = np.array([0, 2])
    only = tf.sr_update_andrews(torch_state(sr0), t(zs)[keep],
                                t(slots)[keep], t(Rs)[keep],
                                torch.ones(2, dtype=torch.bool), _tp())
    assert max_rel(got.x, only.x) <= 1e-12
    assert max_rel(got.P @ got.P.T, only.P @ only.P.T) <= 1e-11


def test_update_chunked_matches_jax():
    state, _ = make_pair(4, seed=5)
    b = batch_of(state, [0, 1, 2, 3])
    sr0 = general_factor(with_buffer(state))
    want = jf.sr_update_chunked(sr0, *b, dataclasses.replace(
        SR, update_chunks=2))
    got = tf.sr_update_chunked(torch_state(sr0), *_batch(b),
                               _tp(update_chunks=2))
    _same(got, want)
    manual = tf.sr_update_andrews(torch_state(sr0), *(a[:2] for a in
                                                      _batch(b)), _tp())
    manual = tf.sr_update_andrews(manual, *(a[2:] for a in _batch(b)),
                                  _tp())
    assert max_rel(got.P, manual.P) <= 1e-14
    assert max_rel(got.x, manual.x) <= 1e-14


def test_predict_fast_matches_jax():
    """Row axpys plus √c·w in the scheduled column (a host int); the
    other buffer columns stay exactly 0."""
    state, _ = make_pair(3, seed=3)
    u = jnp.array([0.15, 7.0])
    sr0 = js.factor_from_state(with_buffer(state))
    col = state.dim
    want = jf.sr_predict_fast(sr0, u, SR, col)
    got = tf.sr_predict_fast(torch_state(sr0), t(u), _tp(), col)
    _same(got, want, 1e-13)
    S = n(got.P)
    assert np.any(S[:3, col] != 0) and np.all(S[:, col + 1:] == 0)


def test_zero_column_invariant_through_ops():
    """Fresh slot columns and unscheduled buffer columns stay EXACTLY zero
    through predict/update/append in the port, which matches JAX on the
    way."""
    state, _ = make_pair(3, seed=6)
    jsr = js.factor_from_state(with_buffer(state))
    tsr = torch_state(jsr)
    d0, fresh0 = state.dim, 3 + 2 * 3
    u = jnp.array([0.1, 4.0])
    zs, slots, Rs, valid = batch_of(state, [0, 2])
    R = jnp.asarray(np.diag([0.02, 0.4]))
    loc = jnp.array([1.1, -0.8])

    jsr = jf.sr_predict_fast(jsr, u, SR, d0)
    tsr = tf.sr_predict_fast(tsr, t(u), _tp(), d0)
    jsr = jf.sr_update_andrews(jsr, zs, slots, Rs, valid, SR)
    tsr = tf.sr_update_andrews(tsr, t(zs), t(slots), t(Rs), t(valid), _tp())
    S = n(tsr.P)
    assert np.all(S[:, fresh0:d0] == 0) and np.all(S[:, d0 + 1:] == 0)
    jsr = js.sr_append(jsr, u, R, loc, 4.0, SR)
    tsr = tf.sr_append(tsr, t(u), t(R), t(loc), 4.0, _tp())
    jsr = jf.sr_predict_fast(jsr, u, SR, d0 + 1)
    tsr = tf.sr_predict_fast(tsr, t(u), _tp(), d0 + 1)
    S = n(tsr.P)
    assert int(tsr.n_active) == 4
    assert np.all(S[:, fresh0 + 2:d0] == 0) and np.all(S[:, d0 + 2:] == 0)
    _same(tsr, jsr)


def test_append_on_general_factor_matches_jax():
    state, _ = make_pair(2, seed=8)
    u = jnp.array([0.1, 3.0])
    R = jnp.asarray(np.diag([0.02, 0.5]))
    loc = jnp.array([1.5, -0.7])
    sr0 = general_factor(with_buffer(state))
    want = js.sr_append(sr0, u, R, loc, 3.0, SR)
    got = tf.sr_append(torch_state(sr0), t(u), t(R), t(loc), 3.0, _tp())
    _same(got, want, 1e-13)


@pytest.mark.parametrize("assoc", ["signature", "ml_unique_drop", "known"])
def test_measure_fast_matches_jax(assoc):
    """Gate → chunked Andrews → appends: the same associations, posterior
    and appended landmark, under signature, ml_unique with dropped losers
    and known association."""
    kw = dict(signature={},
              ml_unique_drop=dict(association="ml_unique", ml_losers="drop",
                                  noise_model="constant"),
              known=dict(association="known"))[assoc]
    params = dataclasses.replace(SR, **kw)
    rng = np.random.default_rng(0)
    state, _ = make_pair(3, seed=10)
    u = jnp.array([0.05, 2.0])
    z0 = measurement_of(state, 0, noise=0.01, rng=rng)
    z2 = measurement_of(state, 2, noise=0.01, rng=rng)
    idx = 4.0 if assoc == "known" else 9.0
    rows = [z0.tolist(), z2.tolist(), [1.5, 100.0, idx]]  # 2 updates + new
    locs = [[0.0, 0.0], [0.0, 0.0], [-0.3, 1.5]]
    sr0 = general_factor(with_buffer(state))
    want = jf.sr_measure_fast(sr0, obs_from_rows(rows, locs, SR.max_obs,
                                                 jnp.float64), u, params)
    got = tf.sr_measure_fast(torch_state(sr0),
                             tobs(rows, locs, SR.max_obs, torch.float64,
                                  device="cpu"), t(u), port(params))
    _same(got, want)
    assert int(got.n_active) == 4


@pytest.mark.parametrize("general", [False, True])
def test_recompress_matches_jax(general):
    """Gram + blocked Cholesky: the same lower-triangular factor, the
    buffer reclaimed, the covariance kept."""
    state, _ = make_pair(3, seed=11)
    sr = (general_factor(with_buffer(state)) if general
          else js.factor_from_state(with_buffer(state)))
    u = jnp.array([0.1, 4.0])
    for j in range(3):                       # consume three buffer columns
        sr = jf.sr_predict_fast(sr, u, SR, state.dim + j)
    want = jf.sr_recompress(sr)
    got = tf.sr_recompress(torch_state(sr))
    _same(got, want)
    S = n(got.P)
    assert np.array_equal(S, np.tril(S))
    assert np.all(S[:, state.dim:] == 0)
    assert max_rel(got.P @ got.P.T, sr.P @ sr.P.T) <= 1e-10


def test_recompress_singular_gram_takes_the_qr_branch(monkeypatch):
    """A factor with one active row zeroed makes the Gram singular: the
    blocked Cholesky gives NaN, and both packages re-triangularize by QR
    of Sᵀ instead.  The port runs the QR once, after its one host read;
    its result is finite, lower triangular and equal to JAX's.  The
    zeroed row is the last active one, so the QR's R is unique up to the
    signs the branch fixes."""
    state, _ = make_pair(3, seed=12)
    sr = general_factor(with_buffer(state))
    sr = sr._replace(P=sr.P.at[3 + 2 * 3 - 1].set(0.0))
    G = jnp.asarray(sr.P @ sr.P.T)
    assert not np.isfinite(np.diag(np.asarray(
        chol_for_state(G, sr.n_active)))).all()
    want = jf.sr_recompress(sr)
    act = (np.arange(sr.P.shape[0]) < 3 + 2 * int(sr.n_active))[:, None]
    np.testing.assert_allclose(
        n(want.P), n(js._retriangularize(sr.P.T, sr.P.shape[0])) * act,
        rtol=0, atol=0)                      # JAX took its QR branch

    calls = []
    real = tf._retriangularize

    def counted(pre, d):
        calls.append(d)
        return real(pre, d)
    monkeypatch.setattr(tf, "_retriangularize", counted)
    got = tf.sr_recompress(torch_state(sr))
    assert calls == [sr.P.shape[0]]
    S = n(got.P)
    assert np.isfinite(S).all() and np.array_equal(S, np.tril(S))
    np.testing.assert_allclose(S, n(want.P), rtol=1e-10, atol=1e-12)


def test_update_panel_matches_jax_and_is_triangular():
    state, _ = make_pair(4, seed=21)
    b = batch_of(state, [0, 1, 3])
    sr0 = general_factor(with_buffer(state))
    want = jf.sr_update_panel(sr0, *b, SR)
    got = tf.sr_update_panel(torch_state(sr0), *_batch(b), _tp())
    _same(got, want)
    S = n(got.P)
    assert np.array_equal(S, np.tril(S)) and np.all(S[:, state.dim:] == 0)


def _stress(seed, general):
    """The f32 tiny-R stress of tests/test_srekf_fast.py:356: 4 landmarks,
    P scaled by 1e4, R = 1e-6·I, the same 4 observations 40 times."""
    p32 = dataclasses.replace(SR, dtype=jnp.float32)
    state, _ = make_pair(4, seed=seed)
    state = state._replace(x=state.x.astype(jnp.float32),
                           P=(state.P * 1e4).astype(jnp.float32),
                           sig=state.sig.astype(jnp.float32))
    sr = (general_factor(with_buffer(state), seed=14) if general
          else js.factor_from_state(with_buffer(state)))
    zs, slots, _, valid = batch_of(state, [0, 1, 2, 3], nudge=0.0)
    Rs = jnp.tile(jnp.asarray(np.diag([1e-6, 1e-6]), jnp.float32),
                  (4, 1, 1))
    return p32, sr, (zs.astype(jnp.float32), slots, Rs, valid)


@pytest.mark.parametrize("fn", ["sr_update_andrews", "sr_update_panel"])
def test_f32_tiny_r_stress_matches_jax(fn):
    """40 f32 updates with tiny R.  The port keeps S·Sᵀ finite and PSD to
    round-off (−1e-6 of its largest entry) and the panel update keeps the
    factor lower triangular, as JAX's tests require of JAX.  The f32
    answer itself is only as good as the conditioning allows (R ≪ HPHᵀ
    and, in the panel update, a Gram of squared condition number every
    update), so the port is held to the f64 run of the same updates: no
    further from it than twice JAX's f32 distance plus 1e-3 of the
    largest entry.  (On this stress both sit within 2e-4 of it with the
    Andrews update, and within 4% and 6% with the panel update.)"""
    p32, sr, b = _stress(23 if fn == "sr_update_panel" else 13,
                         general=fn == "sr_update_andrews")

    @jax.jit
    def ticks(s):
        return jax.lax.scan(lambda c, _: (getattr(jf, fn)(c, *b, p32), None),
                            s, None, length=40)[0]
    want = ticks(sr)
    got, ref = torch_state(sr), torch_state(sr)
    ref = ref._replace(x=ref.x.double(), P=ref.P.double(),
                       sig=ref.sig.double())
    tb = _batch(b)
    tb64 = tuple(a.double() if a.is_floating_point() else a for a in tb)
    p64 = port(dataclasses.replace(p32, dtype=jnp.float64))
    for _ in range(40):
        got = getattr(tf, fn)(got, *tb, port(p32))
        ref = getattr(tf, fn)(ref, *tb64, p64)
    d = 3 + 2 * 4
    P_t, P_j, P_r = (n(s.P @ s.P.T)[:d, :d] for s in (got, want, ref))
    scale = np.abs(P_r).max()
    assert np.isfinite(P_t).all()
    assert np.linalg.eigvalsh(0.5 * (P_t + P_t.T)).min() >= -1e-6 * scale
    if fn == "sr_update_panel":
        S = n(got.P)
        assert np.array_equal(S, np.tril(S))
    err_t = np.abs(P_t - P_r).max() / scale
    err_j = np.abs(P_j - P_r).max() / scale
    assert err_t <= 2 * err_j + 1e-3

