"""ekf_slam_tpu_torch.models.srekf against ekf_slam_tpu.models.srekf on
the CPU at f64: the dense ↔ factor conversion, QR re-triangularization,
the O(D) append, the gate strips, the observation-batch constructors the
square-root tests use, and the QR filter (sr_predict, sr_update_batch,
sr_measure_batched) on tests/test_srekf.py's cases: the factor after the
sign fix and the mean against JAX's, and L·Lᵀ against the dense filter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import batched as jb
from ekf_slam_tpu.models import ekf as je
from ekf_slam_tpu.models import srekf as js
from ekf_slam_tpu.ops import observations as jo
from ekf_slam_tpu_torch.models import srekf as ts
from ekf_slam_tpu_torch.ops import observations as to

from test_batched import measurement_of
from test_ekf_core import make_pair
from test_srekf_fast import general_factor, with_buffer
from torch_parity_helpers import max_rel, n, port, t, torch_state

PARAMS = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                   dtype=jnp.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _same_state(got, want, tol=1e-10):
    for f in ("x", "P", "sig"):
        assert max_rel(getattr(got, f), getattr(want, f)) <= tol, f
    np.testing.assert_array_equal(n(got.active), n(want.active))
    assert int(got.n_active) == int(want.n_active)


@pytest.mark.parametrize("n_lm,buffer", [(0, 0), (3, 0), (3, 6)])
def test_factor_from_state_and_back(n_lm, buffer):
    """The factor of a padded dense state: lower triangular, inactive rows
    exactly 0, the same as JAX's; and back to the dense P."""
    state, _ = make_pair(n_lm, seed=1)
    if buffer:
        state = with_buffer(state, buffer)
    want = js.factor_from_state(state)
    got = ts.factor_from_state(torch_state(state))
    _same_state(got, want, 1e-12)
    L = n(got.P)
    assert np.array_equal(L, np.tril(L))
    assert np.all(L[3 + 2 * n_lm:] == 0)
    back = ts.state_to_dense(got)
    assert max_rel(back.P, js.state_to_dense(want).P) <= 1e-12
    assert max_rel(back.P, state.P) <= 1e-12


def test_retriangularize_and_sign_fix(rng):
    """R of a QR of a tall pre-array, sign-fixed to diag(L) ≥ 0: the same
    canonical factor in both packages, and L·Lᵀ = preᵀ·pre."""
    pre = rng.normal(0, 1, (15, 9))
    got = ts._retriangularize(torch.from_numpy(pre), 9)
    want = js._retriangularize(jnp.asarray(pre), 9)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-12, atol=1e-12)
    assert (np.diag(n(got)) >= 0).all()
    np.testing.assert_allclose(n(got @ got.T), pre.T @ pre, rtol=1e-10,
                               atol=1e-12)
    L = np.tril(rng.normal(0, 1, (6, 6)))
    np.testing.assert_array_equal(n(ts._sign_fix(torch.from_numpy(L))),
                                  n(js._sign_fix(jnp.asarray(L))))


@pytest.mark.parametrize("sym", [[[0.3, 0.1], [0.1, 0.2]],
                                 [[0.0, 0.0], [0.0, 0.0]],
                                 [[1e-3, 1e-3], [1e-3, 1e-3]]])
def test_chol2_matches_jax(sym):
    """Closed-form 2×2 factor, including the guarded degenerate cases."""
    got = ts._chol2(torch.tensor(sym, dtype=torch.float64))
    want = js._chol2(jnp.asarray(sym, jnp.float64))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-14, atol=0)


@pytest.mark.parametrize("general", [False, True])
def test_sr_append_matches_jax(general):
    """Append on a triangular and on a general (orthogonally mixed) factor:
    the same factor rows, diagonal block, mean, signature and count."""
    state, _ = make_pair(2, seed=3)
    sr = (general_factor(with_buffer(state)) if general
          else js.factor_from_state(state))
    u = jnp.array([0.1, 3.0])
    R = jnp.asarray(np.diag([0.02, 0.5]))
    loc = jnp.array([1.5, -0.7])
    want = js.sr_append(sr, u, R, loc, 3.0, PARAMS)
    got = ts.sr_append(torch_state(sr), t(u), t(R), t(loc), 3.0,
                       port(PARAMS))
    _same_state(got, want, 1e-12)
    assert int(got.n_active) == 3


@pytest.mark.parametrize("case", ["full", "masked"])
def test_sr_append_no_op_when_full_or_masked(case):
    """A full state, or a False mask, leaves the factor as it was."""
    state, _ = make_pair(2, seed=5)
    sr = torch_state(js.factor_from_state(state))
    mask = None
    if case == "full":
        sr = sr._replace(n_active=torch.tensor(PARAMS.capacity,
                                               dtype=torch.int32))
    else:
        mask = torch.tensor(False)
    before = [v.clone() for v in sr]
    got = ts.sr_append(sr, torch.tensor([0.1, 3.0], dtype=torch.float64),
                       torch.eye(2, dtype=torch.float64) * 0.1,
                       torch.tensor([1.0, 1.0], dtype=torch.float64), 9.0,
                       port(PARAMS), mask=mask)
    for a, b in zip(got, before):
        assert torch.equal(a, b)


@pytest.mark.parametrize("triangular", [True, False])
def test_sr_strips_match_jax(triangular):
    """Gate strips from a triangular factor and from a general one."""
    state, _ = make_pair(4, seed=9)
    S = (js.factor_from_state(state).P if triangular
         else general_factor(with_buffer(state)).P)
    got = ts.sr_strips(t(S), PARAMS.capacity, triangular=triangular)
    want = js.sr_strips(S, PARAMS.capacity, triangular=triangular)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(n(g), n(w), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("rows,locs", [
    ([[1.5, 100.0, 9.0], [2.0, 30.0, 2.0]], [[-0.3, 1.5], [0.5, 0.5]]),
    ([[1.0, 10.0, 1.0]] * 6, [[0.0, 0.0]] * 6),      # more rows than slots
    (np.zeros((0, 3)), np.zeros((0, 2)))])
def test_obs_from_rows_matches_jax(rows, locs):
    got = to.obs_from_rows(rows, locs, 4, torch.float64, device="cpu")
    want = jo.obs_from_rows(rows, locs, 4, jnp.float64)
    for f in ("rng", "bearing", "index", "loc", "valid"):
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      n(getattr(want, f)), err_msg=f)
    assert got.index.dtype == torch.int32 and got.valid.dtype == torch.bool
    e = to.empty_obs(4, torch.float32, device="cpu")
    assert not bool(e.valid.any()) and e.rng.dtype == torch.float32


def _update_case(seed=5, n_lm=4, n_obs=3, noise=0.02):
    """tests/test_srekf.py's joint-update case: noisy re-observations of
    slots 0..n_obs−1 with the value-scaled R."""
    state, _ = make_pair(n_lm, seed=seed)
    rng = np.random.default_rng(7)
    zs = np.stack([measurement_of(state, k, noise=noise, rng=rng)
                   for k in range(n_obs)])
    Rs = np.stack([np.diag([abs(z[0]) * 0.1, abs(z[1]) * 5.0]) for z in zs])
    return state, zs, Rs, np.arange(n_obs), np.ones(n_obs, bool)


def _check_factor(got, want, dense=None, tol=1e-10):
    """The port's factor state against JAX's (L after the sign fix, x,
    counts) within ``tol`` relative, L lower triangular with diag ≥ 0 and
    inactive rows exactly 0; and L·Lᵀ, x against a dense state."""
    _same_state(got, want, tol)
    L = n(got.P)
    assert np.array_equal(L, np.tril(L)) and (np.diag(L) >= 0).all()
    assert np.all(L[3 + 2 * int(got.n_active):] == 0)
    if dense is not None:
        np.testing.assert_allclose(L @ L.T, n(dense.P), rtol=1e-8,
                                   atol=1e-10)
        np.testing.assert_allclose(n(got.x), n(dense.x), rtol=1e-8,
                                   atol=1e-10)


@pytest.mark.parametrize("fn", ["sr_predict", "sr_update_batch",
                                "sr_measure_batched"])
def test_qr_filter_is_a_later_slice(fn):
    """Named for the NotImplementedError each QR-filter function raised
    before this filter was ported.  Each now runs, on a state with three
    landmarks, and equals JAX's within 1e-10 relative (factor after the
    sign fix, mean, counts)."""
    state, zs, Rs, slots, valid = _update_case(seed=2, n_lm=3)
    sr = js.factor_from_state(state)
    u = np.array([0.15, 7.0])
    if fn == "sr_predict":
        want = js.sr_predict(sr, jnp.asarray(u), PARAMS)
        got = ts.sr_predict(torch_state(sr), t(u), port(PARAMS))
    elif fn == "sr_update_batch":
        args = (zs, slots, Rs, valid)
        want = js.sr_update_batch(sr, *map(jnp.asarray, args), PARAMS)
        got = ts.sr_update_batch(torch_state(sr), *map(t, args),
                                 port(PARAMS))
    else:
        obs = jo.obs_from_rows(zs, np.zeros((3, 2)), PARAMS.max_obs,
                               jnp.float64)
        want = js.sr_measure_batched(sr, obs, jnp.asarray(u), PARAMS)
        got = ts.sr_measure_batched(torch_state(sr),
                                    to.ObsBatch(*(None if v is None else t(v)
                                                  for v in obs)),
                                    t(u), port(PARAMS))
    _check_factor(got, want)


@pytest.mark.parametrize("ref_compat", [False, True])
@pytest.mark.parametrize("n_lm", [0, 3])
def test_sr_predict_matches(n_lm, ref_compat):
    """The QR prediction of the (D+1)×D pre-array: the factor and mean
    equal JAX's within 1e-10 relative, and L·Lᵀ equals the dense
    predict's P (tests/test_srekf.py:40-51)."""
    p = EKFParams(capacity=8, max_obs=4, ref_compat=ref_compat,
                  dtype=jnp.float64)
    state, _ = make_pair(n_lm, seed=2)
    u = jnp.array([0.15, 7.0])
    sr = js.factor_from_state(state)
    want = js.sr_predict(sr, u, p)
    got = ts.sr_predict(torch_state(sr), t(u), port(p))
    _check_factor(got, want, dense=je.predict(state, u, p))


def test_sr_update_batch_matches():
    """The (2M+D)² QR update of three noisy re-observations: the new
    factor after the sign fix and the mean equal JAX's within 1e-10, and
    L·Lᵀ and x equal the dense joint update's (tests/test_srekf.py:
    76-93)."""
    state, zs, Rs, slots, valid = _update_case()
    args = tuple(map(jnp.asarray, (zs, slots, Rs, valid)))
    want = js.sr_update_batch(js.factor_from_state(state), *args, PARAMS)
    got = ts.sr_update_batch(torch_state(js.factor_from_state(state)),
                             *map(t, (zs, slots, Rs, valid)), port(PARAMS))
    _check_factor(got, want,
                  dense=jb.update_batch(state, *args, PARAMS))
    assert max_rel(got.x, state.x) > 1e-6          # the update moved x


def test_sr_update_masked_rows_are_noops():
    """A masked row (zero H columns, zero ν, identity noise block) does
    not move the result: the update with a padded invalid row equals the
    update of the valid row alone within 1e-10 (tests/test_srekf.py:
    96-115), and both equal JAX's."""
    state, _ = make_pair(3, seed=6)
    z = measurement_of(state, 1)
    z[0] += 0.04
    R = np.diag([z[0] * 0.1, z[1] * 5.0])
    zpad, Rpad = np.array([3.3, 77.0, 2.0]), np.eye(2)
    sr0 = js.factor_from_state(state)
    cases = (((z[None], [1], R[None], [True])),
             ((np.stack([z, zpad]), [1, 0], np.stack([R, Rpad]),
               [True, False])))
    outs = []
    for zz, sl, RR, vv in cases:
        args = (np.asarray(zz), np.asarray(sl), np.asarray(RR),
                np.asarray(vv))
        want = js.sr_update_batch(sr0, *map(jnp.asarray, args), PARAMS)
        got = ts.sr_update_batch(torch_state(sr0), *map(t, args),
                                 port(PARAMS))
        _check_factor(got, want)
        outs.append(got)
    assert max_rel(outs[1].x, outs[0].x) <= 1e-10
    assert max_rel(outs[1].P, outs[0].P) <= 1e-10


@pytest.mark.parametrize("association", ["signature", "ml", "known"])
def test_sr_measure_batched_matches(association):
    """The full QR tick: the gate from the factor's strips, one joint QR
    update of two re-observations, one append (tests/test_srekf.py:
    134-151; ML with the constant R, under which the third row gates as
    new): equal to JAX's within 1e-10 and L·Lᵀ, x equal to the dense
    batched tick's."""
    p = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                  association=association, dtype=jnp.float64,
                  **({"s_cost": 1e6, "s_thresh": 60.0,
                      "noise_model": "constant"}
                     if association == "ml" else {}))
    state, _ = make_pair(3, seed=11)
    u = jnp.array([0.05, 2.0])
    rng = np.random.default_rng(3)
    rows = [measurement_of(state, 0, noise=0.01, rng=rng).tolist(),
            measurement_of(state, 2, noise=0.01, rng=rng).tolist(),
            [1.5, 100.0, 9.0]]                       # 2 updates + 1 new
    locs = [[0.0, 0.0], [0.0, 0.0], [-0.3, 1.5]]
    obs = jo.obs_from_rows(rows, locs, p.max_obs, jnp.float64)
    sr = js.factor_from_state(state)
    want = js.sr_measure_batched(sr, obs, u, p)
    got = ts.sr_measure_batched(
        torch_state(sr), to.ObsBatch(*(None if v is None else t(v)
                                       for v in obs)), t(u), port(p))
    assert int(got.n_active) == int(want.n_active) == 4
    _check_factor(got, want, dense=jb.measure_batched(state, obs, u, p))


def test_sr_measure_batched_ignores_ml_losers_drop():
    """A JAX quirk the port keeps: sr_measure_batched takes no losers from
    its gate (srekf.py:265), so under ml_unique with ml_losers='drop' an
    observation that loses its slot is still appended as a new landmark,
    where the dense measure_batched drops it.  Two observations of slot 1:
    the QR tick maps one more landmark than the dense tick, in both
    packages, and the port equals JAX within 1e-10."""
    p = EKFParams(capacity=8, max_obs=4, ref_compat=False,
                  association="ml_unique", ml_losers="drop", s_cost=1e6,
                  s_thresh=60.0, dtype=jnp.float64)
    state, _ = make_pair(3, seed=11)
    u = jnp.array([0.05, 2.0])
    rng = np.random.default_rng(4)
    rows = [measurement_of(state, 1, noise=0.01, rng=rng).tolist(),
            measurement_of(state, 1, noise=0.01, rng=rng).tolist()]
    obs = jo.obs_from_rows(rows, [[0.0, 0.0]] * 2, p.max_obs, jnp.float64)
    sr = js.factor_from_state(state)
    want = js.sr_measure_batched(sr, obs, u, p)
    got = ts.sr_measure_batched(
        torch_state(sr), to.ObsBatch(*(None if v is None else t(v)
                                       for v in obs)), t(u), port(p))
    dense = jb.measure_batched(state, obs, u, p)
    assert int(dense.n_active) == 3
    assert int(got.n_active) == int(want.n_active) == 4
    _check_factor(got, want)
