"""ekf_slam_tpu_torch.models.srekf against ekf_slam_tpu.models.srekf on
the CPU at f64: the pieces of the square-root filter that the
general-factor session runs (dense ↔ factor conversion, QR
re-triangularization, the O(D) append, the gate strips) and the
observation-batch constructors the square-root tests use.  The QR filter
itself is a later slice, and its functions raise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import EKFParams
from ekf_slam_tpu.models import srekf as js
from ekf_slam_tpu.ops import observations as jo
from ekf_slam_tpu_torch.models import srekf as ts
from ekf_slam_tpu_torch.ops import observations as to

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


@pytest.mark.parametrize("fn", ["sr_predict", "sr_update_batch",
                                "sr_measure_batched"])
def test_qr_filter_is_a_later_slice(fn):
    """The QR square-root filter (update_mode='srekf') raises, naming it."""
    with pytest.raises(NotImplementedError, match="update_mode='srekf'"):
        getattr(ts, fn)(*([None] * {"sr_predict": 3, "sr_update_batch": 6,
                                     "sr_measure_batched": 4}[fn]))
