"""ekf_slam_tpu_torch.ops.blocked_chol against ekf_slam_tpu.ops.blocked_chol
on the CPU at f64: the blocked Cholesky, the blocked triangular inverse
and the filter-state Cholesky, at sizes the block does not divide, and
the NaN a failed factorization gives in both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops import blocked_chol as jb
from ekf_slam_tpu_torch.ops import blocked_chol as tb

from torch_parity_helpers import n


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _spd(d, seed):
    """A symmetric positive-definite matrix (tests/test_blocked_chol.py)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(d, 16 + d // 4)) / np.sqrt(d)
    return 0.05 * np.eye(d) + A @ A.T


@pytest.mark.parametrize("d,block", [(64, 512), (200, 64), (513, 128),
                                     (1100, 512), (1500, 1024)])
def test_chol_blocked_matches_jax(d, block):
    """Same panels, same math: the factors agree within 1e-10 (the
    products sum in other orders), the strict upper triangle is exactly
    0, and the input is not changed."""
    A = _spd(d, seed=d)
    At = torch.from_numpy(A.copy())
    got = tb.chol_blocked(At, block=block)
    want = jb.chol_blocked(jnp.asarray(A), block=block)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)
    assert float(torch.triu(got, 1).abs().max()) == 0.0
    assert torch.equal(At, torch.from_numpy(A))


@pytest.mark.parametrize("d,block", [(64, 512), (300, 64), (1100, 512)])
def test_tri_inv_blocked_matches_jax(d, block):
    L = np.linalg.cholesky(_spd(d, seed=d + 1))
    got = tb.tri_inv_blocked(torch.from_numpy(L), block=block)
    want = jb.tri_inv_blocked(jnp.asarray(L), block=block)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(n(got) @ L, np.eye(d), atol=1e-9)
    assert float(torch.triu(got, 1).abs().max()) == 0.0


@pytest.mark.parametrize("d,n_act,block", [(131, 20, 32), (1100, 400, 512)])
def test_chol_for_state_matches_jax(d, n_act, block):
    """Active leading block, exact zeros beyond: the inactive rows of the
    factor are exactly 0 in both packages; n_active may be a tensor."""
    end = 3 + 2 * n_act
    A = np.zeros((d, d))
    A[:end, :end] = _spd(end, seed=9)
    na = torch.tensor(n_act, dtype=torch.int32)
    got = tb.chol_for_state(torch.from_numpy(A), na, block=block)
    want = jb.chol_for_state(jnp.asarray(A), jnp.asarray(n_act, jnp.int32),
                             block=block)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-10, atol=1e-10)
    assert float(got[end:].abs().max()) == 0.0
    np.testing.assert_allclose(n(got @ got.T), A, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("d,block", [(40, 512), (700, 256)])
def test_failed_cholesky_gives_nan_like_jax(d, block):
    """A matrix that is not positive definite: no exception, NaN on the
    diagonal from the failing panel on, in both packages."""
    A = _spd(d, seed=3)
    A[d // 2, d // 2] = -1.0
    got = n(tb.chol_blocked(torch.from_numpy(A), block=block))
    want = n(jb.chol_blocked(jnp.asarray(A), block=block))
    assert np.isnan(np.diag(got)).any() and np.isnan(np.diag(want)).any()
    assert np.array_equal(np.isfinite(np.diag(got)[:block]),
                          np.isfinite(np.diag(want)[:block]))
    assert not np.isfinite(np.diag(got)).all()


def test_chol_nan_matches_jnp_cholesky():
    """The panel factor: the symmetrized input's factor where it exists,
    NaN below the diagonal and 0 above it where it does not."""
    good = _spd(12, seed=4)
    bad = np.array([[1.0, 2.0], [0.0, 1.0]])      # (A+Aᵀ)/2 is singular
    for A in (good, bad, -np.eye(3)):
        got = n(tb.chol_nan(torch.from_numpy(A)))
        want = n(jnp.linalg.cholesky(jnp.asarray(A)))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                                   rtol=1e-12, atol=1e-14)
