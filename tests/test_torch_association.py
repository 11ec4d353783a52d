"""ekf_slam_tpu_torch batched association (gate_batch on the plain and the
fused-gate-kernel branch, batch_costs and the ml_unique exclusion)
against ekf_slam_tpu at float64: equal is_new/slot/loser masks, cost
planes within 1e-10 relative."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.ops import association as jas
from ekf_slam_tpu_torch.ops import association as tas

from torch_parity_helpers import (jax_state, max_rel, n, port, random_state,
                                  torch_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _batch(rng, js, M=8, noise_model="scaled"):
    """M observations: most re-observe active landmarks (two observe the
    same one, so ml_unique has a loser), the rest are new features."""
    x = np.asarray(js.x)
    na = int(js.n_active)
    targets = np.array([0, 1, 1, 2, 3, 5, -1, -1])[:M]
    zs = np.zeros((M, 3))
    for m, k in enumerate(targets):
        if k < 0:
            lm = rng.uniform(-6, 6, 2)
            sig = 100.0 + m
        else:
            lm = x[3 + 2 * k:5 + 2 * k] + rng.normal(0, 0.05, 2)
            sig = float(np.asarray(js.sig)[k])
        d = lm - x[:2]
        zs[m] = [np.hypot(*d),
                 (np.degrees(np.arctan2(d[1], d[0])) - x[2]) % 360.0, sig]
    assert na >= 6
    if noise_model == "fit":
        A = rng.normal(0, 0.05, (M, 2, 2))
        Rs = A @ A.transpose(0, 2, 1) + np.diag([1e-4, 1e-2])
    else:
        Rs = np.stack([np.diag([0.01, 1.0])] * M)
    return zs, Rs


@pytest.mark.parametrize("association", ["signature", "ml", "ml_unique"])
@pytest.mark.parametrize("noise_model", ["scaled", "constant", "fit"])
@pytest.mark.parametrize("return_losers", [False, True])
def test_gate_batch_matches(rng, association, noise_model, return_losers):
    p = jc.EKFParams(capacity=12, dtype=jnp.float64,
                     association=association, noise_model=noise_model,
                     ref_compat=noise_model == "scaled", s_thresh=30.0
                     if association != "signature" else 1e9)
    js = jax_state(random_state(rng, K=12, n_active=8, pad=4))
    zs, Rs = _batch(rng, js, noise_model=noise_model)
    want = jas.gate_batch(js, jnp.asarray(zs), jnp.asarray(Rs), p,
                          return_losers=return_losers)
    got = tas.gate_batch(torch_state(js), torch.from_numpy(zs),
                         torch.from_numpy(Rs), port(p),
                         return_losers=return_losers)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    if association == "ml_unique" and return_losers:
        assert n(got[2]).any()          # the doubled observation lost


@pytest.mark.parametrize("noise_model,ref_compat", [
    ("scaled", True), ("scaled", False), ("fit", False)])
def test_batch_costs_match(rng, noise_model, ref_compat):
    p = jc.EKFParams(capacity=12, dtype=jnp.float64, association="ml",
                     noise_model=noise_model, ref_compat=ref_compat)
    js = jax_state(random_state(rng, K=12, n_active=8))
    zs, Rs = _batch(rng, js, noise_model=noise_model)
    wp, ws = jas.batch_costs(js, jnp.asarray(zs), jnp.asarray(Rs), p)
    gp, gs = tas.batch_costs(torch_state(js), torch.from_numpy(zs),
                             torch.from_numpy(Rs), port(p))
    act = np.asarray(js.active)
    assert max_rel(n(gp)[:, act], n(wp)[:, act]) <= 1e-10
    assert max_rel(gs, ws) <= 1e-10


def test_gate_kernel_branch_raises(rng):
    """Named for the NotImplementedError the use_pallas branch raised
    before the fused gate kernel was ported.  It raises no more: under
    association='ml' it takes the same decisions as the JAX branch, whose
    Pallas kernel runs in interpret mode here."""
    p = jc.EKFParams(capacity=12, dtype=jnp.float64, association="ml",
                     s_thresh=30.0, ref_compat=False)
    js = jax_state(random_state(rng, K=12, n_active=8))
    zs, Rs = _batch(rng, js)
    want = jas.gate_batch(js, jnp.asarray(zs), jnp.asarray(Rs), p,
                          use_pallas=True)
    got = tas.gate_batch(torch_state(js), torch.from_numpy(zs),
                         torch.from_numpy(Rs), port(p), use_pallas=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    assert not n(got[0]).all()                 # some observations gated


@pytest.mark.parametrize("association", ["signature", "ml_unique"])
@pytest.mark.parametrize("noise_model", ["scaled", "fit"])
@pytest.mark.parametrize("return_losers", [False, True])
def test_gate_batch_kernel_branch_matches(rng, association, noise_model,
                                          return_losers):
    """use_pallas=True against the JAX branch: the cost is position +
    signature even under association='signature', R's off-diagonal is
    dropped even under noise_model='fit', and ml_unique's losers are the
    same."""
    p = jc.EKFParams(capacity=12, dtype=jnp.float64,
                     association=association, noise_model=noise_model,
                     ref_compat=False, s_thresh=30.0)
    js = jax_state(random_state(rng, K=12, n_active=8))
    zs, Rs = _batch(rng, js, noise_model=noise_model)
    want = jas.gate_batch(js, jnp.asarray(zs), jnp.asarray(Rs), p,
                          use_pallas=True, return_losers=return_losers)
    got = tas.gate_batch(torch_state(js), torch.from_numpy(zs),
                         torch.from_numpy(Rs), port(p), use_pallas=True,
                         return_losers=return_losers)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    if association == "ml_unique" and return_losers:
        assert n(got[2]).any()          # the doubled observation lost


def test_exclusive_matches(rng):
    K, M = 6, 10
    is_new = rng.random(M) < 0.2
    slot = rng.integers(0, K, M).astype(np.int32)
    cost = rng.choice([0.5, 1.0, 2.0], M)          # ties on purpose
    want = jas._exclusive(jnp.asarray(is_new), jnp.asarray(slot),
                          jnp.asarray(cost), K)
    got = tas._exclusive(torch.from_numpy(is_new), torch.from_numpy(slot),
                         torch.from_numpy(cost), K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
