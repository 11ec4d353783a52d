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
                                  t, torch_state)


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


def _ml(association, noise_model):
    return jc.EKFParams(capacity=12, association=association,
                        noise_model=noise_model, s_cost=1e6,
                        s_thresh=50.0 if association != "signature" else 1e9,
                        ref_compat=noise_model == "scaled",
                        dtype=jnp.float64)


@pytest.mark.parametrize("association", ["signature", "ml", "ml_unique"])
@pytest.mark.parametrize("noise_model", ["scaled", "constant", "fit"])
def test_gate_costs_and_gate_match(rng, association, noise_model):
    """One measurement at a time (the sequential filter's gate): both
    cost vectors within 1e-12 relative of JAX's gate_costs, and gate's
    is_new, slot and masked cost vector equal / within 1e-12, for each of
    a batch's re-observations and new features."""
    p = _ml(association, noise_model)
    js = jax_state(random_state(rng, K=12, n_active=8))
    ts = torch_state(js)
    zs, Rs = _batch(rng, js, noise_model=noise_model)
    seen_new = seen_old = False
    for z, R in zip(zs, Rs):
        wp, ws = jas.gate_costs(js, jnp.asarray(z), jnp.asarray(R), p)
        gp, gs = tas.gate_costs(ts, t(z), t(R), port(p))
        assert max_rel(gp[:8], wp[:8]) <= 1e-12
        assert max_rel(gs, ws) <= 1e-12
        wn, wslot, wcost = jas.gate(js, jnp.asarray(z), jnp.asarray(R), p)
        gn, gslot, gcost = tas.gate(ts, t(z), t(R), port(p))
        assert bool(gn) == bool(wn) and int(gslot) == int(wslot)
        assert gslot.dtype == torch.int32
        np.testing.assert_array_equal(np.isinf(n(gcost)),
                                      np.isinf(n(wcost)))
        fin = np.isfinite(n(wcost))
        assert max_rel(n(gcost)[fin], n(wcost)[fin]) <= 1e-12
        seen_new |= bool(wn)
        seen_old |= not bool(wn)
    assert seen_old and (seen_new or association == "signature")


def test_gate_ties_take_the_first_slot(rng):
    """Two active slots with the same signature give equal signature
    costs: both packages take the lower slot (jnp.argmin and
    torch.argmin return the first minimum)."""
    p = jc.EKFParams(capacity=12, dtype=jnp.float64)          # signature
    arrs = list(random_state(rng, K=12, n_active=8))
    arrs[2] = arrs[2].copy()
    arrs[2][[2, 5]] = 4.0
    js = jax_state(arrs)
    z = np.array([2.0, 40.0, 4.0])
    R = np.diag([0.2, 200.0])
    wn, wslot, _ = jas.gate(js, jnp.asarray(z), jnp.asarray(R), p)
    gn, gslot, gcost = tas.gate(torch_state(js), t(z), t(R), port(p))
    assert not bool(wn) and int(wslot) == 2
    assert not bool(gn) and int(gslot) == 2 and float(gcost[5]) == 0.0


@pytest.mark.parametrize("case", ["no_active_slot", "none_passes"])
def test_gate_all_inf_is_new_at_slot_0(rng, case):
    """No slot passes (no landmark yet, or every cost over s_thresh):
    every masked cost is +inf, is_new is True and the slot is 0 in both
    packages."""
    p = jc.EKFParams(capacity=12, dtype=jnp.float64)
    js = jax_state(random_state(rng, K=12,
                                n_active=0 if case == "no_active_slot" else 8))
    z = np.array([2.0, 40.0, 77.0])           # a signature no slot holds
    R = np.diag([0.2, 200.0])
    wn, wslot, _ = jas.gate(js, jnp.asarray(z), jnp.asarray(R), p)
    gn, gslot, _ = tas.gate(torch_state(js), t(z), t(R), port(p))
    assert bool(wn) and int(wslot) == 0
    assert bool(gn) and int(gslot) == 0


def test_gate_f32_signature_overflow(rng):
    """At f32 the default s_cost = 1e-11 overflows the signature cost of a
    far signature to +inf: the cost is +inf in both packages, it never
    passes s_thresh, and a matching slot still wins."""
    p = jc.EKFParams(capacity=12, dtype=jnp.float32)
    arrs = random_state(rng, K=12, n_active=8, dtype=np.float32)
    js = jax_state(arrs)
    R = np.diag([0.2, 200.0]).astype(np.float32)
    for sig, want_new in ((3e18, True), (3.0, False)):
        z = np.array([2.0, 40.0, sig], np.float32)
        _, ws = jas.gate_costs(js, jnp.asarray(z), jnp.asarray(R), p)
        _, gs = tas.gate_costs(torch_state(js), t(z), t(R), port(p))
        np.testing.assert_array_equal(np.isinf(n(gs)), np.isinf(n(ws)))
        assert np.isinf(n(ws)).any() == want_new
        wn, wslot, _ = jas.gate(js, jnp.asarray(z), jnp.asarray(R), p)
        gn, gslot, _ = tas.gate(torch_state(js), t(z), t(R), port(p))
        assert bool(gn) == bool(wn) == want_new
        assert int(gslot) == int(wslot)
