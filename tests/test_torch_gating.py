"""The fused gate's plain version (ekf_slam_tpu_torch/ops/gating.py)
against the JAX package's Pallas gate kernel run in interpret mode, at
float64: the [M,K] costs within 1e-10 relative, +inf in exactly the
inactive slots; the strips read from the state equal; the wrapper's CPU
behaviour and input checks.  The CUDA kernel has no interpret mode:
chip_smoke.py and tests/test_torch_cuda.py hold it to this plain version
on the GPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops.pallas import gating as jg
from ekf_slam_tpu_torch.ops import gating as tg

from torch_parity_helpers import jax_state, n, random_state, torch_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _case(rng, M, K=12, n_active=8):
    """A state with ``n_active`` of K slots filled and M measurements:
    most re-observe an active landmark with noise and its signature, the
    rest are new features.  Returns (JAX state, zs [M,3], rdiag [M,2])."""
    js = jax_state(random_state(rng, K=K, n_active=n_active))
    x, sig = np.asarray(js.x), np.asarray(js.sig)
    targets = rng.integers(0, n_active, M)
    new = rng.random(M) < 0.25
    lm = x[3:3 + 2 * K].reshape(K, 2)[targets] + rng.normal(0, 0.05, (M, 2))
    lm[new] = rng.uniform(-6, 6, (int(new.sum()), 2))
    d = lm - x[:2]
    zs = np.stack([np.hypot(d[:, 0], d[:, 1]),
                   (np.degrees(np.arctan2(d[:, 1], d[:, 0])) - x[2]) % 360.0,
                   np.where(new, 100.0 + np.arange(M), sig[targets])], -1)
    rdiag = np.stack([zs[:, 0] * 0.01, rng.uniform(0.5, 5.0, M)], -1)
    return js, zs, rdiag


def _both(js, zs, rdiag, s_cost, wrap):
    lm, sig, act, prr, prl, pll = jg.strips_from_state(js)
    want = jg.gate_costs_pallas(js.x[:3], prr, jnp.asarray(zs),
                                jnp.asarray(rdiag), lm, sig, act, prl, pll,
                                s_cost, wrap_innovation=wrap, interpret=True)
    lm, sig, act, prr, prl, pll = tg.strips_from_state(torch_state(js))
    got = tg.gate_costs_ref(torch_state(js).x[:3], prr, torch.from_numpy(zs),
                            torch.from_numpy(rdiag), lm, sig, act, prl, pll,
                            s_cost, wrap)
    return n(got), n(want), np.asarray(js.active)


@pytest.mark.parametrize("M,wrap,s_cost", [(4, True, 1e6), (8, False, 1e6),
                                           (8, True, 1e-11),
                                           (300, True, 1e6)])
def test_gate_costs_ref_matches_pallas_f64(rng, M, wrap, s_cost):
    """M = 300 spans two of the TPU kernel's measurement tiles."""
    js, zs, rdiag = _case(rng, M)
    got, want, act = _both(js, zs, rdiag, s_cost, wrap)
    assert got.shape == want.shape == (M, 12)
    assert np.isinf(got[:, ~act]).all() and np.isinf(want[:, ~act]).all()
    assert np.isfinite(got[:, act]).all()
    np.testing.assert_allclose(got[:, act], want[:, act], rtol=1e-10,
                               atol=0)


def test_gate_costs_ref_wraps_at_the_seam():
    """The kernel's wrap n1 − floor((n1+180)/360)·360 (gating.py:130, not
    the fmod-based wrap_to_180) sends bearing innovations of +180, −180
    and 540 all to −180, so they cost the same; unwrapped, 540 costs
    more."""
    pose = torch.tensor([0.0, 0.0, 0.0], dtype=torch.float64)
    lm = torch.tensor([[1.0, 0.0]], dtype=torch.float64)    # bearing 0
    prr = torch.eye(3, dtype=torch.float64) * 0.01
    prl = torch.zeros((1, 6), dtype=torch.float64)
    pll = torch.tensor([[0.01, 0.0, 0.0, 0.01]], dtype=torch.float64)
    zs = torch.tensor([[1.0, 180.0, 1.0], [1.0, -180.0, 1.0],
                       [1.0, 540.0, 1.0]], dtype=torch.float64)
    rdiag = torch.ones((3, 2), dtype=torch.float64)
    sig = torch.ones(1, dtype=torch.float64)
    act = torch.ones(1, dtype=torch.bool)
    c = tg.gate_costs_ref(pose, prr, zs, rdiag, lm, sig, act, prl, pll,
                          1.0, True)[:, 0]
    assert torch.equal(c, c[:1].expand(3))
    unwrapped = tg.gate_costs_ref(pose, prr, zs, rdiag, lm, sig, act, prl,
                                  pll, 1.0, False)[:, 0]
    assert unwrapped[2] > unwrapped[0]                    # 540 stays 540


def test_strips_from_state_match(rng):
    js = jax_state(random_state(rng, K=12, n_active=8, pad=4))
    want = jg.strips_from_state(js)
    got = tg.strips_from_state(torch_state(js))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
        assert g.is_contiguous()


def test_gate_costs_wrapper_runs_plain_version_on_cpu(rng):
    js, zs, rdiag = _case(rng, 6)
    lm, sig, act, prr, prl, pll = tg.strips_from_state(torch_state(js))
    args = (torch_state(js).x[:3], prr, torch.from_numpy(zs),
            torch.from_numpy(rdiag), lm, sig, act, prl, pll, 1e6)
    before = tg.gate_costs.launches
    got = tg.gate_costs(*args)
    assert tg.gate_costs.launches == before        # no kernel on the CPU
    assert torch.equal(got, tg.gate_costs_ref(*args))


@pytest.mark.parametrize("bad", ["zs_shape", "prl_shape", "active_dtype",
                                 "devices"])
def test_gate_costs_wrapper_rejects_bad_inputs(bad):
    K, M = 5, 3
    args = dict(pose=torch.zeros(3), prr=torch.eye(3), zs=torch.zeros((M, 3)),
                rdiag=torch.ones((M, 2)), lm=torch.ones((K, 2)),
                sig=torch.zeros(K), active=torch.ones(K, dtype=torch.bool),
                prl=torch.zeros((K, 6)), pll=torch.ones((K, 4)))
    if bad == "zs_shape":
        args["zs"] = torch.zeros((M, 2))
    elif bad == "prl_shape":
        args["prl"] = torch.zeros((K, 3, 2))
    elif bad == "active_dtype":
        args["active"] = torch.ones(K)
    else:
        args["sig"] = args["sig"].to("meta")
    with pytest.raises(ValueError):
        tg.gate_costs(**args, s_cost=1.0)
