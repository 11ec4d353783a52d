"""The fused gate's plain versions (ekf_slam_tpu_torch/ops/gating.py)
against the JAX package's Pallas gate kernel run in interpret mode: the
strip-taking ``gate_costs_ref`` and the state-taking entry
``gate_costs_state`` (strips, R diagonal and bearing read from the state),
at float64 within 1e-10 relative and at float32 within the bearing
tolerance of ``checks.gate_tolerance``, +inf in exactly the inactive
slots, padded P included; the decisions of ``gate_batch(use_pallas=True)``;
the strips read from the state; the tolerance argument itself; the
wrapper's CPU behaviour and input checks.  The CUDA kernel has no
interpret mode: chip_smoke.py and tests/test_torch_cuda.py hold it to
this plain version on the GPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.ops import association as jas
from ekf_slam_tpu.ops.pallas import gating as jg
from ekf_slam_tpu_torch import checks
from ekf_slam_tpu_torch.ops import association as tas
from ekf_slam_tpu_torch.ops import gating as tg

from torch_parity_helpers import (jax_state, n, port, random_state, t,
                                  torch_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _case(rng, M, K=12, n_active=8, pad=1, dtype=np.float64):
    """A state with ``n_active`` of K slots filled (D = 3 + 2K rounded up
    to ``pad``) and M measurements: most re-observe an active landmark
    with noise and its signature, the rest are new features.  Returns (JAX
    state, zs [M,3], rdiag [M,2], Rs [M,2,2]); Rs has rdiag on its
    diagonal and noise off it, which the gate does not read."""
    js = jax_state(random_state(rng, K=K, n_active=n_active, pad=pad,
                                dtype=dtype))
    x, sig = np.asarray(js.x, np.float64), np.asarray(js.sig, np.float64)
    targets = rng.integers(0, n_active, M)
    new = rng.random(M) < 0.25
    lm = x[3:3 + 2 * K].reshape(K, 2)[targets] + rng.normal(0, 0.05, (M, 2))
    lm[new] = rng.uniform(-6, 6, (int(new.sum()), 2))
    d = lm - x[:2]
    zs = np.stack([np.hypot(d[:, 0], d[:, 1]),
                   (np.degrees(np.arctan2(d[:, 1], d[:, 0])) - x[2]) % 360.0,
                   np.where(new, 100.0 + np.arange(M), sig[targets])], -1)
    rdiag = np.stack([zs[:, 0] * 0.01, rng.uniform(0.5, 5.0, M)], -1)
    Rs = np.zeros((M, 2, 2))
    Rs[:, 0, 0], Rs[:, 1, 1] = rdiag[:, 0], rdiag[:, 1]
    Rs[:, 0, 1] = Rs[:, 1, 0] = rng.normal(0, 0.1, M)
    return js, zs.astype(dtype), rdiag.astype(dtype), Rs.astype(dtype)


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


def _state_args(js, zs, Rs):
    """``gate_costs_state``'s arguments for a JAX state, as CPU tensors."""
    ts = torch_state(js)
    return (ts.x, ts.P, ts.landmarks, ts.sig, ts.active, t(zs), t(Rs))


@pytest.mark.parametrize("M,wrap,s_cost", [(4, True, 1e6), (8, False, 1e6),
                                           (8, True, 1e-11),
                                           (300, True, 1e6)])
def test_gate_costs_ref_matches_pallas_f64(rng, M, wrap, s_cost):
    """M = 300 spans two of the TPU kernel's measurement tiles."""
    js, zs, rdiag, _ = _case(rng, M)
    got, want, act = _both(js, zs, rdiag, s_cost, wrap)
    assert got.shape == want.shape == (M, 12)
    assert np.isinf(got[:, ~act]).all() and np.isinf(want[:, ~act]).all()
    assert np.isfinite(got[:, act]).all()
    np.testing.assert_allclose(got[:, act], want[:, act], rtol=1e-10,
                               atol=0)


@pytest.mark.parametrize("M,wrap,pad,dtype", [
    (0, True, 1, np.float64), (1, True, 1, np.float64),
    (8, False, 1, np.float64), (70, True, 1, np.float64),
    (8, True, 16, np.float64), (70, False, 16, np.float64),
    (1, False, 1, np.float32), (8, True, 1, np.float32),
    (70, True, 16, np.float32)])
def test_gate_costs_state_matches_pallas(rng, M, wrap, pad, dtype):
    """The state-taking entry on CPU tensors (its plain version) against
    the JAX path: ``strips_from_state``, the R diagonal of
    association.py:275-276 and ``gate_costs_pallas(interpret=True)``.
    M = 70 crosses the CUDA kernel's 64-measurement chunk; pad = 16 gives
    a padded P (D = 27 rounded up to 32).  f64 within 1e-10 relative; f32
    within ``checks.gate_tolerance``: the bearings agree to the bit here,
    but XLA's fused CPU code rounds some products otherwise than
    PyTorch's separate kernels where the innovations cancel: 1e-5
    relative alone does not hold there, the bearing term of the tolerance
    covers it with room to spare.  At M = 0 the
    JAX wrapper cannot tile (its measurement tile is 0 rows), so the entry
    is held to its shape alone."""
    K = 12
    js, zs, rdiag, Rs = _case(rng, M, K=K, pad=pad, dtype=dtype)
    args = _state_args(js, zs, Rs)
    assert args[1].shape == (27 if pad == 1 else 32,) * 2
    got = tg.gate_costs_state(*args, 1e6, wrap)
    assert got.shape == (M, K) and got.dtype == args[0].dtype
    if M == 0:
        return
    lm, sig, act, prr, prl, pll = jg.strips_from_state(js)
    want = n(jg.gate_costs_pallas(
        js.x[:3], prr, jnp.asarray(zs),
        jnp.stack([jnp.asarray(Rs)[:, 0, 0], jnp.asarray(Rs)[:, 1, 1]], -1),
        lm, sig, act, prl, pll, 1e6, wrap_innovation=wrap, interpret=True))
    got, act = n(got), np.asarray(js.active)
    assert 0 < act.sum() < K
    assert np.isinf(got[:, ~act]).all() and np.isinf(want[:, ~act]).all()
    assert np.isfinite(got[:, act]).all()
    if dtype == np.float64:
        np.testing.assert_allclose(got[:, act], want[:, act], rtol=1e-10,
                                   atol=0)
    else:
        tol = n(checks.gate_tolerance(args, 1e6, wrap))[:, act]
        assert (np.abs(got[:, act] - want[:, act]) <= tol).all()


def test_gate_case_reads_only_the_strips():
    """checks.gate_case's P and Rs hold NaN wherever the gate does not
    read; the plain version still gives finite costs in every active
    slot, +inf in the others, on a padded P."""
    g = torch.Generator().manual_seed(0)
    args, keep = checks.gate_case(g, 9, 40, D=96)
    x, P, lm, sig, active, zs, Rs = args
    assert P.shape == (96, 96) and torch.isnan(P).sum() > 96 * 90
    assert torch.isnan(Rs[:, 0, 1]).all()
    assert lm.data_ptr() == x.data_ptr() + 3 * x.element_size()
    got = tg.gate_costs_state(*args, 1e6)
    assert torch.isfinite(got[:, active]).all()
    assert torch.isinf(got[:, ~active]).all()
    assert keep.shape == (9, 40) and keep.float().mean() > 0.99


@pytest.mark.parametrize("wrap", [True, False])
def test_gate_tolerance_bounds_a_bearing_shift(wrap):
    """The tolerance's bearing terms are the exact change of the cost
    under an innovation shift of ±delta: in f64, costs computed with every
    measured bearing moved by ±delta lie within gate_tolerance(rel=0) of
    the unmoved ones (up to f64 rounding), and the quadratic term is what
    covers the re-observations whose innovation is ≈ 0."""
    g = torch.Generator().manual_seed(1)
    args, keep = checks.gate_case(g, 16, 64, noise=0.0)
    args = tuple(a.double() if a.is_floating_point() else a for a in args)
    x, P, lm, sig, active, zs, Rs = args
    d = checks.BEARING_DELTA_DEG
    tol = checks.gate_tolerance(args, 1e6, wrap, rel=0.0)
    base = tg.gate_costs_state(*args, 1e6, wrap)
    ok = keep & active[None, :]
    for sgn in (1.0, -1.0):
        zs2 = zs.clone()
        zs2[:, 1] += sgn * d
        moved = tg.gate_costs_state(x, P, lm, sig, active, zs2, Rs, 1e6, wrap)
        gap = (moved - base).abs()[ok]
        assert (gap <= tol[ok] * (1 + 1e-9) + 1e-12 * base.abs()[ok]).all()
    lin = checks.gate_tolerance(args, 1e6, wrap, rel=0.0, delta=d) - (
        checks.gate_tolerance(args, 1e6, wrap, rel=0.0, delta=0.0))
    assert (lin[ok] > 0).all()


def test_bearing_gap_ulps():
    a = torch.tensor([10.0, 359.99997, 0.0, 180.0])
    assert checks.bearing_gap_ulps(a, a.clone()) == 0.0
    b = torch.nextafter(a, torch.full_like(a, 1e9))
    assert checks.bearing_gap_ulps(b, a) == 1.0
    # 0 and 360 are one bearing
    assert checks.bearing_gap_ulps(torch.tensor([360.0]),
                                   torch.tensor([0.0])) == 0.0


@pytest.mark.parametrize("pad,dtype", [(16, np.float64), (1, np.float32),
                                       (16, np.float32)])
def test_gate_batch_kernel_branch_decisions_match(rng, pad, dtype):
    """gate_batch(use_pallas=True) takes the same decisions as the JAX
    branch on a padded and on a float32 state."""
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    p = jc.EKFParams(capacity=12, dtype=jd, association="ml",
                     s_thresh=30.0, ref_compat=False)
    js, zs, _, Rs = _case(rng, 8, pad=pad, dtype=dtype)
    want = jas.gate_batch(js, jnp.asarray(zs), jnp.asarray(Rs), p,
                          use_pallas=True)
    got = tas.gate_batch(torch_state(js), t(zs), t(Rs), port(p),
                         use_pallas=True)
    for gd, w in zip(got, want):
        np.testing.assert_array_equal(n(gd), n(w))
    assert not n(got[0]).all()                 # some observations gated


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
    """The state-taking entry on CPU tensors runs its plain version and
    launches nothing."""
    js, zs, _, Rs = _case(rng, 6)
    args = _state_args(js, zs, Rs) + (1e6,)
    before = tg.gate_costs_state.launches
    got = tg.gate_costs_state(*args)
    assert tg.gate_costs_state.launches == before  # no kernel on the CPU
    assert torch.equal(got, tg.gate_costs_state_ref(*args))


@pytest.mark.parametrize("bad", ["zs_shape", "prl_shape", "active_dtype",
                                 "devices", "Rs_shape", "x_short"])
def test_gate_costs_wrapper_rejects_bad_inputs(bad):
    """``prl_shape``: P too small to hold the pose↔landmark strip and the
    diagonal blocks of K slots (K > (D − 3)/2)."""
    K, M = 5, 3
    x = torch.zeros(3 + 2 * K)
    args = dict(x=x, P=torch.eye(3 + 2 * K), lm=x[3:].view(K, 2),
                sig=torch.zeros(K), active=torch.ones(K, dtype=torch.bool),
                zs=torch.zeros((M, 3)), Rs=torch.ones((M, 2, 2)))
    if bad == "zs_shape":
        args["zs"] = torch.zeros((M, 2))
    elif bad == "prl_shape":
        args["P"] = torch.eye(2 + 2 * K)
    elif bad == "active_dtype":
        args["active"] = torch.ones(K)
    elif bad == "devices":
        args["sig"] = args["sig"].to("meta")
    elif bad == "Rs_shape":
        args["Rs"] = torch.ones((M, 2))
    else:
        args["x"] = torch.zeros(2)
    with pytest.raises(ValueError):
        tg.gate_costs_state(**args, s_cost=1.0)
