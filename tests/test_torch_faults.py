"""ekf_slam_tpu_torch.utils.faults against ekf_slam_tpu.utils.faults on
the CPU.

The injectors take the JAX injectors' own draws, made with jax.random in
their split order, and must give the same arrays bit for bit.  The
verdict and the rollback run on dense and factored states (P = S·Sᵀ),
f64 and bf16, against JAX's; the port's ``guarded`` writes into
``after.P`` in place, and a rejected tick, even one whose P holds NaN,
leaves x and P bit for bit as ``before`` holds them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.utils import faults as JF
from ekf_slam_tpu_torch.utils import faults as TF

from torch_parity_helpers import jax_state, n, random_state, t, torch_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _ranges(T=40, B=64, seed=0):
    return np.random.default_rng(seed).uniform(0.5, 8.0, (T, B))


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_drop_scans_with_jax_draws(p):
    r = _ranges()
    key = jax.random.PRNGKey(3)
    want = JF.drop_scans(jnp.asarray(r), key, p)
    drop = jax.random.bernoulli(key, p, (r.shape[0],))
    got = TF.drop_scans(t(r), None, p, drop=t(drop))
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("frac", [0.25, 0.5])
def test_blank_sectors_with_jax_draws(frac):
    r = _ranges()
    T, B = r.shape
    key = jax.random.PRNGKey(5)
    want = JF.blank_sectors(jnp.asarray(r), key, 0.5, sector_frac=frac)
    k1, k2 = jax.random.split(key)
    hit = jax.random.bernoulli(k1, 0.5, (T,))
    start = jax.random.randint(k2, (T,), 0, B)
    got = TF.blank_sectors(t(r), None, 0.5, sector_frac=frac, hit=t(hit),
                           start=t(start))
    np.testing.assert_array_equal(n(got), n(want))
    assert set(np.isnan(n(got)).sum(1).tolist()) <= {0, int(B * frac)}


@pytest.mark.parametrize("mag", [5.0, 0.5])
def test_corrupt_odometry_with_jax_draws(mag):
    odom = np.random.default_rng(1).normal(0, 3, (60, 3))
    key = jax.random.PRNGKey(7)
    want = JF.corrupt_odometry(jnp.asarray(odom), key, 0.2, magnitude=mag)
    k1, k2 = jax.random.split(key)
    hit = jax.random.bernoulli(k1, 0.2, (60,))
    noise = jax.random.normal(k2, (60, 3))
    got = TF.corrupt_odometry(t(odom), None, 0.2, magnitude=mag,
                              hit=t(hit), noise=t(noise))
    np.testing.assert_array_equal(n(got), n(want))
    assert 0 < int(np.asarray(hit).sum()) < 60


def test_injectors_draw_from_a_generator():
    """Without handed draws each injector draws from the generator: the
    same seed gives the same result, and the shapes of the faults are
    right (whole scans, one sector of int(B·frac) beams, odometry rows
    moved only on hit ticks)."""
    r = t(_ranges())
    odom = t(np.zeros((100, 3)))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        outs.append((TF.drop_scans(r, g, 0.3),
                     TF.blank_sectors(r, g, 0.5, sector_frac=0.25),
                     TF.corrupt_odometry(odom, g, 0.1, magnitude=5.0)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(n(a), n(b))
    dropped, blanked, bad = (n(a) for a in outs[0])
    rows = np.isnan(dropped)
    assert (rows.all(1) | ~rows.any(1)).all() and 0 < rows.all(1).sum() < 40
    assert set(np.isnan(blanked).sum(1).tolist()) <= {0, 16}
    moved = np.abs(bad).sum(1) > 0
    assert 0 < moved.sum() < 100


def _pair(rng, factored, cov_dtype=None):
    """A (before, after) pair of JAX states: after moves the pose by
    0.1 m and updates P (or the factor) a little."""
    arrs = random_state(rng, K=6, n_active=4)
    x, P, sig, act, na = arrs
    if factored:
        P = np.linalg.cholesky(P + 1e-12 * np.eye(len(P)))
    before = (x, P, sig, act, na)
    x2 = x.copy()
    x2[:2] += [0.06, 0.08]
    P2 = P * 0.97
    after = (x2, P2, sig, act, na)
    return jax_state(before, cov_dtype), jax_state(after, cov_dtype)


def _edit(js, **kw):
    return js._replace(**{k: jnp.asarray(v, getattr(js, k).dtype)
                          for k, v in kw.items()})


def _cases(jb, ja):
    """after states that pass and that fail each part of the verdict."""
    P = np.asarray(ja.P, np.float64)
    x = np.asarray(ja.x)
    nan_p = P.copy()
    nan_p[5, 7] = np.nan
    neg = P.copy()
    neg[3, 3] = -1.0
    far = x.copy()
    far[0] += 3.0
    inf_x = x.copy()
    inf_x[9] = np.inf
    neg_inactive = P.copy()
    neg_inactive[-1, -1] = -1.0          # past 3 + 2·n_active: not read
    return {"ok": ja, "nan_P": _edit(ja, P=nan_p), "neg_var": _edit(ja, P=neg),
            "jump": _edit(ja, x=far), "inf_x": _edit(ja, x=inf_x),
            "neg_inactive": _edit(ja, P=neg_inactive)}


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("cov", [None, "bf16"])
def test_check_tick_and_guarded_match(factored, cov):
    """Each verdict field equals JAX's; ``guarded`` returns JAX's state
    bit for bit (the accepted after, or before), with P written into the
    port's after.P in place; a rejected tick whose P holds NaN is rolled
    back bit for bit."""
    cov_dtype = jnp.bfloat16 if cov else None
    jb, ja = _pair(np.random.default_rng(2), factored, cov_dtype)
    for name, jaft in _cases(jb, ja).items():
        if factored and name in ("neg_var", "neg_inactive"):
            jaft = _edit(jaft, P=np.asarray(jaft.P, np.float64) * -1.0)
        for jump in (1.0, 0.05):
            jv = JF.check_tick(jb, jaft, jump, factored=factored)
            tb, ta = torch_state(jb), torch_state(jaft)
            tv = TF.check_tick(tb, ta, jump, factored=factored)
            for f in jv._fields:
                assert bool(getattr(tv, f)) == bool(getattr(jv, f)), (
                    name, jump, f)
            jout, _ = JF.guarded(jb, jaft, jump, factored=factored)
            ptr = ta.P.data_ptr()
            tout, tv2 = TF.guarded(tb, ta, jump, factored=factored)
            assert tout.P.data_ptr() == ptr            # in place
            assert bool(tv2.ok) == bool(jv.ok)
            for f in tout._fields:
                np.testing.assert_array_equal(
                    n(getattr(tout, f)), n(getattr(jout, f)),
                    err_msg=f"{name} {jump} {f}")
            if not bool(jv.ok):
                assert torch.equal(tout.P.view(torch.int16)
                                   if cov else tout.P.view(torch.int64),
                                   tb.P.view(torch.int16)
                                   if cov else tb.P.view(torch.int64))
                assert torch.equal(tout.x, tb.x)
    assert bool(JF.check_tick(jb, _cases(jb, ja)["neg_inactive"]).ok)


def test_guarded_nan_after_is_rolled_back_bit_for_bit():
    """A measurement that wrote NaN into x and all of P: the verdict
    fails and the output equals the snapshot bit for bit (a 0/1 blend
    would give NaN here)."""
    jb, _ = _pair(np.random.default_rng(4), False)
    tb = torch_state(jb)
    after = tb._replace(x=torch.full_like(tb.x, float("nan")),
                        P=torch.full_like(tb.P, float("nan")),
                        n_active=tb.n_active + 1)
    out, v = TF.guarded(tb, after, 1.0)
    assert not bool(v.ok) and not bool(v.finite)
    assert torch.equal(out.P.view(torch.int64), tb.P.view(torch.int64))
    assert torch.equal(out.x, tb.x) and int(out.n_active) == int(tb.n_active)
