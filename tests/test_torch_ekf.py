"""ekf_slam_tpu_torch angles, scan geometry and the EKF core (predict,
append, innovation, measurement noise, the rank-2 update and the
sequential measurement chain) against ekf_slam_tpu at float64, plus the
bf16-storage forms."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.models import ekf as jekf
from ekf_slam_tpu.ops import angles as ja
from ekf_slam_tpu.ops import scan as jscan
from ekf_slam_tpu.ops import observations as jobs
from ekf_slam_tpu.ops.observations import ObsBatch as JObs
from ekf_slam_tpu.state import init_state as jinit
from ekf_slam_tpu_torch.models import ekf as tekf
from ekf_slam_tpu_torch.ops import angles as ta
from ekf_slam_tpu_torch.ops import scan as tscan
from ekf_slam_tpu_torch.ops import observations as tobs
from ekf_slam_tpu_torch.ops.observations import ObsBatch as TObs
from ekf_slam_tpu_torch.state import init_state as tinit

from test_batched import measurement_of
from test_ekf_core import make_pair
from torch_parity_helpers import (jax_state, max_rel, n, port, random_state,
                                  t, torch_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _angles(rng):
    a = np.concatenate([rng.uniform(-1000, 1000, 4000),
                        np.arange(-1080.0, 1081.0, 90.0),
                        [0.0, -0.0, 360.0, -360.0, 180.0, -180.0, 1e-300]])
    return a


@pytest.mark.parametrize("name,nargs", [("wrap_to_360", 1),
                                        ("wrap_to_180", 1),
                                        ("angdiff_deg", 2)])
def test_wraps_match_bit_for_bit(rng, name, nargs):
    """The wraps are pure arithmetic: equal to the last bit, including
    the positive-multiple-of-360 → 360 rule."""
    args = [_angles(rng) for _ in range(nargs)]
    want = np.asarray(getattr(ja, name)(*map(jnp.asarray, args)))
    got = getattr(ta, name)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["cosd", "sind", "tand", "atand"])
def test_trig_matches(rng, name):
    """cos/sin/tan/atan go to PyTorch's vectorized kernels and XLA's:
    the two may round the last ulp differently, hence 1e-12, not equality
    (tand is kept away from its poles)."""
    x = rng.uniform(-80, 80, 4000) if name == "tand" else _angles(rng)
    if name == "atand":
        x = rng.normal(0, 5, 4000)
    want = np.asarray(getattr(ja, name)(jnp.asarray(x)))
    got = getattr(ta, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_atan2d_matches(rng):
    y, x = rng.normal(0, 3, 4000), rng.normal(0, 3, 4000)
    np.testing.assert_allclose(
        ta.atan2d(torch.from_numpy(y), torch.from_numpy(x)).numpy(),
        np.asarray(ja.atan2d(jnp.asarray(y), jnp.asarray(x))), atol=1e-12)


def test_scan_geometry_matches(rng):
    B = 200
    r = rng.uniform(0.1, 8.0, B)
    r[::17] = np.nan
    r[5] = -1.0
    r[6] = np.inf
    ang = np.linspace(0, 360, B, endpoint=False)
    pose = np.array([0.7, -1.2, 33.0])
    js = jscan.scan_from_ranges(jnp.asarray(r), jnp.asarray(ang))
    ts = tscan.scan_from_ranges(torch.from_numpy(r), torch.from_numpy(ang))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.ranges.numpy(), np.asarray(js.ranges))
    np.testing.assert_allclose(
        tscan.scan_to_world(ts, torch.from_numpy(pose)).numpy(),
        np.asarray(jscan.scan_to_world(js, jnp.asarray(pose))),
        rtol=0, atol=1e-12)


def _ekf(**kw):
    kw.setdefault("capacity", 12)
    kw.setdefault("dtype", jnp.float64)
    return jc.EKFParams(**kw)


@pytest.mark.parametrize("ref_compat", [True, False])
@pytest.mark.parametrize("masked_writes", [False, True])
@pytest.mark.parametrize("q_floor", [(0.0, 0.0, 0.0), (1e-4, 2e-4, 0.3)])
def test_predict_matches(rng, ref_compat, masked_writes, q_floor):
    p = _ekf(ref_compat=ref_compat, masked_writes=masked_writes,
             q_floor=q_floor)
    js = jax_state(random_state(rng, pad=8))
    u = np.array([0.12, -7.5])
    want = jekf.predict(js, jnp.asarray(u), p)
    got = tekf.predict(torch_state(js), torch.from_numpy(u), port(p))
    assert max_rel(got.x, want.x) <= 1e-12
    assert max_rel(got.P, want.P) <= 1e-12


def test_predict_bf16_storage(rng):
    """bf16 P, f32 compute: the rows/cols are formed in f32 and rounded
    once into bf16 as in the JAX package; the two f32 computations may
    round a product differently, which bf16 storage turns into at most
    one bf16 ulp (2⁻⁸ relative) of an element."""
    p = _ekf(dtype=jnp.float32, cov_dtype=jnp.bfloat16, ref_compat=False)
    arrs = random_state(rng, dtype=np.float32)
    js = jax_state(arrs, cov_dtype=jnp.bfloat16)
    u = np.array([0.05, 3.0], np.float32)
    want = jekf.predict(js, jnp.asarray(u), p)
    got = tekf.predict(torch_state(js), torch.from_numpy(u), port(p))
    assert got.P.dtype == torch.bfloat16
    assert max_rel(got.x, want.x) <= 1e-6
    np.testing.assert_allclose(n(got.P), n(want.P), rtol=2 ** -8,
                               atol=2 ** -8 * np.abs(n(want.P)).max())


@pytest.mark.parametrize("masked_writes", [False, True])
@pytest.mark.parametrize("ref_compat", [True, False])
def test_append_sequence_matches(rng, masked_writes, ref_compat):
    """Appends fill slots n_active, n_active+1, …; once the state is full
    an append is a no-op (the JAX lax.cond, here a masked write)."""
    p = _ekf(capacity=6, masked_writes=masked_writes, ref_compat=ref_compat)
    js = jax_state(random_state(rng, K=6, n_active=3, pad=4))
    ts = torch_state(js)
    u = np.array([0.2, 4.0])
    for i in range(5):                   # 3 fill slots 3..5, 2 are no-ops
        R2 = np.diag(rng.uniform(0.01, 0.2, 2))
        loc = rng.uniform(-4, 4, 2)
        sig = float(10 + i)
        js = jekf.append(js, jnp.asarray(u), jnp.asarray(R2),
                         jnp.asarray(loc), jnp.asarray(sig), p)
        ts = tekf.append(ts, torch.from_numpy(u), torch.from_numpy(R2),
                         torch.from_numpy(loc), torch.tensor(sig), port(p))
        assert int(ts.n_active) == int(js.n_active)
        np.testing.assert_array_equal(ts.active.numpy(),
                                      np.asarray(js.active))
        np.testing.assert_array_equal(ts.sig.numpy(), np.asarray(js.sig))
        assert max_rel(ts.x, js.x) <= 1e-12
        assert max_rel(ts.P, js.P) <= 1e-12
    assert int(ts.n_active) == 6


def test_append_masked_off_is_noop(rng):
    p = port(_ekf())
    ts = torch_state(jax_state(random_state(rng)))
    before = [v.clone() for v in ts]
    out = tekf.append(ts, torch.tensor([0.1, 2.0], dtype=torch.float64),
                      torch.eye(2, dtype=torch.float64),
                      torch.tensor([1.0, 2.0], dtype=torch.float64),
                      torch.tensor(7.0), p, mask=torch.tensor(False))
    for a, b in zip(out, before):
        assert torch.equal(a, b)


def test_innovation_matches(rng):
    js = jax_state(random_state(rng, K=10, n_active=10))
    slots = np.array([0, 3, 9, 9, 4])
    tz, tA, tB = tekf.innovation(t(js.x), torch.from_numpy(slots))
    for i, s in enumerate(slots):
        jz, jA, jB = jekf.innovation(js.x, s, _ekf())
        assert max_rel(tz[i], jz) <= 1e-12
        assert max_rel(tA[i], jA) <= 1e-12
        assert max_rel(tB[i], jB) <= 1e-12


@pytest.mark.parametrize("noise_model", ["scaled", "constant", "fit"])
def test_measurement_noise_matches(rng, noise_model):
    p = _ekf(noise_model=noise_model, ref_compat=noise_model == "scaled",
             rc=(0.05, 2.0))
    zs = np.stack([rng.uniform(0.5, 6, 6), rng.uniform(0, 360, 6),
                   np.arange(6.0)], -1)
    np.testing.assert_allclose(
        tekf.measurement_noise_batch(torch.from_numpy(zs), port(p)).numpy(),
        np.asarray(jekf.measurement_noise_batch(jnp.asarray(zs), p)),
        rtol=1e-15)
    np.testing.assert_allclose(
        tekf.measurement_noise(torch.from_numpy(zs[2]), port(p)).numpy(),
        np.asarray(jekf.measurement_noise(jnp.asarray(zs[2]), p)),
        rtol=1e-15)
    R = rng.normal(0, 0.1, (6, 2, 2))
    R = R @ R.transpose(0, 2, 1)
    jo = JObs(rng=jnp.asarray(zs[:, 0]), bearing=jnp.asarray(zs[:, 1]),
              index=jnp.zeros(6, jnp.int32), loc=jnp.zeros((6, 2)),
              valid=jnp.ones(6, bool), R=jnp.asarray(R))
    to = TObs(*(t(v) for v in jo))
    np.testing.assert_allclose(
        tekf.obs_noise_batch(to, torch.from_numpy(zs), port(p)).numpy(),
        np.asarray(jekf.obs_noise_batch(jo, jnp.asarray(zs), p)),
        rtol=1e-15)


@pytest.mark.parametrize("pad,extra,cov", [(1, 0, None), (8, 0, None),
                                           (1, 5, None),
                                           (512, 3, jnp.bfloat16)])
def test_init_state_matches(pad, extra, cov):
    """Padding and extra dims give the JAX package's D, leaf for leaf."""
    p = _ekf(cov_dtype=cov)
    want = jinit(p, pad_to_multiple_of=pad, extra_dims=extra)
    got = tinit(port(p), pad_to_multiple_of=pad, extra_dims=extra,
                device="cpu")
    for f in got._fields:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      n(getattr(want, f)), err_msg=f)
    assert got.P.dtype == (torch.bfloat16 if cov else torch.float64)


# ---------------------------------------------------------------------------
# The rank-2 update and the sequential measurement chain
# ---------------------------------------------------------------------------

def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (so -0.0 and 0.0 differ, and NaNs compare)."""
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def test_inv2_matches(rng):
    """The closed-form 2×2 inverse: within 1e-15 of JAX's; a singular
    matrix gives the same inf/NaN pattern."""
    for _ in range(20):
        S = rng.normal(0, 1, (2, 2))
        np.testing.assert_allclose(n(tekf._inv2(torch.from_numpy(S))),
                                   n(jekf._inv2(jnp.asarray(S))),
                                   rtol=1e-15, atol=0)
    S = np.array([[0.0, 0.0], [0.0, 0.1]])
    got, want = n(tekf._inv2(torch.from_numpy(S))), n(jekf._inv2(
        jnp.asarray(S)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))


@pytest.mark.parametrize("ref_compat", [True, False])
@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("joseph", [False, True])
@pytest.mark.parametrize("slot", [0, 1, 2])
def test_update_matches(slot, joseph, symmetrize, ref_compat):
    """tests/test_ekf_core.py's update cases (z = [2, 133, slot+1], the
    reference's value-scaled R) against JAX's update: x and P within
    1e-12 relative, with the Joseph form and the symmetrization on and
    off, in both ref_compat modes."""
    p = jc.ref_compat_uc(capacity=8, dtype=jnp.float64, joseph=joseph,
                         symmetrize=symmetrize, ref_compat=ref_compat)
    state, _ = make_pair(3, seed=4)
    z = np.array([2.0, 133.0, float(slot + 1)])
    R = np.diag([z[0] * 0.1, z[1] * 5.0])
    want = jekf.update(state, jnp.asarray(z), slot, jnp.asarray(R), p)
    got = tekf.update(torch_state(state), t(z), slot, t(R), port(p))
    assert max_rel(got.x, want.x) <= 1e-12
    assert max_rel(got.P, want.P) <= 1e-12
    if joseph or symmetrize:
        np.testing.assert_allclose(n(got.P), n(got.P).T, rtol=0,
                                   atol=1e-12 * np.abs(n(got.P)).max())


def test_update_unwrapped_innovation_quirk():
    """A bearing near 0° against a predicted bearing near 360°: ref_compat
    keeps the reference's unwrapped innovation (EKF_SLAM_UC.m:145), the
    correct mode wraps it; each equal to JAX's within 1e-12, and the two
    modes differ."""
    state, _ = make_pair(1, seed=7)
    z, R = np.array([2.0, 1.0, 1.0]), np.diag([0.2, 5.0])
    xs = []
    for rc in (True, False):
        p = jc.ref_compat_uc(capacity=8, dtype=jnp.float64, ref_compat=rc)
        want = jekf.update(state, jnp.asarray(z), 0, jnp.asarray(R), p)
        got = tekf.update(torch_state(state), t(z), 0, t(R), port(p))
        assert max_rel(got.x, want.x) <= 1e-12
        assert max_rel(got.P, want.P) <= 1e-12
        xs.append(n(got.x))
    zhat = n(tekf.innovation(t(state.x), 0)[0])
    assert zhat[1] > 180.0 and not np.allclose(xs[0], xs[1])


@pytest.mark.parametrize("joseph", [False, True])
@pytest.mark.parametrize("symmetrize", [False, True])
def test_update_on_a_non_symmetric_P(rng, joseph, symmetrize):
    """P made non-symmetric on purpose: PHᵀ comes from P's columns and HP
    from its rows as in JAX, and the symmetrization is formed out of
    place (P + Pᵀ in place would read entries it already wrote), so x
    and P match JAX's within 1e-12 relative."""
    p = _ekf(capacity=8, joseph=joseph, symmetrize=symmetrize)
    arrs = list(random_state(rng, K=8, n_active=5))
    arrs[1] = arrs[1] + np.triu(rng.normal(0, 0.01, arrs[1].shape), 1)
    js = jax_state(arrs)
    z = np.array([3.0, 200.0, 3.0])
    R = np.diag([0.3, 50.0])
    want = jekf.update(js, jnp.asarray(z), 2, jnp.asarray(R), p)
    got = tekf.update(torch_state(js), t(z), 2, t(R), port(p))
    assert max_rel(got.x, want.x) <= 1e-12
    assert max_rel(got.P, want.P) <= 1e-12


@pytest.mark.parametrize("joseph", [False, True])
def test_update_bf16_storage_banded(rng, monkeypatch, joseph):
    """bf16 P, f32 compute: the product and the difference are formed in
    f32 and rounded once into P (ekf.py:273-279), band by band.  Against
    JAX: P within one bf16 ulp of |P|max (the two f32 computations may
    round a product differently), x within 1e-6.  Bands of 5 rows give
    the same bits as one band."""
    p = _ekf(dtype=jnp.float32, cov_dtype=jnp.bfloat16, ref_compat=False,
             joseph=joseph)
    js = jax_state(random_state(rng, K=12, n_active=8, dtype=np.float32),
                   cov_dtype=jnp.bfloat16)
    z = np.array([3.0, 200.0, 3.0], np.float32)
    R = np.diag([0.3, 50.0]).astype(np.float32)
    want = jekf.update(js, jnp.asarray(z), 2, jnp.asarray(R), p)
    one = tekf.update(torch_state(js), t(z), 2, t(R), port(p))
    assert one.P.dtype == torch.bfloat16
    assert max_rel(one.x, want.x) <= 1e-6
    np.testing.assert_allclose(n(one.P), n(want.P), rtol=0,
                               atol=2 ** -8 * np.abs(n(want.P)).max())
    D = one.P.shape[0]
    monkeypatch.setattr(tekf, "_BAND_ELEMS", 5 * D)
    banded = tekf.update(torch_state(js), t(z), 2, t(R), port(p))
    assert torch.equal(banded.P, one.P) and torch.equal(banded.x, one.x)


@pytest.mark.parametrize("slot", [4, 7, -1])
def test_update_clamps_a_slot_past_the_state(slot):
    """A slot whose rows lie past the state (capacity 4, so D = 11) reads
    the last row pair, as lax.dynamic_slice clamps its start into
    [0, D−2]; a negative slot clamps to row 1.  x and P within 1e-12 of
    JAX's, and the port indexes nothing out of range."""
    p = jc.ref_compat_known(capacity=4, dtype=jnp.float64)
    rng = np.random.default_rng(slot + 10)
    js = jax_state(random_state(rng, K=4, n_active=4))
    z = np.array([2.0, 50.0, 1.0])
    R = np.diag([0.02, 0.25])
    want = jekf.update(js, jnp.asarray(z), slot, jnp.asarray(R), p)
    for s in (slot, torch.tensor(slot, dtype=torch.int32)):
        got = tekf.update(torch_state(js), t(z), s, t(R), port(p))
        assert max_rel(got.x, want.x) <= 1e-12
        assert max_rel(got.P, want.P) <= 1e-12


@pytest.mark.parametrize("joseph,symmetrize,cov", [
    (False, False, None), (True, True, None), (False, False, "bf16")])
def test_masked_singular_row_leaves_the_state_bit_unchanged(joseph,
                                                            symmetrize, cov):
    """An empty slot under a zero R has a singular Φ (its inverse is
    inf/NaN, and unmasked the update poisons x and P).  Masked off, the
    update leaves x and P bit for bit as they were, in the plain,
    Joseph + symmetrized and bf16-storage forms."""
    p = port(_ekf(capacity=6, joseph=joseph, symmetrize=symmetrize,
                  dtype=jnp.float32 if cov else jnp.float64,
                  cov_dtype=jnp.bfloat16 if cov else None))
    st = tinit(p, device="cpu")
    z = torch.zeros(3, dtype=p.dtype)
    R = torch.zeros((2, 2), dtype=p.dtype)
    x0, P0 = st.x.clone(), st.P.clone()
    got = tekf.update(st, z, 3, R, p, mask=torch.tensor(False))
    assert _same_bits(got.x, x0) and _same_bits(got.P, P0)
    poisoned = tekf.update(tinit(p, device="cpu"), z, 3, R, p)
    assert not bool(torch.isfinite(poisoned.P.float()).all())


def _obs_pair(rows, locs, max_obs, R=None, dtype=jnp.float64):
    """The same observation batch for both packages (rows past their
    count invalid), with the fit covariance R [len(rows),2,2] if given."""
    jo = jobs.obs_from_rows(rows, locs, max_obs, dtype)
    if R is not None:
        Rp = np.zeros((max_obs, 2, 2))
        Rp[:len(rows)] = R
        jo = jo._replace(R=jnp.asarray(Rp, dtype))
    return jo, TObs(*(None if v is None else t(v) for v in jo))


MEASURE_CASES = {
    "signature-ref": dict(association="signature", ref_compat=True),
    "signature": dict(association="signature", ref_compat=False),
    "signature-constant": dict(association="signature",
                               noise_model="constant", ref_compat=False),
    "signature-fit": dict(association="signature", noise_model="fit",
                          ref_compat=False),
    "ml": dict(association="ml", s_cost=1e6, s_thresh=60.0,
               ref_compat=False),
    "ml-fit": dict(association="ml", noise_model="fit", s_cost=1e6,
                   s_thresh=60.0, ref_compat=False),
    "ml_unique-constant": dict(association="ml_unique",
                               noise_model="constant", s_cost=1e6,
                               s_thresh=60.0, ref_compat=False),
    "known-ref": dict(association="known", ref_compat=True),
    "known": dict(association="known", ref_compat=False),
}


@pytest.mark.parametrize("case", list(MEASURE_CASES))
def test_measure_matches(rng, case):
    """One tick's chain over 8 rows — re-observations of active landmarks
    (two of the same one), new features and invalid padding — against
    JAX's measure: n_active, sig and active equal, x and P within 1e-11
    relative.  Each row gates against the state the previous one left."""
    kw = dict(MEASURE_CASES[case])
    p = _ekf(capacity=12, max_obs=8, rc=(0.1, 5.0) if kw["ref_compat"]
             else (0.05, 2.0), **kw)
    js = jax_state(random_state(rng, K=12, n_active=5))
    x = np.asarray(js.x)
    rows, locs = [], []
    for k in (0, 2, 2, -1, 4, -2):
        if k >= 0:
            z = measurement_of(js, k, noise=0.02, rng=rng)
            loc = x[3 + 2 * k:5 + 2 * k]
        else:
            loc = rng.uniform(-6, 6, 2)
            d = loc - x[:2]
            z = np.array([np.hypot(*d), (np.degrees(np.arctan2(d[1], d[0]))
                                         - x[2]) % 360.0, 6.0 - k])
        rows.append(z)
        locs.append(loc)
    R = None
    if kw.get("noise_model") == "fit":
        A = rng.normal(0, 0.05, (len(rows), 2, 2))
        R = A @ A.transpose(0, 2, 1)
    jo, to_ = _obs_pair(rows, locs, p.max_obs, R)
    u = np.array([0.05, 2.0])
    want = jekf.measure(js, jo, jnp.asarray(u), p)
    got = tekf.measure(torch_state(js), to_, t(u), port(p))
    assert int(got.n_active) == int(want.n_active) > 5
    np.testing.assert_array_equal(n(got.active), n(want.active))
    np.testing.assert_array_equal(n(got.sig), n(want.sig))
    assert max_rel(got.x, want.x) <= 1e-11
    assert max_rel(got.P, want.P) <= 1e-11
    if case != "known-ref":         # the loop counter's slots move x far
        assert max_rel(got.x, js.x) > 1e-6


def test_measure_known_slot_past_capacity():
    """Known association under ref_compat indexes the update by the loop
    counter (EKF_SLAM.m:123): at capacity 4 with 8 rows it runs past slot
    3, where JAX's dynamic_slice clamps to the last row pair.  Equal to
    JAX within 1e-11 and finite."""
    p = jc.ref_compat_known(capacity=4, max_obs=8, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    js = jax_state(random_state(rng, K=4, n_active=4))
    rows = [measurement_of(js, k % 4, noise=0.01, rng=rng) for k in range(8)]
    locs = [np.zeros(2)] * 8
    jo, to_ = _obs_pair(rows, locs, 8)
    u = np.array([0.05, 2.0])
    want = jekf.measure(js, jo, jnp.asarray(u), p)
    got = tekf.measure(torch_state(js), to_, t(u), port(p))
    assert int(got.n_active) == int(want.n_active) == 4
    assert bool(torch.isfinite(got.P).all())
    assert max_rel(got.x, want.x) <= 1e-11
    assert max_rel(got.P, want.P) <= 1e-11


def test_measure_all_invalid_rows_leave_the_state_bit_unchanged():
    """A batch of invalid rows (zero range and bearing, so the scaled R
    is 0 and the gate's Φ singular): the state comes back bit for bit."""
    p = port(jc.ref_compat_uc(capacity=6, max_obs=4, dtype=jnp.float64))
    rng = np.random.default_rng(2)
    st = torch_state(jax_state(random_state(rng, K=6, n_active=3)))
    before = [v.clone() for v in st]
    got = tekf.measure(st, tobs.empty_obs(4, torch.float64, device="cpu"),
                       torch.tensor([0.05, 2.0], dtype=torch.float64), p)
    for a, b in zip(got, before):
        assert _same_bits(a, b)


def test_measure_sequence_matches():
    """tests/test_ekf_core.py's scripted sequence — predict, then the
    reference's measurement phase, six times over three landmarks, the
    first appended unconditionally — through both packages: x and P
    within 1e-11 relative, n_active 3."""
    p = jc.ref_compat_uc(capacity=8, dtype=jnp.float64)
    js, _ = make_pair(0)
    ts = torch_state(js)
    locs = {1: np.array([2.0, 0.0]), 2: np.array([0.0, 2.0]),
            3: np.array([-2.0, 1.0])}
    u = np.array([0.05, 2.0])
    rng = np.random.default_rng(3)
    for step in range(6):
        x = n(ts.x)
        rows, row_locs = [], []
        for idx in range(1, min(step + 1, 3) + 1):
            d = locs[idx] - x[:2]
            rows.append([np.hypot(*d) + rng.normal(0, 0.01),
                         np.mod(np.rad2deg(np.arctan2(d[1], d[0])) - x[2],
                                360), idx])
            row_locs.append(locs[idx])
        js = jekf.predict(js, jnp.asarray(u), p)
        ts = tekf.predict(ts, t(u), port(p))
        jo, to_ = _obs_pair(rows, row_locs, p.max_obs)
        js = jekf.measure(js, jo, jnp.asarray(u), p)
        ts = tekf.measure(ts, to_, t(u), port(p))
    assert int(ts.n_active) == int(js.n_active) == 3
    assert max_rel(ts.x, js.x) <= 1e-11
    assert max_rel(ts.P, js.P) <= 1e-11
