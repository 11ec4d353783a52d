"""ekf_slam_tpu_torch angles, scan geometry and the EKF core (predict,
append, innovation, measurement noise) against ekf_slam_tpu at float64,
plus the bf16-storage forms."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.models import ekf as jekf
from ekf_slam_tpu.ops import angles as ja
from ekf_slam_tpu.ops import scan as jscan
from ekf_slam_tpu.ops.observations import ObsBatch as JObs
from ekf_slam_tpu.state import init_state as jinit
from ekf_slam_tpu_torch.models import ekf as tekf
from ekf_slam_tpu_torch.ops import angles as ta
from ekf_slam_tpu_torch.ops import scan as tscan
from ekf_slam_tpu_torch.ops.observations import ObsBatch as TObs
from ekf_slam_tpu_torch.state import init_state as tinit

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
