"""ekf_slam_tpu_torch's odometry quaternion helpers (utils/quat.py) and
filter-health metrics (utils/metrics.py) against ekf_slam_tpu's, on the
CPU at f64: the quaternion helpers within 1e-12, filter_health and nis
within 1e-12 relative (``finite`` equal) on torch_parity_helpers'
random states, padded P included, and MetricsLogger's JSONL lines equal
apart from the wall time."""
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.utils import metrics as jm
from ekf_slam_tpu.utils import quat as jq
from ekf_slam_tpu_torch.utils import metrics as tm
from ekf_slam_tpu_torch.utils import quat as tq

from torch_parity_helpers import jax_state, n, random_state, t, \
    torch_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _quats(seed):
    """Unit and non-unit quaternions [N,4], yaw spread over the circle
    (the ±180° seam included) with small roll and pitch."""
    rng = np.random.default_rng(seed)
    yaw = np.concatenate([rng.uniform(-np.pi, np.pi, 29),
                          [np.pi, -np.pi + 1e-9, 0.0]])
    tilt = rng.normal(0, 0.05, (yaw.size, 2))
    half = np.stack([yaw, tilt[:, 0], tilt[:, 1]], -1) / 2
    cz, sz = np.cos(half[:, 0]), np.sin(half[:, 0])
    cy, sy = np.cos(half[:, 1]), np.sin(half[:, 1])
    cx, sx = np.cos(half[:, 2]), np.sin(half[:, 2])
    q = np.stack([cx * cy * cz + sx * sy * sz, sx * cy * cz - cx * sy * sz,
                  cx * sy * cz + sx * cy * sz, cx * cy * sz - sx * sy * cz],
                 -1)
    return q * rng.uniform(0.5, 2.0, (yaw.size, 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quat_helpers_match(seed):
    q = _quats(seed)
    xy = np.random.default_rng(seed + 10).normal(0, 3, (q.shape[0], 2))
    pairs = [(tq.quat_inv(t(q)), jq.quat_inv(jnp.asarray(q))),
             (tq.quat_to_yaw_deg(t(q)), jq.quat_to_yaw_deg(jnp.asarray(q))),
             (tq.odom_pose_from_quat(t(xy), t(q)),
              jq.odom_pose_from_quat(jnp.asarray(xy), jnp.asarray(q)))]
    for got, want in pairs:
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(n(got), n(want), rtol=0, atol=1e-12)
    pose = n(pairs[2][0])
    assert (pose[:, 2] >= 0).all() and (pose[:, 2] < 360).all()


def test_quat_helpers_single_quaternion():
    """One quaternion [4]: a quarter turn about Z is yaw 90°, and q·q⁻¹ is
    the identity."""
    q = torch.tensor([np.cos(np.pi / 4), 0.0, 0.0, np.sin(np.pi / 4)],
                     dtype=torch.float64)
    assert abs(tq.quat_to_yaw_deg(q).item() - 90.0) < 1e-12
    pose = tq.odom_pose_from_quat(torch.tensor([1.0, 2.0],
                                               dtype=torch.float64), q)
    np.testing.assert_allclose(n(pose), [1.0, 2.0, 90.0], atol=1e-12)
    qi = tq.quat_inv(2.0 * q)
    np.testing.assert_allclose(
        n(qi), n(jq.quat_inv(2.0 * jnp.asarray(n(q)))), atol=1e-12)


def _rel(got, want):
    g, w = float(n(got)), float(n(want))
    return abs(g - w) / max(abs(w), 1e-300)


HEALTH_CASES = {
    "some active": dict(K=12, n_active=8, pad=1),
    "padded P": dict(K=12, n_active=8, pad=64),
    "no landmark": dict(K=12, n_active=0, pad=1),
    "full": dict(K=12, n_active=12, pad=1),
    "padded full": dict(K=20, n_active=20, pad=512),
}


@pytest.mark.parametrize("case", sorted(HEALTH_CASES))
def test_filter_health_matches(case):
    """finite equal; asym, min_diag and trace within 1e-12 relative, on a
    P made asymmetric in the active block (and, padded, holding values
    past 3 + 2·n_active that the mask must leave out)."""
    rng = np.random.default_rng(7)
    x, P, sig, active, na = random_state(rng, **HEALTH_CASES[case])
    da = 3 + 2 * int(na)
    P[:da, :da] += np.triu(rng.normal(0, 1e-6, (da, da)), 1)
    P[da:, da:] += np.eye(P.shape[0] - da) * -5.0     # outside the mask
    arrs = (x, P, sig, active, na)
    want = jm.filter_health(jax_state(arrs))
    got = tm.filter_health(torch_state(jax_state(arrs)))
    assert bool(got.finite) == bool(want.finite) is True
    assert got.finite.dtype == torch.bool and got.finite.dim() == 0
    for f in ("asym", "min_diag", "trace"):
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-12, f
        assert getattr(got, f).dtype == torch.float64
    assert float(n(got.min_diag)) > 0


@pytest.mark.parametrize("where", ["x", "P active", "P padding"])
def test_filter_health_not_finite_matches(where):
    """A NaN in x, in the active block, or in P past the active dims
    (0·NaN is NaN under the mask) makes ``finite`` false in both."""
    rng = np.random.default_rng(3)
    x, P, sig, active, na = random_state(rng, K=12, n_active=5, pad=64)
    if where == "x":
        x[1] = np.nan
    elif where == "P active":
        P[4, 2] = np.nan
    else:
        P[-1, -2] = np.inf
    arrs = (x, P, sig, active, na)
    want = jm.filter_health(jax_state(arrs))
    got = tm.filter_health(torch_state(jax_state(arrs)))
    assert bool(got.finite) == bool(want.finite) is False
    for f in ("min_diag", "trace"):
        assert _rel(getattr(got, f), getattr(want, f)) <= 1e-12, f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nis_matches(seed):
    rng = np.random.default_rng(seed)
    nu = rng.normal(0, 1, 2)
    A = rng.normal(0, 1, (2, 2))
    phi_inv = np.linalg.inv(A @ A.T + 0.1 * np.eye(2))
    got = tm.nis(t(nu), t(phi_inv))
    want = jm.nis(jnp.asarray(nu), jnp.asarray(phi_inv))
    assert _rel(got, want) <= 1e-12 and float(n(got)) > 0


def _log_lines(logger_cls, health, as_array):
    buf = io.StringIO()
    log = logger_cls(stream=buf)
    log.log(0, n_active=as_array(np.int32(7)), pose=as_array(
        np.array([1.5, -2.25, 30.0])), ok=as_array(np.bool_(True)),
        note="tick", rate=12.5)
    log.log(np.int64(1), **{k: as_array(np.array(v)) for k, v in
                            health.items()})
    log.log(2, counts=np.arange(4), flag=np.asarray(False))
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    for rec in lines:
        assert rec.pop("t_wall") >= 0
    return lines


def test_metrics_logger_lines_match():
    """The same fields, as torch tensors for the port and jax arrays for
    the JAX logger (numpy and Python values as they are), give the same
    JSONL records but for ``t_wall``."""
    rng = np.random.default_rng(5)
    x, P, sig, active, na = random_state(rng, K=6, n_active=4)
    health = jm.filter_health(jax_state((x, P, sig, active, na)))._asdict()
    want = _log_lines(jm.MetricsLogger, health, jnp.asarray)
    got = _log_lines(tm.MetricsLogger, health, torch.as_tensor)
    assert got == want
    assert got[1]["finite"] is True and list(got[0]) == list(want[0])


def test_metrics_logger_appends_to_a_file(tmp_path):
    """``path`` creates its directory and appends, one JSON line a call."""
    path = tmp_path / "sub" / "m.jsonl"
    for step in range(2):
        log = tm.MetricsLogger(str(path))
        rec = log.log(step, v=torch.tensor([1.0, 2.0]))
        log.close()
        assert rec["v"] == [1.0, 2.0]
    lines = path.read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]
