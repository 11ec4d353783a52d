"""ekf_slam_tpu_torch.utils.debug and state.lm_slice_index against the
JAX package's on the CPU: validate_state passes on a port session's f64
state (and on the kernel path's f32 state), and every one of its
assertions fails on the same corrupted states in both packages, at the
same check (the k-th check statement of each validate_state, matched
through the traceback); assert_symmetric on both sides of its tolerance;
lm_slice_index for ints and arrays."""
import ast
import dataclasses
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.state import FilterState as JState
from ekf_slam_tpu.state import lm_slice_index as j_lm
from ekf_slam_tpu.utils import debug as jdebug
from ekf_slam_tpu_torch import SlamSession
from ekf_slam_tpu_torch import config as tc
from ekf_slam_tpu_torch.sim import world as tw
from ekf_slam_tpu_torch.state import FilterState as TState
from ekf_slam_tpu_torch.state import lm_slice_index as t_lm
from ekf_slam_tpu_torch.utils import debug as tdebug

from torch_parity_helpers import port

# the checks of validate_state, in the order both packages make them
CHECKS = ["rank of x, sig, active", "rank of P", "shape of P",
          "shape of sig", "shape of active", "D >= 3 + 2K", "P dtype == x dtype",
          "0 <= n_active <= K", "active count == n_active",
          "active is a prefix", "x and P finite", "diagonal > -1e-5",
          "inactive block of P zero", "x zero past 3 + 2n"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _check_spans(module):
    """(first line, last line) of each check statement of the module's
    validate_state: its top-level asserts and chex assertion calls."""
    fn = next(node for node in ast.walk(ast.parse(open(module.__file__).read()))
              if isinstance(node, ast.FunctionDef)
              and node.name == "validate_state")
    spans = []
    for stmt in fn.body:
        chex_call = (isinstance(stmt, ast.Expr)
                     and isinstance(stmt.value, ast.Call)
                     and isinstance(stmt.value.func, ast.Attribute)
                     and getattr(stmt.value.func.value, "id", "") == "chex")
        if isinstance(stmt, ast.Assert) or chex_call:
            spans.append((stmt.lineno, stmt.end_lineno))
    return spans


SPANS = {}


def failing_check(module, state, params, check_values=True):
    """The index in CHECKS of the check at which validate_state raises,
    or None when it passes."""
    spans = SPANS.setdefault(module.__name__, _check_spans(module))
    assert len(spans) == len(CHECKS), (module.__name__, spans)
    try:
        module.validate_state(state, params, check_values=check_values)
    except AssertionError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if f.filename == module.__file__]
        line = frames[-1].lineno
        hit = [k for k, (a, b) in enumerate(spans) if a <= line <= b]
        assert len(hit) == 1, (module.__name__, line)
        return hit[0]
    return None


@pytest.fixture(scope="module")
def session_state():
    """A 40-tick f64 run of the port's sequential session (capacity 16,
    tests/test_utils.py's settings) as numpy arrays, and its params."""
    jep = jc.EKFParams(capacity=16, max_obs=8, ref_compat=False,
                       dtype=jnp.float64)
    ep = port(jep)
    rp = tc.RansacParams(line_consensus=60, bearing_window_deg=15.0,
                         wall_search_timeout=4, table_capacity=32,
                         promote_count=5, ref_compat=False,
                         dtype=torch.float64)
    cfg = tc.SimConfig(n_beams=720, max_range=12.0, dtype=torch.float64)
    g = torch.Generator()
    g.manual_seed(0)
    traj = tw.simulate(tw.rectangle_room(4.0, 3.0, device="cpu"),
                       tw.circle_controls(40, 0.05, 3.0, device="cpu"), cfg,
                       g)
    sess = SlamSession(ekf_params=ep, ransac_params=rp, seed=1, device="cpu")
    carry, _ = sess.run(traj.odom, traj.ranges, traj.beam_angles)
    f = carry.filt
    assert 0 < int(f.n_active) < ep.capacity
    return {k: getattr(f, k).numpy().copy() for k in TState._fields}, jep


def both(arrs, cov_dtype=False, x_dtype=None):
    """The same state in both packages from numpy arrays."""
    a = {k: np.array(v) for k, v in arrs.items()}
    if x_dtype is not None:
        a["x"] = a["x"].astype(x_dtype)
        a["sig"] = a["sig"].astype(x_dtype)
    js = JState(**{k: jnp.asarray(v) for k, v in a.items()})
    ts = TState(**{k: torch.from_numpy(np.array(v)) for k, v in a.items()})
    if cov_dtype:
        js = js._replace(P=js.P.astype(jnp.bfloat16))
        ts = ts._replace(P=ts.P.to(torch.bfloat16))
    return js, ts


def test_validate_state_passes_on_a_session_state(session_state):
    arrs, jep = session_state
    js, ts = both(arrs)
    assert failing_check(tdebug, ts, port(jep)) is None
    assert failing_check(jdebug, js, jep) is None


def _corruptions(arrs, K):
    """(name, expected check, arrays, capacity) of each corruption."""
    n = int(arrs["n_active"])
    d = 3 + 2 * n
    D = arrs["x"].shape[0]

    def with_(**kw):
        a = {k: np.array(v) for k, v in arrs.items()}
        for k, fn in kw.items():
            a[k] = fn(a[k])
        return a

    def put(idx, val):
        def fn(v):
            v[idx] = val
            return v
        return fn

    def gap(v):
        v[n - 1], v[n] = False, True
        return v
    bigger = with_(sig=lambda v: np.append(v, 0.0),
                   active=lambda v: np.append(v, False))
    return [
        ("x of rank 2", 0, with_(x=lambda v: v[:, None]), K),
        ("active of rank 0", 0, with_(active=lambda v: v[0]), K),
        ("P of rank 3", 1, with_(P=lambda v: v[None]), K),
        ("P one row short", 2, with_(P=lambda v: v[:-1]), K),
        ("sig one short", 3, with_(sig=lambda v: v[:-1]), K),
        ("active one short", 4, with_(active=lambda v: v[:-1]), K),
        ("capacity past D", 5, bigger, K + 1),
        ("n_active past K", 7, with_(n_active=lambda v: np.int32(K + 1)), K),
        ("n_active negative", 7, with_(n_active=lambda v: np.int32(-1)), K),
        ("n_active one more than active", 8,
         with_(n_active=lambda v: np.int32(n + 1)), K),
        ("active not a prefix", 9, with_(active=gap), K),
        ("NaN in x", 10, with_(x=put(0, np.nan)), K),
        ("inf in P", 10, with_(P=put((1, 2), np.inf)), K),
        ("negative diagonal", 11, with_(P=put((d - 1, d - 1), -1.0)), K),
        ("P[dim-1, dim-1] = 1", 12, with_(P=put((D - 1, D - 1), 1.0)), K),
        ("P inactive column", 12, with_(P=put((0, D - 1), 1e-3)), K),
        ("x past d", 13, with_(x=put(D - 1, 0.5)), K),
    ]


@pytest.mark.parametrize("case", range(17))
def test_each_corruption_fails_the_same_check(session_state, case):
    arrs, jep = session_state
    name, want, bad, K = _corruptions(arrs, jep.capacity)[case]
    js, ts = both(bad)
    jp = dataclasses.replace(jep, capacity=K)
    got_t = failing_check(tdebug, ts, port(jp))
    got_j = failing_check(jdebug, js, jp)
    assert got_t == got_j == want, (name, got_t, got_j, CHECKS[want])
    if want >= 7:           # a value check: skipped without check_values
        assert failing_check(tdebug, ts, port(jp), check_values=False) is None
        assert failing_check(jdebug, js, jp, check_values=False) is None


def test_bf16_P_with_f32_x_fails_the_dtype_check(session_state):
    """tuned_params' storage (bf16 P beside f32 x) fails JAX's dtype
    assertion, and the port's, as JAX's does."""
    arrs, jep = session_state
    js, ts = both(arrs, cov_dtype=True, x_dtype=np.float32)
    assert js.P.dtype == jnp.bfloat16 and js.x.dtype == jnp.float32
    assert ts.P.dtype == torch.bfloat16 and ts.x.dtype == torch.float32
    want = CHECKS.index("P dtype == x dtype")
    assert failing_check(tdebug, ts, port(jep)) == want
    assert failing_check(jdebug, js, jep) == want


def test_validate_state_passes_on_the_kernel_path_f32_state():
    """The check phase 7 of chip_smoke.py makes at 10k, at capacity 64 on
    the CPU: the kernel path's f32 state (use_pallas, pair gather, gemm
    correction; plain versions here) passes, and an element of P's
    inactive block set to 1 fails the inactive-block check."""
    ep = tc.EKFParams(capacity=64, max_obs=8, ref_compat=False,
                      update_mode="batched", pht_mode="rows",
                      rows_gather="pallas", use_pallas=True)
    rp = tc.RansacParams(line_consensus=60, bearing_window_deg=15.0,
                         wall_search_timeout=4, table_capacity=64,
                         promote_count=5, ref_compat=False, n_hypotheses=64)
    cfg = tc.SimConfig(n_beams=1024, max_range=12.0)
    g = torch.Generator()
    g.manual_seed(0)
    traj = tw.simulate(tw.rectangle_room(4.0, 3.0, device="cpu"),
                       tw.circle_controls(32, 0.05, 3.0, device="cpu"), cfg,
                       g)
    sess = SlamSession(ekf_params=ep, ransac_params=rp, seed=1, device="cpu")
    carry, _ = sess.run(traj.odom, traj.ranges, traj.beam_angles)
    f = carry.filt
    assert f.P.dtype == torch.float32 and int(f.n_active) > 0
    assert failing_check(tdebug, f, ep) is None
    D = f.P.shape[0]
    f.P[D - 1, D - 1] = 1.0
    assert failing_check(tdebug, f, ep) == CHECKS.index(
        "inactive block of P zero")
    f.P[D - 1, D - 1] = 0.0
    assert failing_check(tdebug, f, ep) is None


@pytest.mark.parametrize("asym,ok", [(0.4e-5, True), (0.9e-5, True),
                                     (1.1e-5, False), (3e-4, False)])
def test_assert_symmetric_on_both_sides_of_its_tolerance(asym, ok):
    rng = np.random.default_rng(5)
    A = rng.normal(size=(9, 9))
    P = A @ A.T
    P[2, 7] += asym
    for fn, arr in ((jdebug.assert_symmetric, P),
                    (tdebug.assert_symmetric, torch.from_numpy(P))):
        if ok:
            fn(arr)
        else:
            with pytest.raises(AssertionError, match="covariance asymmetry"):
                fn(arr)
    # a looser tolerance, and a bit-symmetric bf16 P; the port returns
    # the asymmetry it measured
    assert tdebug.assert_symmetric(torch.from_numpy(P), tol=1e-3) == float(
        np.abs(P - P.T).max())
    jdebug.assert_symmetric(P, tol=1e-3)
    sym = torch.from_numpy(A @ A.T).to(torch.bfloat16)
    assert tdebug.assert_symmetric(sym) == 0.0
    jdebug.assert_symmetric(jnp.asarray(A @ A.T).astype(jnp.bfloat16))


@pytest.mark.parametrize("k", [0, 1, 7, 9999])
def test_lm_slice_index(k):
    assert t_lm(k) == j_lm(k) == 3 + 2 * k
    ks = np.arange(k + 3)
    np.testing.assert_array_equal(t_lm(torch.from_numpy(ks)).numpy(),
                                  np.asarray(j_lm(jnp.asarray(ks))))
