"""ekf_slam_tpu_torch.models.maintenance against
ekf_slam_tpu.models.maintenance on the CPU.

Every function runs on the same states, made with numpy from a seed, in
both packages: the slot permutation, the dense eviction (bit-equal: it is
a gather and zeros, on f64 and on bf16 P, padded or not), the factored
eviction (a gather of S's rows and the recompression: within f64
rounding of JAX's, and of the dense eviction), the per-slot traces (bf16
traces added in bf16, as JAX adds them), the duplicate and uncertainty
masks and ``maintain``.

On a factored state the traces are row norms, sums whose order differs
from XLA's, so the factored cases use traces well apart from the cut and
from each other (random P plus a distinct diagonal per slot); the tie
rule of ``duplicate_mask`` is held on dense states, where the traces are
P's own diagonal entries."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import EKFParams as JParams
from ekf_slam_tpu.models import maintenance as JM
from ekf_slam_tpu_torch.models import maintenance as TM

from torch_parity_helpers import jax_state, n, port, t, torch_state

K = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _params(dtype=jnp.float64):
    return JParams(capacity=K, max_obs=4, ref_compat=False, dtype=dtype)


def _arrays(seed, n_active=8, pad=1, spread=True, close_pairs=()):
    """x, P, sig, active, n_active with landmarks spread out, the slots in
    ``close_pairs`` placed 0.1 m from their partners, and P's slot traces
    well apart (0.2·k + noise)."""
    rng = np.random.default_rng(seed)
    D0 = 3 + 2 * K
    D = -(-D0 // pad) * pad
    x = np.zeros(D)
    x[:3] = [0.3, -0.2, 40.0]
    lm = (np.stack([np.arange(n_active) * 2.0, rng.uniform(-4, 4, n_active)],
                   -1) if spread else rng.uniform(-5, 5, (n_active, 2)))
    for a, b in close_pairs:
        lm[b] = lm[a] + [0.06, 0.08]
    x[3:3 + 2 * n_active] = lm.reshape(-1)
    da = 3 + 2 * n_active
    A = rng.normal(0, 0.05, (da, da))
    P = np.zeros((D, D))
    P[:da, :da] = A @ A.T
    d = np.full(da, 0.05)
    d[3:] += np.repeat(0.2 * np.arange(1, n_active + 1), 2)
    P[:da, :da] += np.diag(d)
    sig = np.zeros(K)
    sig[:n_active] = np.arange(1, n_active + 1)
    return x, P, sig, np.arange(K) < n_active, np.int32(n_active)


def _same(tout, jout, exact=True, rtol=0.0):
    for f in tout._fields:
        a, b = n(getattr(tout, f)), n(getattr(jout, f))
        if exact or f != "P":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            scale = max(np.abs(b).max(), 1e-300)
            assert np.abs(a - b).max() <= rtol * scale, f


@pytest.mark.parametrize("seed", range(4))
def test_slot_permutation_matches(seed):
    rng = np.random.default_rng(seed)
    drop = rng.uniform(size=K) < 0.4
    na = int(rng.integers(0, K + 1))
    want = JM._slot_permutation(jnp.asarray(drop), jnp.asarray(na))
    got = TM._slot_permutation(t(drop), torch.tensor(na))
    np.testing.assert_array_equal(n(got), np.asarray(want))


@pytest.mark.parametrize("pad,cov", [(1, None), (8, None), (1, "bf16"),
                                     (8, "bf16")])
def test_evict_landmarks_matches(pad, cov):
    """Dense eviction equals JAX's bit for bit (f64 and bf16 P, padded
    or not), equals the gather of the kept rows and columns of the old
    P, and is zero past 3 + 2·n_kept; P is rewritten in place.  Drops
    flagged on inactive slots are ignored."""
    cov_dtype = jnp.bfloat16 if cov else None
    arrs = _arrays(1, pad=pad)
    js = jax_state(arrs, cov_dtype)
    drop = np.zeros(K, bool)
    drop[[1, 4, 5, 9]] = True                       # slot 9 is inactive
    want = JM.evict_landmarks(js, jnp.asarray(drop), _params())
    ts = torch_state(js)
    P0 = ts.P.clone()
    ptr = ts.P.data_ptr()
    got = TM.evict_landmarks(ts, t(drop), port(_params()))
    assert got.P.data_ptr() == ptr
    _same(got, want)
    kept = [0, 2, 3, 6, 7]
    rows = [0, 1, 2] + [r for s in kept for r in (3 + 2 * s, 4 + 2 * s)]
    k = len(rows)
    assert torch.equal(got.P[:k, :k], P0[rows][:, rows])
    assert not got.P[k:].any() and not got.P[:, k:].any()
    assert int(got.n_active) == 5


def test_evict_nothing_is_identity():
    """No drop: the state comes back bit for bit (JAX's
    test_evict_nothing_is_identity), through the eviction itself."""
    js = jax_state(_arrays(2))
    ts = torch_state(js)
    P0, x0 = ts.P.clone(), ts.x.clone()
    got = TM.evict_landmarks(ts, torch.zeros(K, dtype=torch.bool),
                             port(_params()))
    assert torch.equal(got.P, P0) and torch.equal(got.x, x0)
    assert int(got.n_active) == 8


def _factor(arrs):
    x, P, sig, act, na = arrs
    da = 3 + 2 * int(na)
    S = np.zeros_like(P)
    S[:da, :da] = np.linalg.cholesky(P[:da, :da])
    return x, S, sig, act, na


@pytest.mark.parametrize("extra", [0, 4])
def test_evict_factored_matches(extra):
    """Factored eviction (S's kept rows, then the recompression) against
    JAX's at f64 (≤ 1e-12 of |S|max), and S·Sᵀ against the dense
    eviction of P = S·Sᵀ; lower triangular, the freed rows and columns
    exactly 0.  ``extra`` spare columns stand for srekf_fast's noise
    buffer."""
    x, P, sig, act, na = _arrays(3)
    if extra:
        D = P.shape[0] + extra
        x = np.concatenate([x, np.zeros(extra)])
        P = np.pad(P, ((0, extra), (0, extra)))
    arrs = _factor((x, P, sig, act, na))
    js = jax_state(arrs)
    drop = np.zeros(K, bool)
    drop[[0, 3, 6]] = True
    want = JM.evict_landmarks_factored(js, jnp.asarray(drop), _params())
    got = TM.evict_landmarks_factored(torch_state(js), t(drop),
                                      port(_params()))
    _same(got, want, exact=False, rtol=1e-12)
    S = n(got.P)
    assert np.array_equal(S, np.tril(S))
    d = 3 + 2 * 5
    assert not S[d:].any() and not S[:, d:].any()
    S0 = np.asarray(arrs[1])
    dense = TM.evict_landmarks(
        torch_state(jax_state((x, S0 @ S0.T, sig, act, na))), t(drop),
        port(_params()))
    np.testing.assert_allclose(S @ S.T, n(dense.P), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(n(got.x), n(dense.x))


@pytest.mark.parametrize("factored,cov", [(False, None), (False, "bf16"),
                                          (True, None)])
def test_slot_traces_match(factored, cov):
    """Per-slot traces: P's diagonal pairs added in P's dtype (bf16 on
    the campaign's path, so bit-equal to JAX's bf16 sum), or the row
    norms of the factor (within f64 rounding)."""
    arrs = _factor(_arrays(4)) if factored else _arrays(4)
    js = jax_state(arrs, jnp.bfloat16 if cov else None)
    want = JM._slot_traces(js, factored)
    got = TM._slot_traces(torch_state(js), factored)
    assert got.dtype == (torch.bfloat16 if cov else torch.float64)
    if factored:
        np.testing.assert_allclose(n(got), n(want), rtol=1e-14, atol=0)
    else:
        np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("block", [2048, 3])
@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_duplicate_mask_matches_with_ties(dtype, block, monkeypatch):
    """The dense duplicate mask: close pairs whose traces differ (the
    larger goes), a close pair with equal traces (the higher slot goes),
    a triple, a pair at exactly the radius's distance apart in the grid,
    an inactive slot close to an active one (ignored) — equal to JAX's at
    f64 and f32, in one block of rows or in blocks of 3."""
    x, P, sig, act, na = _arrays(5, close_pairs=((0, 1), (2, 3), (5, 6),
                                                 (5, 7)))
    P[9, 9] = P[7, 7]                       # slots 2 and 3: equal traces
    P[10, 10] = P[8, 8]
    x[3 + 2 * 8:3 + 2 * 9] = x[3:5] + 0.01  # inactive slot 8 near slot 0
    x, P = x.astype(np.dtype(dtype)), P.astype(np.dtype(dtype))
    js = jax_state((x, P, sig, act, na))
    monkeypatch.setattr(TM, "_DUP_BLOCK", block)
    for radius in (0.05, 0.1, 0.5, 3.0):
        want = np.asarray(JM.duplicate_mask(js, radius))
        got = n(TM.duplicate_mask(torch_state(js), radius))
        np.testing.assert_array_equal(got, want, err_msg=str(radius))
    assert want.any()
    assert n(TM.duplicate_mask(torch_state(js), 0.5))[3]       # the tie


def test_duplicate_mask_factored_and_prune_match():
    """The factored masks (traces from the factor's row norms, well apart
    from the cut and each other) and prune_by_uncertainty on dense, bf16
    and factored states, against JAX's."""
    arrs = _arrays(6, close_pairs=((1, 2), (4, 5)))
    for factored, cov in ((False, None), (False, jnp.bfloat16),
                          (True, None)):
        js = jax_state(_factor(arrs) if factored else arrs, cov)
        ts = torch_state(js)
        for radius in (0.2, 1.0):
            np.testing.assert_array_equal(
                n(TM.duplicate_mask(ts, radius, factored)),
                np.asarray(JM.duplicate_mask(js, radius, factored)))
        for cut in (0.5, 0.9, 1.3):
            np.testing.assert_array_equal(
                n(TM.prune_by_uncertainty(ts, cut, factored)),
                np.asarray(JM.prune_by_uncertainty(js, cut, factored)))


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("radius,cut", [(0.5, 0.0), (0.0, 1.0),
                                        (0.5, 1.0)])
def test_maintain_matches(factored, radius, cut):
    """``maintain`` against JAX's: the same count, and the same state
    (bit for bit dense, within f64 rounding factored)."""
    arrs = _arrays(7, close_pairs=((0, 1), (3, 4)))
    js = jax_state(_factor(arrs) if factored else arrs)
    want, jn = JM.maintain(js, _params(), merge_radius=radius,
                           max_trace=cut, factored=factored)
    got, tn = TM.maintain(torch_state(js), port(_params()),
                          merge_radius=radius, max_trace=cut,
                          factored=factored)
    assert int(tn) == int(jn) > 0 and tn.dtype == torch.int32
    _same(got, want, exact=not factored, rtol=1e-12)


@pytest.mark.parametrize("factored", [False, True])
def test_maintain_without_drops_leaves_the_state(factored):
    """A maintenance pass that drops nothing returns the very same state
    object, P untouched bit for bit (no gather, no recompression)."""
    arrs = _arrays(8)
    ts = torch_state(jax_state(_factor(arrs) if factored else arrs))
    P0 = ts.P.clone()
    got, cnt = TM.maintain(ts, port(_params()), merge_radius=0.05,
                           max_trace=1e6, factored=factored)
    assert int(cnt) == 0 and got is ts
    assert torch.equal(got.P, P0)
