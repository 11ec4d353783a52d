"""The precision check of the K6 Gram (ekf_slam_tpu_torch.checks
gram_error / gram_compare) on the CPU, and the square-root recompression
that now takes the Gram through ``syrk_gram(S, use_pallas=True)``.

The card's kernel forms G = S·Sᵀ as three TF32 products (3xTF32).  Here a
test-only emulation of it (S split into TF32 hi and lo by bit rounding,
then hi·hiᵀ + hi·loᵀ + lo·hiᵀ in f32) must pass ``gram_compare``, and three
faulty stand-ins must fail it: one TF32 pass (``checks.tf32_single_pass``),
a Gram with one element moved by 1e-4·√(G_ii·G_jj), and a nonzero entry
in a zero row.  With the emulation in place of the port's ``syrk_gram``,
``sr_recompress`` takes the plain Gram's branch: QR on a factor whose
Gram is singular and on every recompression of the f32 tiny-R stress,
Cholesky on a session's factor.  On a CPU tensor ``sr_recompress``
launches no kernel and still matches JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.models import srekf as js
from ekf_slam_tpu.models import srekf_fast as jf
from ekf_slam_tpu_torch import EKFParams, RansacParams, SimConfig, SlamSession
from ekf_slam_tpu_torch.checks import (gram_banded_case, gram_compare,
                                       gram_dense_case, gram_error,
                                       gram_plain_errors,
                                       recompress_qr_case, tf32_round,
                                       tf32_single_pass)
from ekf_slam_tpu_torch.models import srekf_fast as tf
from ekf_slam_tpu_torch.ops import kernels as K
from ekf_slam_tpu_torch.sim import world as W

from test_ekf_core import make_pair
from test_srekf_fast import general_factor, with_buffer
from test_torch_srekf_fast import _batch, _same, _stress
from torch_parity_helpers import n, port, torch_state


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def emulated_3xtf32(S: torch.Tensor) -> torch.Tensor:
    """What the kernel's f32 body forms, in f32 on the CPU: hi =
    TF32(S), lo = TF32(S − hi), G = hi·hiᵀ + hi·loᵀ + lo·hiᵀ."""
    hi = tf32_round(S)
    lo = tf32_round(S - hi)
    return hi @ hi.T + hi @ lo.T + lo @ hi.T


def _banded(D=517):
    return gram_banded_case(torch.Generator().manual_seed(D), D)


@pytest.fixture(scope="module")
def session_state():
    """The filter state of of a short CPU srekf_fast session: capacity 32, f32,
    an 8-column noise buffer, 20 ticks (two recompressions, then four
    ticks of updates on the general factor): a few landmarks mapped, so
    most rows of S are zero."""
    ep = EKFParams(capacity=32, max_obs=8, ref_compat=False,
                   update_mode="srekf_fast", sr_noise_buffer=8,
                   dtype=torch.float32)
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    g = torch.Generator().manual_seed(0)
    traj = W.simulate(W.rectangle_room(4.0, 3.0, device="cpu"),
                      W.circle_controls(20, 0.05, 3.0, device="cpu"),
                      SimConfig(n_beams=512, max_range=12.0), g)
    sess = SlamSession(ekf_params=ep, ransac_params=rp, seed=1,
                       device="cpu")
    carry, _ = sess.run(traj.odom, traj.ranges, traj.beam_angles)
    zero = (carry.filt.P == 0).all(dim=1)
    assert int(carry.filt.n_active) > 0 and zero.any() and not zero.all()
    return carry.filt


@pytest.fixture(scope="module")
def session_factor(session_state):
    return session_state.P


def _case(name, session_factor):
    if name == "banded":
        return _banded()
    if name == "session":
        return session_factor
    return gram_dense_case(517, 517)


SHAPES = [(D, R) for D in (1, 129, 517) for R in (1, 3, 33, 517)]


@pytest.mark.parametrize("D,R", SHAPES)
def test_emulated_3xtf32_passes_and_one_pass_fails(D, R):
    """Ragged shapes, where every sum is short or the f32 plain Grams are
    accurate: the 3xTF32 emulation is within the limit, one TF32 pass is
    not."""
    S = gram_dense_case(D, R)
    plain = gram_plain_errors(S)
    assert set(plain) == {"cpu", "cpu_permuted"}
    good = gram_compare(emulated_3xtf32(S), S, plain)
    assert good["ok"], good
    bad = gram_compare(tf32_single_pass(S), S, plain)
    assert not bad["ok"], bad


@pytest.mark.parametrize("case", ["banded", "session"])
def test_short_sums_emulation_passes_one_pass_fails(case, session_factor):
    """A banded S (≤ 256 nonzero terms a sum, every tile pair) and a
    session's factor (zero rows included): the emulation passes, and is
    exactly 0 on the zero rows; one TF32 pass fails."""
    S = _case(case, session_factor)
    plain = gram_plain_errors(S)
    G = emulated_3xtf32(S)
    assert gram_compare(G, S, plain)["ok"]
    zero = (S == 0).all(dim=1)
    assert not G[zero].any() and not G[:, zero].any()
    assert not gram_compare(tf32_single_pass(S), S, plain)["ok"]


@pytest.mark.parametrize("case", ["dense", "banded", "session"])
@pytest.mark.parametrize("where", ["diagonal", "off_diagonal"])
def test_one_moved_element_fails(case, where, session_factor):
    """One element of the emulated Gram moved by 1e-4·√(G_ii·G_jj) (on a
    nonzero row pair) makes it fail."""
    S = _case(case, session_factor)
    plain = gram_plain_errors(S)
    G = emulated_3xtf32(S)
    d = torch.diagonal(G).double()
    rows = torch.nonzero(d > 0).flatten()
    i = int(rows[len(rows) // 2])
    j = i if where == "diagonal" else int(rows[len(rows) // 2 - 1])
    G[i, j] += float(1e-4 * (d[i] * d[j]).sqrt())
    res = gram_compare(G, S, plain)
    assert not res["ok"] and res["err"] >= 0.5e-4, res


@pytest.mark.parametrize("case", ["session", "dense_zero_row"])
def test_nonzero_entry_in_a_zero_row_fails(case, session_factor):
    """A zero row of S must give exactly 0 in its row and column of G: one
    tiny nonzero entry there makes e infinite."""
    if case == "session":
        S = session_factor
    else:
        S = gram_dense_case(129, 33)
        S[77] = 0.0
    G = emulated_3xtf32(S)
    assert gram_error(G, S) < 1e-5
    i = int(torch.nonzero((S == 0).all(dim=1)).flatten()[-1])
    G[0, i] = 1e-30
    res = gram_compare(G, S, gram_plain_errors(S))
    assert res["err"] == float("inf") and not res["ok"]


def test_gram_error_reads_nan_as_infinite():
    S = gram_dense_case(33, 3)
    G = S @ S.T
    G[3, 5] = float("nan")
    assert gram_error(G, S) == float("inf")


def test_tf32_round_keeps_ten_mantissa_bits():
    """Ties away from zero, low 13 bits cleared, exact on TF32 values."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0 + 2.0 ** -9])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         3.0 + 2.0 ** -9])
    got = tf32_round(x)
    assert torch.equal(got, want)
    assert not (got.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(tf32_round(got), got)


def _emulated_syrk_gram(S, use_pallas=None):
    return emulated_3xtf32(S)


def test_recompress_with_emulated_gram_takes_the_qr_branch(monkeypatch):
    """The factor whose Gram is singular (checks.recompress_qr_case): the
    plain Gram's Cholesky fails, and with the emulated 3xTF32 Gram the
    recompression takes the QR branch too."""
    monkeypatch.setattr(tf, "syrk_gram", _emulated_syrk_gram)
    res = recompress_qr_case(("cpu",))["cpu"]
    assert res["chol_failed"] and res["qr_taken"]


def test_recompress_with_emulated_gram_on_f32_stress(monkeypatch):
    """The f32 tiny-R stress of test_torch_srekf_fast through
    sr_update_panel (a recompression every update): with the emulated
    Gram, as with the plain one, every one of the 40 recompressions takes
    the QR branch (R ≪ HPHᵀ in f32 makes every Gram's Cholesky fail), S·Sᵀ
    stays finite and PSD to round-off, and the result is held to that
    test's tolerance: no further from the f64 run than twice JAX's f32
    distance plus 1e-3 of the largest entry."""
    p32, sr, b = _stress(23, general=False)

    @jax.jit
    def ticks(s):
        return jax.lax.scan(
            lambda c, _: (jf.sr_update_panel(c, *b, p32), None), s, None,
            length=40)[0]
    want = ticks(sr)
    tb = _batch(b)
    tb64 = tuple(a.double() if a.is_floating_point() else a for a in tb)
    p64 = port(dataclasses.replace(p32, dtype=jnp.float64))
    ref = torch_state(sr)
    ref = ref._replace(x=ref.x.double(), P=ref.P.double(),
                       sig=ref.sig.double())
    for _ in range(40):
        ref = tf.sr_update_panel(ref, *tb64, p64)

    qr_calls = []
    real = tf._retriangularize

    def counted(pre, d):
        qr_calls.append(d)
        return real(pre, d)
    monkeypatch.setattr(tf, "_retriangularize", counted)
    runs = {}
    for gram in ("plain", "emulated"):
        if gram == "emulated":
            monkeypatch.setattr(tf, "syrk_gram", _emulated_syrk_gram)
        got = torch_state(sr)
        for _ in range(40):
            got = tf.sr_update_panel(got, *tb, port(p32))
        runs[gram] = (got, len(qr_calls))
        qr_calls.clear()
    assert runs["plain"][1] == runs["emulated"][1] == 40
    d = 3 + 2 * 4
    P_r, P_j = (n(s.P @ s.P.T)[:d, :d] for s in (ref, want))
    scale = np.abs(P_r).max()
    err_j = np.abs(P_j - P_r).max() / scale
    for gram, (got, _) in runs.items():
        P_t = n(got.P @ got.P.T)[:d, :d]
        assert np.isfinite(P_t).all(), gram
        assert (np.linalg.eigvalsh(0.5 * (P_t + P_t.T)).min()
                >= -1e-6 * scale), gram
        S = n(got.P)
        assert np.array_equal(S, np.tril(S)), gram
        assert np.abs(P_t - P_r).max() / scale <= 2 * err_j + 1e-3, gram


@pytest.mark.parametrize("general", [False, True])
def test_recompress_on_cpu_launches_nothing_and_matches_jax(general):
    """On a CPU tensor ``syrk_gram(S, use_pallas=True)`` is the plain
    version: no kernel launch, and the recompression equals JAX's."""
    state, _ = make_pair(3, seed=11)
    sr = (general_factor(with_buffer(state)) if general
          else js.factor_from_state(with_buffer(state)))
    want = jf.sr_recompress(sr)
    before = K.syrk_gram.launches
    got = tf.sr_recompress(torch_state(sr))
    assert K.syrk_gram.launches == before
    _same(got, want)


def test_recompress_with_emulated_gram_takes_the_cholesky_branch(
        monkeypatch, session_state):
    """The session's own factor: the plain and the emulated Gram both
    take the Cholesky branch (no QR), and each recompressed P = L·Lᵀ is
    within 1e-5 of |P|max of the f64 S·Sᵀ on the active block (f32
    roundings of a Cholesky over a few dozen dims)."""
    d = 3 + 2 * int(session_state.n_active)
    S64 = session_state.P.double()
    want = (S64 @ S64.T)[:d, :d]
    qr_calls = []
    real = tf._retriangularize
    monkeypatch.setattr(tf, "_retriangularize",
                        lambda pre, dim: qr_calls.append(dim)
                        or real(pre, dim))
    for gram in ("plain", "emulated"):
        if gram == "emulated":
            monkeypatch.setattr(tf, "syrk_gram", _emulated_syrk_gram)
        L = tf.sr_recompress(session_state).P.double()
        assert not qr_calls, gram
        assert torch.equal(L, L.tril())
        P = (L @ L.T)[:d, :d]
        assert (P - want).abs().max() <= 1e-5 * want.abs().max(), gram


@pytest.mark.parametrize("D,R", [(517, 517), (129, 33)])
def test_gram_compare_on_sampled_rows(D, R):
    """The row-sample form of the check (``rows=``, as phase 10b of
    chip_smoke.py holds a factored eviction's Gram by 64 of its rows):
    over all rows it gives the full check's e and limit; on a sample the
    3xTF32 emulation passes, one TF32 pass fails, and a moved element in
    a sampled row fails."""
    S = gram_dense_case(D, R)
    G_good, G_bad = emulated_3xtf32(S), tf32_single_pass(S)
    every = torch.arange(D)
    plain_all = gram_plain_errors(S)
    assert gram_plain_errors(S, rows=every) == plain_all
    full = gram_compare(G_good, S, plain_all)
    assert gram_compare(G_good, S, plain_all, rows=every) == full
    rows = torch.linspace(0, D - 1, min(D, 16)).round().long()
    plain = gram_plain_errors(S, rows=rows)
    assert max(plain.values()) <= max(plain_all.values())
    assert gram_compare(G_good[rows], S, plain, rows=rows)["ok"]
    assert not gram_compare(G_bad[rows], S, plain, rows=rows)["ok"]
    moved = G_good[rows].clone()
    i, j = 3, int(rows[5])
    moved[i, j] += 1e-4 * float(torch.sqrt(G_good[rows[i], rows[i]]
                                           * G_good[j, j]))
    assert not gram_compare(moved, S, plain, rows=rows)["ok"]
