"""The plain versions of the port's CUDA kernels in ops/kernels.py (K1
syrk_downdate, K3 score_lines, K4 cov_update, K5 pair_gather, K6
syrk_gram) against the JAX package's Pallas kernels run in interpret
mode, the wrappers' CPU behaviour and input checks (wall_search, K3's
one-launch wall search, included), and the build's hash of the sources.
The CUDA kernels themselves have no interpret mode: chip_smoke.py builds
them on the GPU and holds each one against these plain versions there."""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.ops.pallas import kernels as jk
from ekf_slam_tpu_torch.ops import kernels as tk

from torch_parity_helpers import n, t

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _sym(rng, D):
    A = rng.normal(0, 1, (D, D))
    return 0.5 * (A + A.T) + D * np.eye(D)


@pytest.mark.parametrize("D,R", [(256, 16), (384, 96)])
def test_syrk_ref_matches_pallas_f64(rng, D, R):
    P = _sym(rng, D)
    W = rng.normal(0, 1, (D, R))
    want = jk.syrk_downdate_pallas(jnp.asarray(P), jnp.asarray(W), tile=128,
                                   interpret=True)
    got = tk.syrk_downdate_ref(torch.from_numpy(P), torch.from_numpy(W))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jk.syrk_downdate_ref(jnp.asarray(P),
                                                     jnp.asarray(W))),
        rtol=1e-12, atol=1e-12)


def test_syrk_ref_matches_pallas_bf16(rng):
    """bf16 storage, f32 accumulation, one rounding on the way out in both
    packages; the f32 sums run in other orders, so an element may land on
    the neighbouring bf16 value: within one bf16 ulp of the element."""
    D, R = 256, 16
    P = jnp.asarray(_sym(rng, D), jnp.float32).astype(jnp.bfloat16)
    W = jnp.asarray(rng.normal(0, 0.1, (D, R)), jnp.float32).astype(
        jnp.bfloat16)
    want = n(jk.syrk_downdate_pallas(P, W, tile=128, interpret=True))
    got = tk.syrk_downdate_ref(t(P), t(W))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(n(got), want, rtol=2 ** -8, atol=0)
    assert np.mean(n(got) == want) > 0.99


@pytest.mark.parametrize("D", [300, 1003 // 3])
def test_syrk_ref_ragged_matches_f64_product(rng, D):
    """Any D: the port's kernel masks the ragged edge, so the plain
    version is held to P − W·Wᵀ directly on a D that is no multiple of
    128 (the JAX dispatcher would fall back to the dense GEMM here)."""
    P = _sym(rng, D)
    W = rng.normal(0, 1, (D, 16))
    got = tk.syrk_downdate_ref(torch.from_numpy(P), torch.from_numpy(W))
    np.testing.assert_allclose(got.numpy(), P - W @ W.T, rtol=1e-13,
                               atol=1e-12)


def test_syrk_wrapper_updates_cpu_tensor_in_place(rng):
    P = torch.from_numpy(_sym(rng, 64))
    W = torch.from_numpy(rng.normal(0, 1, (64, 8)))
    want = P - W @ W.T
    ptr = P.data_ptr()
    before = tk.syrk_downdate.launches
    out = tk.syrk_downdate(P, W)
    assert out.data_ptr() == ptr == P.data_ptr()
    np.testing.assert_allclose(P.numpy(), want.numpy(), rtol=1e-13)
    assert tk.syrk_downdate.launches == before     # no kernel on the CPU


@pytest.mark.parametrize("bad", ["not_square", "w_rows", "w_dtype",
                                 "devices"])
def test_syrk_wrapper_rejects_bad_inputs(bad):
    P = torch.zeros((8, 8))
    W = torch.zeros((8, 2))
    if bad == "not_square":
        P = torch.zeros((8, 9))
    elif bad == "w_rows":
        W = torch.zeros((7, 2))
    elif bad == "w_dtype":
        W = W.double()
    else:
        W = W.to("meta")
    with pytest.raises(ValueError):
        tk.syrk_downdate(P, W)


def _lines_case(rng, NH, B, thresh=0.25):
    pts = rng.uniform(-5, 5, (B, 2))
    lines = np.stack([rng.normal(0, 2, NH), rng.uniform(-4, 4, NH)], -1)
    valid = rng.random(B) < 0.85
    d = (np.abs(lines[:, :1] * pts[None, :, 0] - pts[None, :, 1]
                + lines[:, 1:]) / np.sqrt(lines[:, :1] ** 2 + 1))
    # keep every point more than 1e-6 away from the threshold
    valid &= ~(np.abs(d - thresh) < 1e-6).any(axis=0)
    return pts, valid, lines


@pytest.mark.parametrize("NH,B,dtype", [(8, 100, np.float64),
                                        (16, 256, np.float64),
                                        (16, 256, np.float32)])
def test_score_lines_ref_matches_pallas(rng, NH, B, dtype):
    pts, valid, lines = _lines_case(rng, NH, B)
    pts, lines = pts.astype(dtype), lines.astype(dtype)
    want = jk.score_lines_pallas(jnp.asarray(pts), jnp.asarray(valid),
                                 jnp.asarray(lines), 0.25, interpret=True)
    got = tk.score_lines_ref(torch.from_numpy(pts), torch.from_numpy(valid),
                             torch.from_numpy(lines), 0.25)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jk.score_lines_ref(
            jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(lines), 0.25)))
    before = tk.score_lines.launches
    np.testing.assert_array_equal(
        tk.score_lines(torch.from_numpy(pts), torch.from_numpy(valid),
                       torch.from_numpy(lines), 0.25).numpy(), got.numpy())
    assert tk.score_lines.launches == before       # no kernel on the CPU


@pytest.mark.parametrize("bad", ["points_shape", "valid_dtype",
                                 "lines_shape", "devices"])
def test_score_lines_wrapper_rejects_bad_inputs(bad):
    pts, valid, lines = torch.zeros((6, 2)), torch.ones(6, dtype=torch.bool), \
        torch.zeros((3, 2))
    if bad == "points_shape":
        pts = torch.zeros((6, 3))
    elif bad == "valid_dtype":
        valid = torch.ones(6)
    elif bad == "lines_shape":
        lines = torch.zeros(3)
    else:
        lines = lines.to("meta")
    with pytest.raises(ValueError):
        tk.score_lines(pts, valid, lines, 0.25)


@pytest.mark.parametrize("D,R,dtype,tol", [(27, 16, np.float64, 1e-12),
                                            (301, 16, np.float64, 1e-12),
                                            (301, 40, np.float32, 1e-5)])
def test_cov_update_ref_matches_pallas(rng, D, R, dtype, tol):
    """Odd D, so the TPU kernel's edge tiles are ragged; P − K·V within
    ``tol`` of max|P| (f32: the products sum in other orders)."""
    P, K, V = (_sym(rng, D).astype(dtype),
               rng.normal(0, 1, (D, R)).astype(dtype),
               rng.normal(0, 1, (R, D)).astype(dtype))
    want = n(jk.cov_update_pallas(jnp.asarray(P), jnp.asarray(K),
                                  jnp.asarray(V), interpret=True))
    got = tk.cov_update_ref(*map(torch.from_numpy, (P, K, V)))
    assert got.dtype == torch.from_numpy(P).dtype
    assert np.abs(n(got) - want).max() <= tol * np.abs(want).max()


def test_cov_update_wrapper_updates_cpu_tensor_in_place(rng):
    P = torch.from_numpy(_sym(rng, 33))
    K = torch.from_numpy(rng.normal(0, 1, (33, 6)))
    V = torch.from_numpy(rng.normal(0, 1, (6, 33)))
    want = P - K @ V
    ptr, before = P.data_ptr(), tk.cov_update.launches
    out = tk.cov_update(P, K, V)
    assert out.data_ptr() == ptr == P.data_ptr()
    assert torch.equal(P, want)
    assert tk.cov_update.launches == before        # no kernel on the CPU


@pytest.mark.parametrize("bad", ["k_rows", "v_shape", "v_dtype", "devices",
                                 "not_matrix"])
def test_cov_update_wrapper_rejects_bad_inputs(bad):
    P, K, V = torch.zeros((8, 8)), torch.zeros((8, 2)), torch.zeros((2, 8))
    if bad == "k_rows":
        K = torch.zeros((7, 2))
    elif bad == "v_shape":
        V = torch.zeros((3, 8))
    elif bad == "v_dtype":
        V = V.double()
    elif bad == "devices":
        V = V.to("meta")
    else:
        P = torch.zeros(64)
    with pytest.raises(ValueError):
        tk.cov_update(P, K, V)


@pytest.mark.parametrize("dtype,rows", [(jnp.float32, 64),
                                        (jnp.bfloat16, 64),
                                        (jnp.float64, 48)])
def test_pair_gather_ref_matches_pallas(rng, dtype, rows):
    """Bit-equal rows, with duplicate, unordered, window-straddling
    (start ≡ 7 mod 8) and last-row-pair starts, at shapes where the TPU
    kernel runs instead of falling back (rows % tile, width % 128,
    pairs % tile/2)."""
    P = jnp.asarray(rng.normal(0, 1, (rows, 256))).astype(dtype)
    starts = np.array([5, 7, 0, rows - 2, 5, 22, 15, 9], np.int32)
    want = n(jk.pair_gather_pallas(P, jnp.asarray(starts), interpret=True))
    got = tk.pair_gather_ref(t(P), torch.from_numpy(starts))
    np.testing.assert_array_equal(n(got), want)
    np.testing.assert_array_equal(
        want, n(jk.pair_gather_ref(P, jnp.asarray(starts))))
    before = tk.pair_gather.launches
    np.testing.assert_array_equal(
        n(tk.pair_gather(t(P), torch.from_numpy(starts))), want)
    assert tk.pair_gather.launches == before       # no kernel on the CPU


def test_pair_gather_clamps_out_of_range_starts():
    """The guard the kernel shares with its plain version: a start
    outside [0, rows − 2] is clamped into it, never read past P."""
    P = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3)
    got = tk.pair_gather(P, torch.tensor([-4, 9, 4, 3]))
    np.testing.assert_array_equal(got.numpy(), P[[0, 1, 3, 4, 3, 4, 3, 4]])


@pytest.mark.parametrize("mode", ["take", "pallas"])
def test_gather_pairs_modes_agree(rng, mode):
    P = torch.from_numpy(_sym(rng, 35))
    rows = torch.tensor([3, 33, 9, 3], dtype=torch.int64)
    want = P[[3, 4, 33, 34, 9, 10, 3, 4]]
    assert torch.equal(tk.gather_pairs(P, rows, mode), want)


@pytest.mark.parametrize("bad", ["one_row", "starts_float", "starts_2d",
                                 "devices"])
def test_pair_gather_wrapper_rejects_bad_inputs(bad):
    P, starts = torch.zeros((6, 4)), torch.tensor([0, 2])
    if bad == "one_row":
        P = torch.zeros((1, 4))
    elif bad == "starts_float":
        starts = starts.float()
    elif bad == "starts_2d":
        starts = starts[:, None]
    else:
        starts = starts.to("meta")
    with pytest.raises(ValueError):
        tk.pair_gather(P, starts)


def test_kernel_sources_export_the_bound_symbols():
    """The ctypes binding names one extern "C" entry point per source."""
    assert len(tk._SOURCES) == 7
    for name, src in tk._SOURCES.items():
        text = (ROOT / "ekf_slam_tpu_torch" / "csrc" / src).read_text()
        assert f'extern "C" int {name}(' in text
        assert "cudaGetLastError()" in text
        assert "ekf_slam_tpu/ops/pallas/" in text     # names what it replaces
    assert tk.BUILD_DIR == ROOT / "build" / "torch_kernels"


@pytest.mark.parametrize("D,R,dtype,tile,ktile,tol", [
    (384, 200, jnp.float64, 128, 1024, 1e-12),   # R padded to the k-tile
    (256, 700, jnp.float64, 128, 256, 1e-12),    # k-tiled accumulation
    (256, 300, jnp.float32, 128, 128, 1e-5),
    (256, 96, jnp.bfloat16, 128, 1024, 1e-5)])
def test_syrk_gram_ref_matches_pallas(rng, D, R, dtype, tile, ktile, tol):
    """G = S·Sᵀ in the accumulation dtype (f64 for f64, f32 for f32 and
    bf16 S) against the Pallas Gram in interpret mode, relative to max|G|
    (f32 sums of R products in other orders)."""
    S = jnp.asarray(rng.normal(0, 1, (D, R)), jnp.float32).astype(dtype)
    want = jk.syrk_gram_pallas(S, tile=tile, ktile=ktile, interpret=True)
    got = tk.syrk_gram_ref(t(S))
    wide = dtype == jnp.float64
    assert got.dtype == (torch.float64 if wide else torch.float32)
    assert np.asarray(want).dtype == (np.float64 if wide else np.float32)
    err = np.abs(n(got) - n(want)).max() / np.abs(n(want)).max()
    assert err <= tol


@pytest.mark.parametrize("use_pallas", [None, False, True])
def test_syrk_gram_dispatch_on_cpu(rng, use_pallas):
    """Every branch of the dispatch gives S·Sᵀ on a CPU tensor (the plain
    product, or the plain version standing in for the kernel), at a D no
    tile divides, and launches nothing; bf16 S gives an f32 Gram."""
    S = torch.from_numpy(rng.normal(0, 1, (131, 17)))
    before = tk.syrk_gram.launches
    G = tk.syrk_gram(S, use_pallas=use_pallas)
    np.testing.assert_allclose(G.numpy(), S.numpy() @ S.numpy().T,
                               rtol=1e-12, atol=1e-12)
    Gb = tk.syrk_gram(S.to(torch.bfloat16), use_pallas=use_pallas)
    assert Gb.dtype == torch.float32
    assert tk.syrk_gram.launches == before


@pytest.mark.parametrize("bad", ["vector", "devices"])
def test_syrk_gram_wrapper_rejects_bad_inputs(bad):
    S = torch.zeros((8, 4))
    if bad == "vector":
        S = S[0]
    else:
        S = S.to("meta")
    with pytest.raises(ValueError):
        tk.syrk_gram(S, use_pallas=True)


def _wall_args(B=64, NH=5, seed=0):
    from ekf_slam_tpu_torch.checks import wall_search_case
    return wall_search_case(seed, B, NH, "flagship", "cpu")


def test_wall_search_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper is the plain version, records included,
    and launches nothing (neither itself nor the scoring kernel)."""
    from ekf_slam_tpu_torch.ops.ransac import wall_search_ref
    (pts, valid, trial, trial_ok), params = _wall_args(B=1024, NH=64)
    T, NH = params.wall_search_timeout, trial.shape[0]
    before = (tk.wall_search.launches, tk.score_lines.launches)
    counts = torch.zeros((T + 1, NH), dtype=torch.int32)
    pools = torch.zeros((T, pts.shape[0]), dtype=torch.bool)
    got = tk.wall_search(pts, valid, trial, trial_ok, params,
                         counts_out=counts, pools_out=pools)
    want = wall_search_ref(pts, valid, trial, trial_ok, params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].any()
    assert (tk.wall_search.launches, tk.score_lines.launches) == before
    assert torch.equal(counts[0], torch.where(trial_ok, tk.score_lines_ref(
        pts, valid, trial, params.inlier_dist), 0))
    assert torch.equal(pools[-1], got[2])


@pytest.mark.parametrize("bad", ["points_shape", "valid_dtype", "trial_shape",
                                 "trial_ok_shape", "no_lines", "no_rounds",
                                 "devices", "counts_shape", "pools_dtype"])
def test_wall_search_wrapper_rejects_bad_inputs(bad):
    import dataclasses
    (pts, valid, trial, trial_ok), params = _wall_args()
    kw = {}
    if bad == "points_shape":
        pts = torch.zeros((64, 3))
    elif bad == "valid_dtype":
        valid = valid.float()
    elif bad == "trial_shape":
        trial = trial.reshape(-1)
    elif bad == "trial_ok_shape":
        trial_ok = trial_ok[:-1]
    elif bad == "no_lines":
        trial, trial_ok = trial[:0], trial_ok[:0]
    elif bad == "no_rounds":
        params = dataclasses.replace(params, wall_search_timeout=0)
    elif bad == "devices":
        trial = trial.to("meta")
    elif bad == "counts_shape":
        kw["counts_out"] = torch.zeros((params.wall_search_timeout,
                                        trial.shape[0]), dtype=torch.int32)
    else:
        kw["pools_out"] = torch.zeros((params.wall_search_timeout,
                                       pts.shape[0]))
    with pytest.raises(ValueError):
        tk.wall_search(pts, valid, trial, trial_ok, params, **kw)


def test_build_digest_covers_headers_and_flags(tmp_path, monkeypatch):
    """The build's file name hashes the source, every header of csrc/ and
    the flags: an edit to score_lines.cuh rebuilds both kernels that
    include it."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(ROOT / "ekf_slam_tpu_torch" / "csrc", csrc)
    monkeypatch.setattr(tk, "_CSRC", csrc)
    flags = tk._NVCC_FLAGS + tk._EXTRA_FLAGS["wall_search"]
    before = {n: tk._digest(n, flags) for n in ("score_lines",
                                                "wall_search")}
    assert tk._digest("wall_search", tk._NVCC_FLAGS) != before["wall_search"]
    header = csrc / "score_lines.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: tk._digest(n, flags) for n in before}
    assert all(after[n] != before[n] for n in before)
    for src in ("wall_search.cu", "score_lines.cu"):
        assert '#include "score_lines.cuh"' in (csrc / src).read_text()
