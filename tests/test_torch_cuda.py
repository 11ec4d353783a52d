"""The port's CUDA kernels on the card (K1 syrk_downdate, K2 gate_costs,
K3 score_lines and the one-launch wall search, K4 cov_update, K5
pair_gather, K6 syrk_gram), held against their plain versions; the
blocked Cholesky's NaN on failure without a host sync; the square-root recompression's QR branch; the
tuned, kernel-path and square-root sessions on the card against the
CPU; the live operating path: the streaming session against the
offline run on the card, and filter_health without a host sync; and the
fleet against solo sessions on the card, and a frozen submap's P owning
its storage; checkpoints taken on the card, a kill and resume bit-equal
to the uninterrupted run, and the stream's heartbeats.

Marked ``cuda``: each test skips, with its reason, where torch sees no
CUDA device, as on a CPU-only machine.  On a GPU machine (which need not
have JAX) run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor ekf_slam_tpu."""
import numpy as np
import pytest
import torch

from ekf_slam_tpu_torch.checks import (bearing_gap_ulps, gate_case,
                                       gate_tolerance, gram_banded_case,
                                       gram_compare, gram_dense_case,
                                       gram_plain_errors, pair_starts,
                                       recompress_qr_case, score_lines_case,
                                       session_on_devices, syrk_case,
                                       syrk_compare, tf32_single_pass,
                                       wall_search_case,
                                       wall_search_compare)
from ekf_slam_tpu_torch.ops import gating as G
from ekf_slam_tpu_torch.ops import kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _sym(g, D, dev, dtype):
    A = torch.randn((D, D), generator=g, device=dev, dtype=torch.float64)
    return ((A + A.T) * 0.5).to(dtype)


@pytest.mark.parametrize("D,R,dtype", [(1024, 16, torch.bfloat16),
                                       (777, 16, torch.bfloat16),
                                       (1003, 40, torch.float32),
                                       (512, 1, torch.float32)])
def test_syrk_kernel_matches_plain(dev, D, R, dtype):
    """In place, bit-symmetric, and within one rounding of the storage
    type of the plain version (f32 accumulation in both; the sums run in
    other orders)."""
    g = torch.Generator(device=dev).manual_seed(D + R)
    P = _sym(g, D, dev, dtype)
    W = (torch.randn((D, R), generator=g, device=dev) * 0.1).to(dtype)
    want = K.syrk_downdate_ref(P, W)
    before = K.syrk_downdate.launches
    got = K.syrk_downdate(P, W)
    torch.cuda.synchronize()
    assert got.data_ptr() == P.data_ptr()
    assert K.syrk_downdate.launches == before + 1
    assert torch.equal(got, got.T)
    eps = torch.finfo(dtype).eps
    err = (got.float() - want.float()).abs().max().item()
    assert err <= eps * want.float().abs().max().item()


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("D,R,dtype", [(20480, 1024, torch.bfloat16),
                                       (2048, 1000, torch.bfloat16),
                                       (1003, 1024, torch.bfloat16),
                                       (1003, 2, torch.float32),
                                       (2048, 1024, torch.float32)])
def test_syrk_kernel_wide_rank_matches_plain(dev, D, R, dtype, exact):
    """The ranks of the batched update (R = 1024 at the 10k schedule's
    D = 20480; R = 1000, not a multiple of the rank slab; a ragged D),
    and f32 at R = 2 and 1024: in place, bit-symmetric, within one bf16
    ulp of |P|max or 1e-5 of |P|max in f32 of the plain version
    (checks.syrk_compare), and bit-equal to it on integer inputs, where
    every sum is exact."""
    g = torch.Generator(device=dev).manual_seed(D + R)
    P, W = syrk_case(g, D, R, dtype, exact)
    want = K.syrk_downdate_ref(P, W)
    pmax = P.float().abs().max().item()
    ptr, before = P.data_ptr(), K.syrk_downdate.launches
    got = K.syrk_downdate(P, W)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert K.syrk_downdate.launches == before + 1
    res = syrk_compare(got, want, pmax)
    assert res["symmetric"]
    assert res["n_diff"] == 0 if exact else res["ok"], res


@pytest.mark.parametrize("D,R", [(128, 1024), (200, 48), (64, 16)])
def test_syrk_kernel_diagonal_tiles_stay_bit_symmetric(dev, D, R):
    """On a diagonal tile both (r, c) and (c, r) come from the one
    accumulator element with r ≥ c: one diagonal tile (D = 128, 64) and a
    ragged diagonal tile beside an off-diagonal pair (D = 200)."""
    g = torch.Generator(device=dev).manual_seed(D * R)
    P, W = syrk_case(g, D, R, torch.bfloat16)
    want = K.syrk_downdate_ref(P, W)
    pmax = P.float().abs().max().item()
    res = syrk_compare(K.syrk_downdate(P, W), want, pmax)
    assert res["symmetric"] and res["ok"], res


def test_score_lines_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    thresh = 0.25
    pts, valid, lines = score_lines_case(g, 64, 1000, thresh)
    before = K.score_lines.launches
    got = K.score_lines(pts, valid, lines, thresh)
    assert K.score_lines.launches == before + 1
    assert torch.equal(got, K.score_lines_ref(pts, valid, lines, thresh))


@pytest.mark.parametrize("M,K_,wrap,pad,noise", [
    (8, 3000, True, 0, 0.05), (300, 700, True, 0, 0.05),
    (8, 257, False, 0, 0.05), (70, 1000, True, 125, 0.05),
    (8, 3000, True, 0, 0.0), (8, 257, False, 61, 0.0)])
def test_gate_kernel_matches_plain(dev, M, K_, wrap, pad, noise):
    """The state-taking gate: one launch from x, P (padded by ``pad``
    dims in the padded cases, NaN wherever the gate does not read), the
    landmark table and Rs.  +inf in exactly the inactive slots; elsewhere
    within ``checks.gate_tolerance`` of the plain version: the kernel
    rounds every other operation as the plain version's PyTorch kernels
    do (built without FMA contraction) and computes the bearing itself
    with atan2f, which may round up to 2 ulp(360°) off the plain
    version's ẑ_φ.  ``noise`` = 0 re-observes landmarks exactly, so the
    bearing innovation is a few ulps and an ulp of ẑ_φ would show.
    Entries within 1e-4° of the wraps' seams are left out."""
    g = torch.Generator(device=dev).manual_seed(M + K_)
    args, keep = gate_case(g, M, K_, D=3 + 2 * K_ + pad, noise=noise)
    active = args[4]
    want = G.gate_costs_state_ref(*args, 1e6, wrap)
    tol = gate_tolerance(args, 1e6, wrap)
    zphi = torch.empty(K_, device=dev)
    before = G.gate_costs_state.launches
    got = G.gate_costs_state(*args, 1e6, wrap, zphi_out=zphi)
    torch.cuda.synchronize()
    assert G.gate_costs_state.launches == before + 1
    assert got.shape == (M, K_) and got.dtype == torch.float32
    assert torch.isinf(got[:, ~active]).all()
    assert torch.isfinite(got[:, active]).all()
    ok = keep & active[None, :]
    assert ((got - want).abs()[ok] <= tol[ok]).all()
    assert bearing_gap_ulps(zphi, G._bearing_strip(args[0], args[2])) <= 2


def test_gate_kernel_takes_bf16_p(dev):
    """A bfloat16 P (the kernel widens each element on load, as the plain
    version's strips are cast to the state's float32): within the same
    tolerance of the plain version on the same bf16 P."""
    g = torch.Generator(device=dev).manual_seed(5)
    args, keep = gate_case(g, 8, 1000)
    args = (args[0], args[1].to(torch.bfloat16)) + args[2:]
    want = G.gate_costs_state_ref(*args, 1e6, True)
    tol = gate_tolerance(args, 1e6, True)
    got = G.gate_costs_state(*args, 1e6, True)
    ok = keep & args[4][None, :]
    assert torch.isfinite(got[ok]).all()
    assert ((got - want).abs()[ok] <= tol[ok]).all()


@pytest.mark.parametrize("N,D,R", [(1003, 1003, 16), (777, 1029, 40),
                                   (64, 64, 1)])
def test_cov_update_kernel_matches_plain(dev, N, D, R):
    """In place; ragged edges on both axes; within 1e-5 of max|P| of the
    plain version (f32 sums in other orders)."""
    g = torch.Generator(device=dev).manual_seed(N + D + R)
    P = torch.randn((N, D), generator=g, device=dev)
    Kg = torch.randn((N, R), generator=g, device=dev)
    V = torch.randn((R, D), generator=g, device=dev) * 0.1
    want = K.cov_update_ref(P, Kg, V)
    before = K.cov_update.launches
    got = K.cov_update(P, Kg, V)
    torch.cuda.synchronize()
    assert got.data_ptr() == P.data_ptr()
    assert K.cov_update.launches == before + 1
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx", [torch.int32, torch.int64])
def test_pair_gather_kernel_matches_plain(dev, dtype, idx):
    """Bit-equal to index_select, with duplicate, unordered and
    last-row-pair starts, on an odd width."""
    g = torch.Generator(device=dev).manual_seed(7)
    P = torch.randn((1003, 1003), generator=g, device=dev).to(dtype)
    starts = pair_starts(P.shape[0], dev, idx)
    before = K.pair_gather.launches
    got = K.pair_gather(P, starts)
    assert K.pair_gather.launches == before + 1
    rows = (starts.long()[:, None] + torch.arange(2, device=dev)).reshape(-1)
    assert torch.equal(got, P.index_select(0, rows))


def test_pair_gather_kernel_clamps_out_of_range_starts(dev):
    """The guard: starts below 0 or above rows − 2 read the first or the
    last row pair, as the plain version's clamp does; nothing outside P is
    read (the synchronize would surface a fault)."""
    P = torch.arange(9 * 130, dtype=torch.float32, device=dev).reshape(9, 130)
    starts = torch.tensor([-3, 8, 1 << 30, 7, -1], device=dev)
    got = K.pair_gather(P, starts)
    torch.cuda.synchronize()
    assert torch.equal(got, K.pair_gather_ref(P, starts))
    assert torch.equal(got[2:4], P[7:9]) and torch.equal(got[:2], P[:2])


def test_kernel_path_session_on_card_matches_cpu(dev):
    """A small kernel-path session (fused gate, pair gather, cov_update),
    f32, the same draws on both devices: the same landmark count every
    tick, poses within 1e-3 m/deg."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="batched", pht_mode="rows",
                   rows_gather="pallas", correction="gemm", use_pallas=True)
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    outs = session_on_devices(ep, rp, 16, 512, ("cuda", "cpu"))
    assert torch.equal(outs["cuda"].n_active.cpu(), outs["cpu"].n_active)
    assert int(outs["cpu"].n_active[-1]) > 0
    assert (outs["cuda"].pose.cpu() - outs["cpu"].pose).abs().max() <= 1e-3


@pytest.mark.parametrize("which", ["syrk_f64", "syrk_strided",
                                   "score_f64", "gate_f64", "gate_strided",
                                   "gate_narrow_ld", "gate_f64_x",
                                   "cov_f64", "cov_strided", "gather_f64"])
def test_wrappers_raise_on_cuda_inputs_the_kernels_do_not_take(dev, which):
    """A CUDA tensor the kernel does not take raises; nothing falls back
    to the plain version."""
    with pytest.raises(ValueError):
        if which == "syrk_f64":
            P = torch.eye(64, device=dev, dtype=torch.float64)
            K.syrk_downdate(P, torch.zeros((64, 4), device=dev,
                                           dtype=torch.float64))
        elif which == "syrk_strided":
            P = torch.eye(128, device=dev)[::2, ::2]
            K.syrk_downdate(P, torch.zeros((64, 4), device=dev))
        elif which == "score_f64":
            K.score_lines(torch.zeros((8, 2), device=dev, dtype=torch.float64),
                          torch.ones(8, device=dev, dtype=torch.bool),
                          torch.zeros((2, 2), device=dev,
                                      dtype=torch.float64), 0.25)
        elif which.startswith("gate"):
            g = torch.Generator(device=dev).manual_seed(0)
            args = list(gate_case(g, 4, 64)[0])
            if which == "gate_f64":                 # P neither f32 nor bf16
                args[1] = args[1].double()
            elif which == "gate_strided":           # non-unit inner stride
                args[1] = torch.zeros((131, 262), device=dev)[:, ::2]
            elif which == "gate_narrow_ld":         # K > (ld − 3)/2
                args[1] = torch.zeros(131 * 131, device=dev).as_strided(
                    (131, 131), (130, 1))
            else:
                args[0] = args[0].double()
            G.gate_costs_state(*args, 1.0)
        elif which.startswith("cov"):
            P = torch.zeros((64, 64), device=dev)
            Kg, V = torch.zeros((64, 4), device=dev), torch.zeros((64, 4),
                                                                   device=dev)
            if which == "cov_f64":
                P, Kg, V = P.double(), Kg.double(), V.double()
            K.cov_update(P, Kg, V.T)
        else:
            K.pair_gather(torch.zeros((8, 8), device=dev, dtype=torch.float64),
                          torch.zeros(2, device=dev, dtype=torch.int64))


def test_session_on_card_matches_cpu(dev):
    """A small rows + syrk session, f32, the same draws on both devices:
    the same landmark count every tick, poses within 1e-3 m/deg (f32 sums
    in other orders on the two devices)."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="batched", pht_mode="rows", correction="syrk")
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    outs = session_on_devices(ep, rp, 16, 512, ("cuda", "cpu"))
    assert torch.equal(outs["cuda"].n_active.cpu(), outs["cpu"].n_active)
    assert int(outs["cpu"].n_active[-1]) > 0
    assert (outs["cuda"].pose.cpu() - outs["cpu"].pose).abs().max() <= 1e-3


# the edge shapes of K6's f32 tiling: 128x128 tiles, 32-column slabs
GRAM_EDGE = [(D, R, torch.float32) for D in (1, 127, 128, 129)
             for R in (1, 3, 31, 33)]


@pytest.mark.parametrize("D,R,dtype", [(1003, 1500, torch.float32),
                                       (517, 517, torch.float32),
                                       (130, 7, torch.float32),
                                       (517, 300, torch.bfloat16),
                                       (517, 517, torch.float64)]
                         + GRAM_EDGE)
def test_syrk_gram_kernel_matches_plain(dev, D, R, dtype):
    """K6 at ragged D and R (no tile divides them; the contraction runs
    over several slabs) and at the edge shapes of its tiles and slabs:
    within 1e-5 of max|G| in f32 (sums of R products in another order),
    1e-12 in f64; G bit-symmetric, in the accumulation dtype; one launch
    per call.  Each f32 case (3xTF32 on the tensor cores) also passes
    checks.gram_compare against the f64 Gram, with the limit from the
    plain f32 Grams on the CPU and the card; where every sum is short
    (R ≤ 33) one TF32 pass (checks.tf32_single_pass) fails it."""
    if dtype == torch.float32:
        S = gram_dense_case(D, R).to(dev)
    else:
        g = torch.Generator(device=dev).manual_seed(0)
        S = torch.randn((D, R), generator=g, device=dev,
                        dtype=torch.float64).to(dtype)
    before = K.syrk_gram.launches
    G_k = K.syrk_gram(S, use_pallas=True)
    torch.cuda.synchronize()
    assert K.syrk_gram.launches == before + 1
    G_r = K.syrk_gram_ref(S)
    assert G_k.dtype == G_r.dtype == (torch.float64 if dtype == torch.float64
                                      else torch.float32)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert ((G_k - G_r).abs().max() / G_r.abs().max()).item() <= tol
    assert torch.equal(G_k, G_k.T)
    if dtype == torch.float32:
        plain = gram_plain_errors(S)
        res = gram_compare(G_k, S, plain)
        assert res["ok"], res
        if R <= 33:
            ctrl = gram_compare(tf32_single_pass(S), S, plain)
            assert not ctrl["ok"], ctrl


def test_syrk_gram_kernel_banded_case(dev):
    """A banded S at D = R = 2048 (checks.gram_banded_case: every tile
    pair runs, no sum has more than 256 nonzero terms): K6 passes
    checks.gram_compare and is bit-symmetric; one TF32 pass fails."""
    S = gram_banded_case(torch.Generator(device=dev).manual_seed(2048),
                         2048)
    G_k = K.syrk_gram(S, use_pallas=True)
    plain = gram_plain_errors(S)
    res = gram_compare(G_k, S, plain)
    assert res["ok"], res
    assert torch.equal(G_k, G_k.T)
    ctrl = gram_compare(tf32_single_pass(S), S, plain)
    assert not ctrl["ok"], ctrl


def test_syrk_gram_plain_dispatch_launches_nothing(dev):
    """Without the flag the Gram is the plain product, as the JAX default
    runs it: no kernel launch (the recompression passes the flag)."""
    S = torch.randn((300, 40), device=dev)
    before = K.syrk_gram.launches
    G = K.syrk_gram(S)
    assert K.syrk_gram.launches == before
    assert torch.allclose(G, S @ S.T)


@pytest.mark.parametrize("which", ["float16", "strided"])
def test_syrk_gram_kernel_rejects_what_it_does_not_take(dev, which):
    S = torch.zeros((64, 32), device=dev)
    S = S.half() if which == "float16" else S[:, ::2]
    with pytest.raises(ValueError):
        K.syrk_gram(S, use_pallas=True)


def test_failed_cholesky_gives_nan_without_a_sync(dev):
    """The blocked Cholesky of a matrix that is not positive definite:
    NaN on the diagonal from the failing panel on, and no host sync (the
    error check of cholesky_ex stays off)."""
    from ekf_slam_tpu_torch.ops.blocked_chol import chol_for_state
    D = 1500
    g = torch.Generator(device=dev).manual_seed(1)
    A = torch.randn((D, D // 2), generator=g, device=dev) / D ** 0.5
    P = A @ A.T + 0.05 * torch.eye(D, device=dev)
    P[700, 700] = -1.0
    n_active = torch.tensor(748, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        L = chol_for_state(P, n_active, block=512)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    d = torch.diagonal(L).cpu()
    assert torch.isfinite(d[:512]).all() and not torch.isfinite(d).all()


def test_recompress_qr_branch_on_card_matches_cpu(dev):
    """A factor with one active row zeroed: the Cholesky of its Gram
    fails, the recompression takes its QR branch on both devices, and the
    card's factor is finite, lower triangular and within 1e-4 of the
    CPU's."""
    out = recompress_qr_case(("cuda", "cpu"))
    for where in ("cuda", "cpu"):
        assert out[where]["chol_failed"] and out[where]["qr_taken"]
    L = out["cuda"]["L"].cpu()
    assert torch.isfinite(L).all() and torch.equal(L, L.tril())
    assert (L - out["cpu"]["L"]).abs().max().item() <= 1e-4


def test_srekf_fast_session_on_card_matches_cpu(dev):
    """A small square-root session (pair gather on the card), f32, an
    8-column noise buffer so two recompressions run, the same draws on both
    devices: the same landmark count every tick, poses within 1e-3; one
    K5 launch per tick and one K6 launch per recompression."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="srekf_fast", sr_noise_buffer=8,
                   rows_gather="pallas")
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    K.pair_gather.launches = K.syrk_gram.launches = 0
    outs = session_on_devices(ep, rp, 20, 512, ("cuda", "cpu"))
    assert (K.pair_gather.launches, K.syrk_gram.launches) == (20, 2)
    assert torch.equal(outs["cuda"].n_active.cpu(), outs["cpu"].n_active)
    assert int(outs["cpu"].n_active[-1]) > 0
    assert (outs["cuda"].pose.cpu() - outs["cpu"].pose).abs().max() <= 1e-3


@pytest.mark.parametrize("B,NH", [(1024, 64), (1000, 64), (1024, 7),
                                  (1000, 7)])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("setting", ["flagship", "large_world"])
def test_wall_search_kernel_matches_plain(dev, setting, seed, B, NH):
    """The one-launch wall search against its plain version
    (checks.wall_search_compare): at the flagship settings the counts of
    every round, each round's ok and pool bit-equal; at large_world's
    (refits, splits, RMS gate) a round may part only at a decision within
    the f32 rounding band of its cut; lines and statistics within
    checks.wall_search_tolerance of the f64 plain version."""
    args, params = wall_search_case(seed, B, NH, setting, dev)
    before = K.wall_search.launches
    res = wall_search_compare(args, params, setting == "flagship")
    assert K.wall_search.launches == before + 1
    assert res["failures"] == [], res
    assert res["compared"] and res["accepted"] > 0


def test_wall_search_kernel_takes_the_largest_scan(dev):
    """B = 16,384 points at NH = 64 fill a block's shared memory (the
    layout takes 10·B + 4·P2 + 13·NH bytes): one launch, and the plain
    version's counts, ok and pools of every round."""
    args, params = wall_search_case(5, 16384, 64, "flagship", dev)
    before = K.wall_search.launches
    res = wall_search_compare(args, params, True)
    assert K.wall_search.launches == before + 1
    assert res["failures"] == [], res


@pytest.mark.parametrize("which", ["float64", "strided", "too_many_points"])
def test_wall_search_kernel_rejects_what_it_does_not_take(dev, which):
    """float64, a strided input, and more points than a block's shared
    memory holds (16,385 at NH = 64) raise; nothing falls back to the
    plain version."""
    B = 16385 if which == "too_many_points" else 256
    (pts, valid, trial, trial_ok), params = wall_search_case(
        0, B, 64, "flagship", dev)
    if which == "float64":
        pts, trial = pts.double(), trial.double()
    elif which == "strided":
        pts = torch.stack([pts, pts], 1)[:, 0]
    before = K.wall_search.launches
    with pytest.raises(ValueError):
        K.wall_search(pts, valid, trial, trial_ok, params)
    assert K.wall_search.launches == before


def test_session_launches_one_wall_search_per_tick(dev):
    """A small session on the card runs the extractor's rounds as one
    wall_search launch a tick, and the scoring kernel not at all."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="batched", pht_mode="rows", correction="syrk")
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    K.wall_search.launches = K.score_lines.launches = 0
    outs = session_on_devices(ep, rp, 8, 512, ("cuda",))
    assert (K.wall_search.launches, K.score_lines.launches) == (8, 0)
    assert int(outs["cuda"].n_active[-1]) > 0


# tests/test_sim_session.py:29-32's extractor (the one-seed search), f32
SIM_RANSAC = dict(line_consensus=60, bearing_window_deg=15.0,
                  wall_search_timeout=4, table_capacity=32, promote_count=5,
                  ref_compat=False)


@pytest.mark.parametrize("algorithm", ["EKF_SLAM_UC", "EKF_SLAM"])
def test_sequential_session_on_card_matches_cpu(dev, algorithm):
    """The JAX package's default session, the sequential filter with the
    algorithm's preset as constructed (capacity 128, ref_compat=True, f32)
    and the one-seed wall search, 16 ticks with the same draws on both
    devices: the same landmark count every tick, poses within 1e-3, and
    no kernel launched (the path has none)."""
    from ekf_slam_tpu_torch import ALGORITHMS, RansacParams
    ep, rp = ALGORITHMS[algorithm](), RansacParams(**SIM_RANSAC)
    counted = (K.syrk_downdate, G.gate_costs_state, K.score_lines,
               K.wall_search, K.cov_update, K.pair_gather, K.syrk_gram)
    for fn in counted:
        fn.launches = 0
    outs = session_on_devices(ep, rp, 16, 512, ("cuda", "cpu"))
    assert [fn.launches for fn in counted] == [0] * len(counted)
    assert torch.equal(outs["cuda"].n_active.cpu(), outs["cpu"].n_active)
    assert int(outs["cpu"].n_active[-1]) > 0
    assert (outs["cuda"].pose.cpu() - outs["cpu"].pose).abs().max() <= 1e-3


def test_srekf_session_on_card_matches_cpu(dev):
    """The QR square-root session (update_mode='srekf'), capacity 64,
    f32, 16 ticks with the same draws on both devices: the same landmark
    count every tick, poses within 1e-3."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="srekf")
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    outs = session_on_devices(ep, rp, 16, 512, ("cuda", "cpu"))
    assert torch.equal(outs["cuda"].n_active.cpu(), outs["cpu"].n_active)
    assert int(outs["cpu"].n_active[-1]) > 0
    assert (outs["cuda"].pose.cpu() - outs["cpu"].pose).abs().max() <= 1e-3


def test_masked_update_on_card_leaves_the_state_bit_unchanged(dev):
    """On the card a masked-off update of an empty slot under a zero R (a
    singular Φ) leaves x and P bit for bit as they were, and a slot past
    the state is clamped (no illegal access)."""
    from ekf_slam_tpu_torch import EKFParams
    from ekf_slam_tpu_torch.models import ekf
    from ekf_slam_tpu_torch.state import init_state
    p = EKFParams(capacity=6)
    st = init_state(p, device=dev)
    x0, P0 = st.x.clone(), st.P.clone()
    z = torch.zeros(3, device=dev)
    R = torch.zeros((2, 2), device=dev)
    got = ekf.update(st, z, 3, R, p, mask=torch.zeros((), dtype=torch.bool,
                                                      device=dev))
    far = ekf.update(init_state(p, device=dev), torch.tensor(
        [2.0, 50.0, 1.0], device=dev), 40, torch.eye(2, device=dev), p)
    torch.cuda.synchronize()
    assert torch.equal(got.x.view(torch.int32), x0.view(torch.int32))
    assert torch.equal(got.P.view(torch.int32), P0.view(torch.int32))
    assert bool(torch.isfinite(far.P).all())


def _robust_params(**ekw):
    from ekf_slam_tpu_torch import EKFParams, RansacParams
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="batched", pht_mode="rows", correction="syrk",
                   **ekw)
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    return ep, rp


def test_guard_on_card_matches_cpu(dev):
    """The guard (3 cm) on a session fed odometry corrupted once on the
    CPU (ticks 10 and 20 moved 0.71 m by corrupt_odometry with handed
    draws), card against CPU: the same ticks rejected (some), the same
    landmark count every tick, poses within 1e-3."""
    from ekf_slam_tpu_torch.checks import decisions_differ
    from ekf_slam_tpu_torch.utils.faults import corrupt_odometry
    T = 24

    def corrupted(traj):
        hit = torch.zeros(T, dtype=torch.bool)
        hit[[10, 20]] = True
        noise = torch.zeros(T, 3)
        noise[10] = torch.tensor([0.5, -0.5, 0.0])
        noise[20] = torch.tensor([-0.5, 0.5, 0.0])
        return corrupt_odometry(traj.odom, None, 0.0, magnitude=1.0,
                                hit=hit, noise=noise), traj.ranges
    ep, rp = _robust_params(guard_max_jump=0.03)
    outs = session_on_devices(ep, rp, T, 512, ("cuda", "cpu"),
                              edit=corrupted)
    assert not any(decisions_differ(outs["cuda"], outs["cpu"]).values())
    assert not bool(outs["cpu"].guard_ok.all())
    assert torch.equal(outs["cuda"].n_active.cpu(), outs["cpu"].n_active)
    assert (outs["cuda"].pose.cpu() - outs["cpu"].pose).abs().max() <= 1e-3


def test_guarded_on_card_restores_nan_bit_for_bit(dev):
    """``guarded`` on CUDA tensors: a NaN measurement is rejected and P
    (bf16 and f32) is restored in place, bit for bit, from the snapshot;
    an accepted one leaves P as the measurement made it."""
    from ekf_slam_tpu_torch import EKFParams
    from ekf_slam_tpu_torch.state import init_state
    from ekf_slam_tpu_torch.utils.faults import guarded
    for cov, view in ((None, torch.int32), (torch.bfloat16, torch.int16)):
        st = init_state(EKFParams(capacity=300, cov_dtype=cov), device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        A = torch.randn(st.P.shape, generator=g, device=dev)
        snap = (A @ A.T * 1e-3).to(st.P.dtype)
        before = st._replace(P=snap)
        bad = st._replace(P=torch.full_like(st.P, float("nan")))
        ptr = bad.P.data_ptr()
        out, v = guarded(before, bad, 1.0)
        torch.cuda.synchronize()
        assert not bool(v.ok) and out.P.data_ptr() == ptr
        assert torch.equal(out.P.view(view), snap.view(view))
        good_P = snap * 0.5
        out, v = guarded(before, st._replace(P=good_P.clone()), 1.0)
        assert bool(v.ok) and torch.equal(out.P.view(view),
                                          good_P.view(view))


@pytest.mark.parametrize("cov", [None, torch.bfloat16])
def test_eviction_on_card_matches_cpu(dev, cov):
    """Dense eviction on the card (f32 and bf16 P) equals the CPU's bit
    for bit and the gather of the kept rows and columns; the factored
    eviction launches K6 once and its factor's Gram matches the CPU's
    within 1e-5 of its largest entry."""
    from ekf_slam_tpu_torch.checks import bench_params, evict_case
    from ekf_slam_tpu_torch.models import maintenance as MT
    from ekf_slam_tpu_torch.models.srekf import factor_from_state
    ep = bench_params(400, cov_dtype=cov,
                      correction="gemm" if cov is None else "syrk")
    outs = {}
    for where in ("cuda", "cpu"):
        st = evict_case(ep, seed=3, device=where)
        tr = MT._slot_traces(st, False).float()
        drop = (MT.duplicate_mask(st, 1.0)
                | MT.prune_by_uncertainty(st, float(tr.quantile(0.75))))
        outs[where] = (MT.evict_landmarks(st, drop, ep), drop)
    (gc, dc), (gh, dh) = outs["cuda"], outs["cpu"]
    assert torch.equal(dc.cpu(), dh) and 0 < int(dh.sum()) < 400
    for f in gc._fields:
        assert torch.equal(getattr(gc, f).cpu(), getattr(gh, f)), f
    if cov is None:
        st = evict_case(ep, seed=3, device=dev)
        sr = factor_from_state(st)
        K.syrk_gram.launches = 0
        out = MT.evict_landmarks_factored(sr, dc, ep)
        torch.cuda.synchronize()
        assert K.syrk_gram.launches == 1
        S = out.P.cpu().double()
        want = gh.P.double()
        assert (S @ S.T - want).abs().max() <= 1e-5 * want.abs().max()


def test_icp_on_card_ignores_tf32(dev):
    """ICP on the card: the same pose, RMSE and inlier count with
    ``allow_tf32`` on and off (no matrix product touches the points), and
    within 1e-4 of the CPU's."""
    from ekf_slam_tpu_torch.ops.icp import icp
    g = torch.Generator().manual_seed(2)
    src = torch.rand((1024, 2), generator=g) * 8 - 4
    th = torch.tensor(0.1)
    R = torch.stack([torch.stack([th.cos(), -th.sin()]),
                     torch.stack([th.sin(), th.cos()])])
    dst = src @ R.T + torch.tensor([0.2, -0.1])
    ok = torch.rand(1024, generator=g) > 0.1
    host = icp(src, ok, dst, ok, iters=15, max_pair_dist=0.4)
    res = []
    for tf32 in (True, False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        res.append(icp(src.to(dev), ok.to(dev), dst.to(dev), ok.to(dev),
                       iters=15, max_pair_dist=0.4))
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = res
    assert torch.equal(a.pose, b.pose) and torch.equal(a.rmse, b.rmse)
    assert int(a.n_inliers) == int(b.n_inliers) == int(host.n_inliers)
    assert (a.pose.cpu() - host.pose).abs().max() <= 1e-4


def test_noise_floor_on_card_does_not_sync(dev):
    """The measurement-noise floor diag(rc0², rc1²) of noise_model
    'constant' and 'fit' is made on the card without a host-to-device
    copy (an assignment of a Python number to a CUDA element syncs), with
    the values the CPU makes."""
    from ekf_slam_tpu_torch import EKFParams
    from ekf_slam_tpu_torch.models import ekf
    p = EKFParams(rc=(0.05, 0.3), noise_model="fit", ref_compat=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        R = ekf._rc_floor(p, dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(R.cpu(), ekf._rc_floor(p, "cpu"))
    assert R[0, 0].item() == torch.tensor(0.05 ** 2).item()


def test_stream_on_card_matches_run(dev):
    """A short stream at small capacity on the card (rows + SYRK, 20 ticks
    in windows of 8, so the flush runs a remainder window) equals the
    offline run on the card bit for bit, fed the same draws; its outputs
    are numpy, read through pinned copies and one event a window; it
    launches one SYRK and one wall_search a tick."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams, SlamSession
    from ekf_slam_tpu_torch.checks import session_inputs
    from ekf_slam_tpu_torch.io.stream import StreamingSlamSession
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="batched", pht_mode="rows", correction="syrk")
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    T = 20
    odom, ranges, beams, draws = session_inputs(rp, T, 512)
    draws = [(u.to(dev), s.to(dev)) for u, s in draws]
    _, off = SlamSession(ekf_params=ep, ransac_params=rp).run(
        odom, ranges, beams, draws=draws)
    stream = StreamingSlamSession(SlamSession(ekf_params=ep, ransac_params=rp),
                                  n_beams=512, beam_angles=beams, window=8,
                                  first_odom=odom[0].numpy())
    K.syrk_downdate.launches = K.wall_search.launches = 0
    got = []
    for i in range(T):
        got.extend(stream.push(odom[i].numpy(), ranges[i].numpy(),
                               draws=draws[i]))
    got.extend(stream.flush())
    assert (K.syrk_downdate.launches, K.wall_search.launches) == (T, T)
    assert len(got) == T and not stream._pending
    assert isinstance(got[0].pose, np.ndarray)
    for f in ("pose", "n_active", "n_obs", "u"):
        assert np.array_equal(np.stack([getattr(o, f) for o in got]),
                              getattr(off, f).cpu().numpy()), f
    assert int(off.n_active[-1]) > 0


def test_filter_health_on_card_does_not_sync(dev):
    """filter_health on a padded bf16 P on the card reads nothing back to
    the host, and gives the CPU's finite, min_diag and trace (asym and
    trace within a bf16 rounding: the sums run in other orders)."""
    from ekf_slam_tpu_torch.state import FilterState
    from ekf_slam_tpu_torch.utils.metrics import filter_health
    g = torch.Generator().manual_seed(4)
    D, na = 512, 100
    A = torch.randn((203, 203), generator=g, dtype=torch.float64) * 0.1
    P = torch.zeros((D, D), dtype=torch.float64)
    P[:203, :203] = A @ A.T + 0.05 * torch.eye(203)
    P[203:, 203:] = -torch.eye(D - 203)
    st = FilterState(x=torch.randn(D, generator=g), P=P.to(torch.bfloat16),
                     sig=torch.zeros(256), active=torch.arange(256) < na,
                     n_active=torch.tensor(na, dtype=torch.int32))
    on = FilterState(*(v.to(dev) for v in st))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = filter_health(on)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = filter_health(st)
    assert bool(h.finite) and bool(want.finite)
    assert h.min_diag.item() == want.min_diag.item() > 0
    for f in ("asym", "trace"):
        a, b = getattr(h, f).float().item(), getattr(want, f).float().item()
        assert abs(a - b) <= 2.0 ** -7 * max(abs(b), 1e-30), f


def _fleet_inputs(N, T, B, dev):
    """N robots' streams (examples/fleet_mapping.py's circles, simulated on
    the CPU from seeds 0..N-1), stacked [T,N,...] on the card."""
    from ekf_slam_tpu_torch.config import SimConfig
    from ekf_slam_tpu_torch.sim import world as W
    trajs = [W.simulate(W.rectangle_room(4.0, 3.0, device="cpu"),
                        W.circle_controls(T, 0.04 + 0.01 * i, 2.0 + i,
                                          device="cpu"),
                        SimConfig(n_beams=B, max_range=12.0),
                        torch.Generator().manual_seed(i))
             for i in range(N)]
    return (torch.stack([t.odom for t in trajs], 1).to(dev),
            torch.stack([t.ranges for t in trajs], 1).to(dev),
            trajs[0].beam_angles.to(dev))


def test_fleet_on_card_matches_solo_sessions(dev):
    """A fleet of three at small capacity on the card (rows + SYRK, bf16
    P) equals solo sessions of seeds seed + i bit for bit (poses, n_active,
    P), launches one SYRK and one wall_search per robot a fleet tick, and
    never copies P back into its slice."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams, SlamSession
    from ekf_slam_tpu_torch.parallel.multi import FleetSlamSession
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="batched", pht_mode="rows", correction="syrk",
                   cov_dtype=torch.bfloat16)
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    N, T = 3, 16
    odom, ranges, beams = _fleet_inputs(N, T, 512, dev)
    fleet = FleetSlamSession(n_sessions=N, ekf_params=ep, ransac_params=rp,
                             seed=100)
    K.syrk_downdate.launches = K.wall_search.launches = 0
    carry, out = fleet.run(odom, ranges, beams)
    assert (K.syrk_downdate.launches, K.wall_search.launches) == (N * T,
                                                                  N * T)
    P0 = carry.filt.P[0]
    assert fleet.copied_bytes < P0.numel() * P0.element_size()
    for i in range(N):
        c_, o_ = SlamSession(ekf_params=ep, ransac_params=rp,
                             seed=100 + i).run(odom[:, i], ranges[:, i],
                                               beams)
        assert torch.equal(out.pose[:, i], o_.pose)
        assert torch.equal(out.n_active[:, i], o_.n_active)
        assert torch.equal(carry.filt.P[i], c_.filt.P)
    assert int(out.n_active[-1].min()) > 0


def test_frozen_submap_on_card_does_not_alias_the_next_segment(dev):
    """SubmapSlam on the card with the fault guard on: every frozen
    submap's P has storage of its own (not the next segment's P, not the
    guard's snapshot), and stays as it was while later segments run."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams
    from ekf_slam_tpu_torch.parallel.submaps import SubmapSlam
    ep = EKFParams(capacity=64, max_obs=8, ref_compat=False,
                   update_mode="batched", guard_max_jump=1.0)
    rp = RansacParams(line_consensus=30, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=32)
    odom, ranges, beams = _fleet_inputs(1, 60, 512, dev)
    sm = SubmapSlam(ekf_params=ep, ransac_params=rp, seed=2,
                    ticks_per_submap=20)
    sm.run(odom[:, 0], ranges[:, 0], beams)
    frozen = [s.carry.filt.P.clone() for s in sm.submaps]
    sm.run(odom[:40, 0], ranges[:40, 0], beams)
    ptrs = [s.carry.filt.P.untyped_storage().data_ptr() for s in sm.submaps]
    assert len(sm.submaps) == 5 and len(set(ptrs)) == 5
    assert sm.session._snap.untyped_storage().data_ptr() not in ptrs
    for s, want in zip(sm.submaps[:3], frozen):
        assert torch.equal(s.carry.filt.P, want)
    assert all(s.n_landmarks > 0 for s in sm.submaps)


def _recovery_session(seed=1):
    """13a's configuration at capacity 256: rows + SYRK, bf16 P, the
    64-hypothesis extractor (the session's generator draws)."""
    from ekf_slam_tpu_torch import EKFParams, RansacParams, SlamSession
    ep = EKFParams(capacity=256, max_obs=8, ref_compat=False,
                   update_mode="batched", pht_mode="rows", correction="syrk",
                   cov_dtype=torch.bfloat16)
    rp = RansacParams(line_consensus=60, bearing_window_deg=15.0,
                      wall_search_timeout=4, table_capacity=64,
                      promote_count=5, ref_compat=False, n_hypotheses=64)
    return SlamSession(ekf_params=ep, ransac_params=rp, seed=seed)


def test_checkpoint_from_card_restores_onto_cpu(dev, tmp_path):
    """A carry saved on the card loads onto a CPU template bit for bit
    (no device identity in the file); the card generator's state cannot
    restore a CPU generator: that raises ValueError."""
    from ekf_slam_tpu_torch import SlamSession
    from ekf_slam_tpu_torch.checks import session_inputs
    from ekf_slam_tpu_torch.utils import checkpointing as ckpt
    sess = _recovery_session()
    odom, ranges, beams, _ = session_inputs(sess.ransac_params, 8, 1024)
    carry, _ = sess.run(odom, ranges, beams)
    path = ckpt.save_checkpoint(str(tmp_path), carry, step=8,
                                generator=sess.generator)
    cpu = SlamSession(ekf_params=sess.ekf_params,
                      ransac_params=sess.ransac_params, seed=1, device="cpu")
    tmpl = cpu.init_carry(first_odom=odom[0])
    got = ckpt.load_checkpoint(path, tmpl)
    for a, b in zip(ckpt.carry_leaves(got), ckpt.carry_leaves(carry)):
        if isinstance(b, torch.Tensor):
            assert a.device.type == "cpu" and torch.equal(a, b.cpu())
        else:
            assert a == b
    with pytest.raises(ValueError, match="cuda generator"):
        ckpt.load_checkpoint(path, tmpl, generator=cpu.generator)


def test_crash_resume_on_card_is_bit_continuous(dev, tmp_path):
    """13a at capacity 256: killed at tick 40 with checkpoints every 16,
    resumed in a fresh session from 32, the end state, the generator and
    the replayed poses bit-equal to an uninterrupted run on the card; one
    SYRK and one wall_search launch a tick of the resume."""
    from ekf_slam_tpu_torch.checks import session_inputs
    from ekf_slam_tpu_torch.utils import checkpointing as ckpt
    from ekf_slam_tpu_torch.utils import recovery
    T = 64
    odom, ranges, beams, _ = session_inputs(_recovery_session().ransac_params,
                                            T, 1024)
    with pytest.raises(recovery.HostCrash):
        recovery.run_with_checkpoints(_recovery_session(), odom, ranges,
                                      beams, str(tmp_path), every=16,
                                      die_at_tick=40)
    fresh = _recovery_session()
    K.syrk_downdate.launches = K.wall_search.launches = 0
    final, tail, start = recovery.resume_latest(fresh, odom, ranges, beams,
                                                str(tmp_path), every=16)
    assert start == 32
    assert (K.syrk_downdate.launches, K.wall_search.launches) == (32, 32)
    ref = _recovery_session()
    want, out = ref.run(odom, ranges, beams)
    for a, b in zip(ckpt.carry_leaves(final), ckpt.carry_leaves(want)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert torch.equal(fresh.generator.get_state(), ref.generator.get_state())
    assert torch.equal(tail, out.pose[32:])
    assert int(want.filt.n_active) > 0


def test_stream_heartbeat_on_card_holds_its_labelled_carry(dev, tmp_path):
    """The stream on the card (window 8, two windows in flight, a
    heartbeat every window, so pinned buffers are in use by up to three
    unwritten heartbeats): each heartbeat equals the offline run's carry
    after exactly its labelled tick, bit for bit."""
    import os
    from ekf_slam_tpu_torch.checks import session_inputs
    from ekf_slam_tpu_torch.io.stream import StreamingSlamSession
    from ekf_slam_tpu_torch.utils import checkpointing as ckpt
    T = 40
    odom, ranges, beams, _ = session_inputs(_recovery_session().ransac_params,
                                            T, 1024)
    stream = StreamingSlamSession(_recovery_session(), n_beams=1024,
                                  beam_angles=beams, window=8, max_pending=2,
                                  checkpoint_dir=str(tmp_path),
                                  checkpoint_every=1,
                                  first_odom=odom[0].numpy())
    for i in range(T):
        stream.push(odom[i].numpy(), ranges[i].numpy())
    stream.flush()
    assert sorted(os.listdir(tmp_path)) == [f"step_{k:08d}"
                                            for k in range(8, T + 1, 8)]
    sess = _recovery_session()
    carry = sess.init_carry(first_odom=odom[0])
    tmpl = _recovery_session()
    for i in range(T):
        carry, _ = sess.step(carry, odom[i], ranges[i], beams)
        if (i + 1) % 8 == 0:
            got = ckpt.load_checkpoint(
                os.path.join(str(tmp_path), f"step_{i + 1:08d}"),
                tmpl.init_carry(first_odom=odom[0]),
                generator=tmpl.generator)
            for a, b in zip(ckpt.carry_leaves(got),
                            ckpt.carry_leaves(carry)):
                assert (a is None and b is None) or torch.equal(a, b), i
            assert torch.equal(tmpl.generator.get_state(),
                               sess.generator.get_state())
