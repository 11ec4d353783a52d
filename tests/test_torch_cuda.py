"""The port's CUDA kernels on the card, held against their plain versions.

Marked ``cuda``: each test skips, with its reason, where torch sees no
CUDA device, as on a CPU-only machine.  On a GPU machine (which need not
have JAX) run them without the suite's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor ekf_slam_tpu."""
import pytest
import torch

from ekf_slam_tpu_torch.checks import score_lines_case, session_on_devices
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


def test_score_lines_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    thresh = 0.25
    pts, valid, lines = score_lines_case(g, 64, 1000, thresh)
    before = K.score_lines.launches
    got = K.score_lines(pts, valid, lines, thresh)
    assert K.score_lines.launches == before + 1
    assert torch.equal(got, K.score_lines_ref(pts, valid, lines, thresh))


@pytest.mark.parametrize("which", ["syrk_f64", "syrk_strided",
                                   "score_f64"])
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
        else:
            K.score_lines(torch.zeros((8, 2), device=dev, dtype=torch.float64),
                          torch.ones(8, device=dev, dtype=torch.bool),
                          torch.zeros((2, 2), device=dev,
                                      dtype=torch.float64), 0.25)


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
