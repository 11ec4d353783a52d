"""The JAX package's batched-update benchmark (bench.py) as the port runs
it on the card (chip_smoke.py phase 6c), scaled down and held against
ekf_slam_tpu on the CPU: ``checks.full_measurements`` bit-equal to
``bench.make_measurements``, ``checks.full_state`` against
``bench.make_full_state``, and ``update_chunked`` and one gate + update
batch at the large-map schedule (rows P·Hᵀ, bf16 P, the SYRK correction)
at K = 200, M = 256, G = 2: a rank-256 downdate a chunk."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from ekf_slam_tpu.models import batched as jb
from ekf_slam_tpu.ops.association import gate_batch as j_gate_batch
from ekf_slam_tpu.state import FilterState as JState
from ekf_slam_tpu_torch.checks import (bench_batch, bench_params, full_state,
                                       full_measurements, record_syrk,
                                       syrk_gap_bound)
from ekf_slam_tpu_torch.models import batched as tb

from torch_parity_helpers import max_rel, n, port

K, M, G = 200, 256, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _jparams(**kw):
    """bench.py's parameters at K, on the large-map schedule scaled down
    (its 10k schedule: rows, bf16 P, syrk; M/G = 128 observations a
    chunk)."""
    return dataclasses.replace(
        bench._params(K, G, jnp.bfloat16), pht_mode="rows",
        correction="syrk", **kw)


def _jstate(st) -> JState:
    """The port's state as the JAX package's (bf16 P carried exactly)."""
    return JState(x=jnp.asarray(n(st.x), jnp.float32),
                  P=jnp.asarray(n(st.P), jnp.float32).astype(jnp.bfloat16),
                  sig=jnp.asarray(n(st.sig), jnp.float32),
                  active=jnp.asarray(n(st.active)),
                  n_active=jnp.asarray(n(st.n_active)))


def test_bench_params_are_the_benchmarks():
    """At 10k: M = 4096 in 8 chunks, rows, bf16 P, SYRK, as bench.py's
    _defaults and _params give them."""
    p = bench_params(10000)
    want = bench._params(10000, 8, jnp.bfloat16)
    assert (p.update_chunks, p.pht_mode, p.cov_dtype, p.correction) == (
        8, "rows", torch.bfloat16, "syrk")
    assert (p.association, p.s_cost, p.s_thresh, p.ref_compat, p.dtype) == (
        want.association, want.s_cost, want.s_thresh, want.ref_compat,
        torch.float32)


def test_full_measurements_bit_equal_to_bench():
    js = bench.make_full_state(_jparams(), K)
    want = bench.make_measurements(js, K, 3 * M, seed=1)
    got = full_measurements(torch.from_numpy(np.array(js.x)), K, 3 * M,
                            seed=1)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


def test_full_state_matches_bench():
    """x, sig, active and n_active equal the benchmark's state; D padded
    to a multiple of 512 with zeros; P symmetric to the bit, bf16, and
    positive definite on the 3 + 2K dims."""
    p = _jparams()
    js = bench.make_full_state(p, K)
    st = full_state(port(p), K, seed=0, device="cpu")
    D = 3 + 2 * K
    assert st.x.shape == (512,) and st.P.shape == (512, 512)
    np.testing.assert_array_equal(n(st.x)[:D], n(js.x))
    assert not n(st.x)[D:].any()
    np.testing.assert_array_equal(n(st.sig), n(js.sig))
    np.testing.assert_array_equal(n(st.active), n(js.active))
    assert int(st.n_active) == int(js.n_active) == K
    assert st.P.dtype == torch.bfloat16
    assert torch.equal(st.P, st.P.T)
    assert not n(st.P)[D:].any() and not n(st.P)[:, D:].any()
    assert np.linalg.eigvalsh(n(st.P)[:D, :D]).min() > 0.04


def test_full_state_refuses_a_k_other_than_capacity():
    with pytest.raises(ValueError):
        full_state(port(_jparams()), K - 1, device="cpu")


def _case(noise=None):
    p = _jparams()
    st = full_state(port(p), K, seed=0, device="cpu")
    zs = full_measurements(st.x, K, M, seed=1, noise=noise).astype(
        np.float32)
    return p, st, zs


def _copy(st):
    return type(st)(*(v.clone() for v in st))


def _hold_chunks(st, zs, slots, Rs, valid, p):
    """Each chunk of update_chunked from the port's own state before it:
    the port's update_batch against the JAX package's on the same state,
    P element by element.  Both round W to bf16 from f32 values summed in
    other orders, so an element of the JAX W lies at most one bf16 ulp
    (≤ 2⁻⁷ of its size) from the port's, and W·Wᵀ moves by at most
    (1 + 2⁻⁷)²·2⁻⁶·|W|·|W|ᵀ: that is added to checks.syrk_gap_bound (the
    bf16 roundings and the f32 sums' errors) with the port's W.  Returns
    the port's state after the last chunk."""
    ju = jax.jit(jb.update_batch, static_argnums=5)
    m = -(-len(zs) // p.update_chunks)
    for g0 in range(0, len(zs), m):
        sl = slice(g0, g0 + m)
        args = tuple(np.asarray(a)[sl] for a in (zs, slots, Rs, valid))
        want = ju(_jstate(st), *map(jnp.asarray, args), p)
        with record_syrk() as rec:
            st = tb.update_batch(_copy(st), *map(torch.from_numpy, args),
                                 port(p))
        (P_in, W), = rec
        ref = torch.from_numpy(np.array(want.P.astype(jnp.float32))).to(
            torch.bfloat16)
        Wa = W.double().abs()
        bound = (syrk_gap_bound(st.P, ref, P_in, W, W)
                 + (1 + 2 ** -7) ** 2 * 2 ** -6 * (Wa @ Wa.T))
        gap = (st.P.double() - ref.double()).abs()
        assert int((gap > bound).sum()) == 0, (g0, (gap / bound).max())
    return st


def test_update_chunked_at_the_large_map_schedule_matches():
    """Two chunks of 128 observations, each a rank-256 SYRK downdate of a
    bf16 P, against the JAX update_chunked on the same state and
    measurements (slots as drawn; noise of 0.1 m and 0.1° so the update
    moves x): bf16 P with f32 compute in both packages, whose sums run in
    other orders.  P element by element, chunk by chunk (_hold_chunks;
    the port's update_chunked is those chunks to the bit); x within 1e-5
    (the bf16-storage tolerance of test_torch_batched.py), well under what
    the update moved it by."""
    p, st, zs = _case(noise=(0.1, 0.1))
    rc0, rc1 = p.rc
    Rs = np.stack([np.diag([z[0] * rc0, z[1] * rc1]) for z in zs]).astype(
        np.float32)
    slots = (zs[:, 2] - 1).astype(np.int32)
    valid = np.ones(M, bool)
    js = _jstate(st)
    args = (zs, slots, Rs, valid)
    want = jax.jit(jb.update_chunked, static_argnums=5)(
        js, *map(jnp.asarray, args), p)
    chunks = _hold_chunks(_copy(st), *args, p)
    x_in = st.x.clone()
    got = tb.update_chunked(st, *map(torch.from_numpy, args), port(p))
    assert got.P.dtype == torch.bfloat16
    assert torch.equal(got.P, chunks.P) and torch.equal(got.x, chunks.x)
    assert max_rel(got.x, want.x) <= 1e-5
    moved = float((got.x - x_in).abs().max())
    assert moved >= 10 * 1e-5 * np.abs(n(want.x)).max()
    assert torch.equal(got.P, got.P.T)


def test_bench_batch_matches_the_benchmarks_batch():
    """One benchmark batch (bench.py:228-241): the JAX gate associates
    every measurement with the slot it was made from, and so does the
    port's; the updated state held as above, P chunk by chunk."""
    p, st, zs = _case()
    js = _jstate(st)
    rc0, rc1 = p.rc
    zj = jnp.asarray(zs)
    Rj = jax.vmap(lambda z: jnp.diag(jnp.stack([z[0] * rc0, z[1] * rc1])))(
        zj).astype(p.dtype)
    is_new, slots_j = j_gate_batch(js, zj, Rj, p, use_pallas=False)
    want = jax.jit(jb.update_chunked, static_argnums=5)(
        js, zj, slots_j, Rj, ~is_new, p)
    chunks = _hold_chunks(_copy(st), zs, np.array(slots_j), np.array(Rj),
                          np.array(~is_new), p)
    got, slots = bench_batch(st, torch.from_numpy(zs), port(p))
    np.testing.assert_array_equal(n(slots), n(slots_j))
    np.testing.assert_array_equal(n(slots), zs[:, 2] - 1)
    assert torch.equal(got.P, chunks.P) and torch.equal(got.x, chunks.x)
    assert max_rel(got.x, want.x) <= 1e-5
    assert torch.equal(got.P, got.P.T)
    assert int(got.n_active) == K
