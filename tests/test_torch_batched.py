"""ekf_slam_tpu_torch batched update (update_batch, update_chunked,
measure_batched) against ekf_slam_tpu: the gemm and syrk corrections in
dense and rows modes on a padded state at float64 (x and P within 1e-10
relative), the bf16-storage forms within a stated tolerance, and the
kernel path (use_pallas, rows_gather='pallas', gemm correction) on an
unpadded state at float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.models import batched as jb
from ekf_slam_tpu.ops.observations import ObsBatch as JObs
from ekf_slam_tpu_torch.models import batched as tb
from ekf_slam_tpu_torch.ops.observations import ObsBatch as TObs

from torch_parity_helpers import (jax_state, max_rel, n, port, random_state,
                                  t, torch_state)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _obs(rng, js, M=6, n_new=1):
    """M observations of active landmarks (last ``n_new`` of unseen ones);
    slot M-2 is invalid."""
    x = np.asarray(js.x)
    na = int(js.n_active)
    slots = rng.permutation(na)[:M].astype(np.int32)
    zs = np.zeros((M, 3))
    locs = np.zeros((M, 2))
    for m, k in enumerate(slots):
        lm = x[3 + 2 * k:5 + 2 * k] + rng.normal(0, 0.05, 2)
        if m >= M - n_new:
            lm = rng.uniform(-5, 5, 2)
        d = lm - x[:2]
        zs[m] = [np.hypot(*d),
                 (np.degrees(np.arctan2(d[1], d[0])) - x[2]) % 360.0,
                 float(np.asarray(js.sig)[k]) if m < M - n_new else 50 + m]
        locs[m] = lm
    valid = np.ones(M, bool)
    valid[M - 2] = False
    Rs = np.stack([np.diag([0.02, 2.0])] * M)
    return zs, slots, Rs, valid, locs


def _params(**kw):
    kw.setdefault("capacity", 12)
    kw.setdefault("dtype", jnp.float64)
    kw.setdefault("ref_compat", False)
    kw.setdefault("update_mode", "batched")
    return jc.EKFParams(**kw)


@pytest.mark.parametrize("pht_mode", ["dense", "rows"])
@pytest.mark.parametrize("correction", ["gemm", "syrk"])
@pytest.mark.parametrize("symmetrize", [False, True])
def test_update_batch_matches(rng, pht_mode, correction, symmetrize):
    p = _params(pht_mode=pht_mode, correction=correction,
                symmetrize=symmetrize)
    js = jax_state(random_state(rng, pad=128))        # D = 27 → 128
    zs, slots, Rs, valid, _ = _obs(rng, js, n_new=0)
    args = (zs, slots, Rs, valid)
    want = jax.jit(jb.update_batch, static_argnums=5)(
        js, *map(jnp.asarray, args), p)
    got = tb.update_batch(torch_state(js), *map(torch.from_numpy, args),
                          port(p))
    assert max_rel(got.x, want.x) <= 1e-10
    assert max_rel(got.P, want.P) <= 1e-10


@pytest.mark.parametrize("ref_compat", [True, False])
def test_update_batch_joseph_matches(rng, ref_compat):
    p = _params(joseph=True, ref_compat=ref_compat)
    js = jax_state(random_state(rng))
    args = _obs(rng, js, n_new=0)[:4]
    want = jax.jit(jb.update_batch, static_argnums=5)(
        js, *map(jnp.asarray, args), p)
    got = tb.update_batch(torch_state(js), *map(torch.from_numpy, args),
                          port(p))
    assert max_rel(got.x, want.x) <= 1e-10
    assert max_rel(got.P, want.P) <= 1e-10


@pytest.mark.parametrize("pht_mode,correction", [("rows", "syrk"),
                                                 ("dense", "gemm")])
def test_update_batch_bf16_storage(rng, pht_mode, correction):
    """bf16 P with f32 compute: the large products take bf16 operands and
    accumulate in f32 in both packages, but XLA and PyTorch sum in other
    orders, so an element of the new P may round to the neighbouring bf16
    value: P within one bf16 ulp (2⁻⁸) of max|P|, x within 1e-5."""
    p = _params(pht_mode=pht_mode, correction=correction,
                dtype=jnp.float32, cov_dtype=jnp.bfloat16)
    arrs = random_state(rng, pad=128, dtype=np.float32)
    js = jax_state(arrs, cov_dtype=jnp.bfloat16)
    zs, slots, Rs, valid, _ = _obs(rng, js, n_new=0)
    args = (zs.astype(np.float32), slots, Rs.astype(np.float32), valid)
    want = jax.jit(jb.update_batch, static_argnums=5)(
        js, *map(jnp.asarray, args), p)
    got = tb.update_batch(torch_state(js), *map(torch.from_numpy, args),
                          port(p))
    assert got.P.dtype == torch.bfloat16
    assert max_rel(got.x, want.x) <= 1e-5
    assert max_rel(got.P, want.P) <= 2 ** -8
    if correction == "syrk":
        np.testing.assert_array_equal(n(got.P), n(got.P).T)


@pytest.mark.parametrize("chunks", [1, 2, 4])
def test_update_chunked_matches(rng, chunks):
    p = _params(pht_mode="rows", correction="syrk", update_chunks=chunks)
    js = jax_state(random_state(rng, pad=128))
    args = _obs(rng, js, M=7, n_new=0)[:4]
    want = jax.jit(jb.update_chunked, static_argnums=5)(
        js, *map(jnp.asarray, args), p)
    got = tb.update_chunked(torch_state(js), *map(torch.from_numpy, args),
                            port(p))
    assert max_rel(got.x, want.x) <= 1e-10
    assert max_rel(got.P, want.P) <= 1e-10


@pytest.mark.parametrize("association,ml_losers", [
    ("ml", "append"), ("ml_unique", "append"), ("ml_unique", "drop"),
    ("known", "append"), ("signature", "append")])
def test_measure_batched_matches(rng, association, ml_losers):
    """Gate + one joint update + the masked appends of the new ones."""
    p = _params(pht_mode="rows", correction="syrk", association=association,
                ml_losers=ml_losers, s_thresh=30.0
                if association in ("ml", "ml_unique") else 1e9)
    js = jax_state(random_state(rng, K=12, n_active=8, pad=128))
    zs, slots, Rs, valid, locs = _obs(rng, js, M=6, n_new=2)
    if association == "known":
        zs[:, 2] = np.r_[slots[:4] + 1, 9, 10]
    jo = JObs(rng=jnp.asarray(zs[:, 0]), bearing=jnp.asarray(zs[:, 1]),
              index=jnp.asarray(zs[:, 2].astype(np.int32)),
              loc=jnp.asarray(locs), valid=jnp.asarray(valid))
    to = TObs(*(None if v is None else t(v) for v in jo))
    u = np.array([0.05, 3.0])
    want = jax.jit(jb.measure_batched, static_argnums=3)(
        js, jo, jnp.asarray(u), p)
    got = tb.measure_batched(torch_state(js), to, torch.from_numpy(u),
                             port(p))
    assert int(got.n_active) == int(want.n_active)
    np.testing.assert_array_equal(n(got.active), n(want.active))
    np.testing.assert_array_equal(n(got.sig), n(want.sig))
    assert max_rel(got.x, want.x) <= 1e-10
    assert max_rel(got.P, want.P) <= 1e-10


def test_innovation_operator_and_noise_block_match(rng):
    p = _params()
    js = jax_state(random_state(rng))
    zs, slots, Rs, valid, _ = _obs(rng, js)
    wH, wnu = jb.innovation_operator(js.x, jnp.asarray(zs),
                                     jnp.asarray(slots), jnp.asarray(valid),
                                     p, jnp.float64)
    gH, gnu = tb.innovation_operator(t(js.x), torch.from_numpy(zs),
                                     torch.from_numpy(slots),
                                     torch.from_numpy(valid), port(p),
                                     torch.float64)
    assert max_rel(gH, wH) <= 1e-12
    assert max_rel(gnu, wnu) <= 1e-12
    np.testing.assert_array_equal(
        tb.noise_block(torch.from_numpy(Rs), torch.from_numpy(valid),
                       torch.float64).numpy(),
        np.asarray(jb.noise_block(jnp.asarray(Rs), jnp.asarray(valid),
                                  jnp.float64)))


@pytest.mark.parametrize("kw,match", [
    (dict(pht_mode="rows", rows_gather="pallas"), "pair-gather"),
    (dict(use_pallas=True), "cov_update")])
def test_branches_of_later_kernels_raise(rng, kw, match):
    """Named for the NotImplementedError these two branches raised before
    their kernels (K5 the pair gather, K4 cov_update) were ported.  They
    raise no more: update_batch through each matches JAX at f64 on an
    unpadded state (D = 27), the kernels' plain versions standing in for
    them on the CPU."""
    p = _params(**kw)
    js = jax_state(random_state(rng))
    args = _obs(rng, js, n_new=0)[:4]
    want = jax.jit(jb.update_batch, static_argnums=5)(
        js, *map(jnp.asarray, args), p)
    got = tb.update_batch(torch_state(js), *map(torch.from_numpy, args),
                          port(p))
    assert got.P.shape == (27, 27)
    assert max_rel(got.x, want.x) <= 1e-10
    assert max_rel(got.P, want.P) <= 1e-10


@pytest.mark.parametrize("pht_mode", ["dense", "rows"])
@pytest.mark.parametrize("chunks", [1, 2])
def test_update_kernel_path_matches(rng, pht_mode, chunks):
    """The kernel path (use_pallas with the gemm correction, and in rows
    mode rows_gather='pallas'): cov_update receives HP itself in rows mode
    and a copy of the transposed PHᵀ in dense mode."""
    kw = dict(rows_gather="pallas") if pht_mode == "rows" else {}
    p = _params(pht_mode=pht_mode, correction="gemm", use_pallas=True,
                update_chunks=chunks, **kw)
    js = jax_state(random_state(rng))
    args = _obs(rng, js, M=7, n_new=0)[:4]
    want = jax.jit(jb.update_chunked, static_argnums=5)(
        js, *map(jnp.asarray, args), p)
    got = tb.update_chunked(torch_state(js), *map(torch.from_numpy, args),
                            port(p))
    assert max_rel(got.x, want.x) <= 1e-10
    assert max_rel(got.P, want.P) <= 1e-10


@pytest.mark.parametrize("association", ["signature", "ml_unique"])
def test_measure_batched_kernel_path_matches(rng, association):
    """Gate through the fused-gate kernel's plain version, the update
    through the pair gather and cov_update, then the appends."""
    p = _params(pht_mode="rows", correction="gemm", use_pallas=True,
                rows_gather="pallas", association=association,
                s_thresh=30.0 if association == "ml_unique" else 1e9)
    js = jax_state(random_state(rng, K=12, n_active=8))
    zs, slots, Rs, valid, locs = _obs(rng, js, M=6, n_new=2)
    jo = JObs(rng=jnp.asarray(zs[:, 0]), bearing=jnp.asarray(zs[:, 1]),
              index=jnp.asarray(zs[:, 2].astype(np.int32)),
              loc=jnp.asarray(locs), valid=jnp.asarray(valid))
    to = TObs(*(None if v is None else t(v) for v in jo))
    u = np.array([0.05, 3.0])
    want = jax.jit(jb.measure_batched, static_argnums=3)(
        js, jo, jnp.asarray(u), p)
    got = tb.measure_batched(torch_state(js), to, torch.from_numpy(u),
                             port(p))
    assert int(got.n_active) == int(want.n_active)
    np.testing.assert_array_equal(n(got.active), n(want.active))
    assert max_rel(got.x, want.x) <= 1e-10
    assert max_rel(got.P, want.P) <= 1e-10
