"""Shared helpers of the tests that hold ekf_slam_tpu_torch (the PyTorch
port) against ekf_slam_tpu (the JAX reference): the same inputs, made with
numpy from a seed, go through both packages on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ekf_slam_tpu.state import FilterState as JState
from ekf_slam_tpu_torch import convert
from ekf_slam_tpu_torch.state import FilterState as TState


def dict_of(params) -> dict:
    """A JAX config as the plain field dict convert.params_from_dict
    takes: dataclasses.asdict with the dtypes as their names."""
    d = dataclasses.asdict(params)
    for k in ("dtype", "cov_dtype"):
        if d.get(k) is not None:
            d[k] = np.dtype(d[k]).name
    return d


def port(params):
    """The port's counterpart of a JAX config object."""
    return convert.params_from_dict(dict_of(params))


def t(a, dtype=None) -> torch.Tensor:
    """numpy/jax array → CPU torch tensor (bf16 included)."""
    out = convert.tensor_from_numpy(np.asarray(a), device="cpu")
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """torch/jax array → float64 (or integer/bool) numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16, torch.float32):
            x = x.double()
        return x.numpy()
    a = np.asarray(x)
    return a.astype(np.float64) if a.dtype.kind == "f" or \
        a.dtype.name == "bfloat16" else a


def max_rel(a, b) -> float:
    a, b = n(a), n(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def random_state(rng, K=12, n_active=8, pad=1, dtype=np.float64):
    """A filter state with ``n_active`` landmarks scattered around the
    robot and a symmetric positive-definite P over the active dims, as
    numpy arrays (x, P, sig, active, n_active)."""
    D0 = 3 + 2 * K
    D = -(-D0 // pad) * pad
    x = np.zeros(D)
    x[:3] = [rng.normal(0, 0.5), rng.normal(0, 0.5), rng.uniform(0, 360)]
    lm = rng.uniform(-5, 5, (n_active, 2))
    x[3:3 + 2 * n_active] = lm.reshape(-1)
    da = 3 + 2 * n_active
    A = rng.normal(0, 0.1, (da, da))
    P = np.zeros((D, D))
    P[:da, :da] = A @ A.T + 0.05 * np.eye(da)
    sig = np.zeros(K)
    sig[:n_active] = np.arange(1, n_active + 1)
    active = np.arange(K) < n_active
    return (x.astype(dtype), P.astype(dtype), sig.astype(dtype), active,
            np.int32(n_active))


def jax_state(arrs, cov_dtype=None) -> JState:
    x, P, sig, active, na = arrs
    Pj = jnp.asarray(P)
    if cov_dtype is not None:
        Pj = Pj.astype(cov_dtype)
    return JState(x=jnp.asarray(x), P=Pj, sig=jnp.asarray(sig),
                  active=jnp.asarray(active), n_active=jnp.asarray(na))


def torch_state(js: JState) -> TState:
    """The port's state holding the same values as a JAX state (fresh
    tensors: the port updates P in place)."""
    return TState(*(t(getattr(js, f)) for f in TState._fields))


def find_walls_draws(key, T: int, B: int):
    """The draws JAX find_walls makes from ``key`` (ransac.py:244-262,
    284-285): round r's (u, s) [B] from split(split(key, T)[r]), stacked
    to [T, B] each, as the port's find_walls takes them."""
    us, ss = [], []
    for rkey in jax.random.split(key, T):
        k_pick, k_sample = jax.random.split(rkey)
        us.append(jax.random.uniform(k_pick, (B,)))
        ss.append(jax.random.uniform(k_sample, (B,)))
    return t(jnp.stack(us)), t(jnp.stack(ss))
