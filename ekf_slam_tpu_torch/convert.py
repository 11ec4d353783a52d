"""Carry configurations and session state across from the JAX package.

Nothing here imports JAX or ekf_slam_tpu: the JAX side hands over plain
data — field dicts (``dataclasses.asdict`` with dtypes as their names) and
the leaves of its ``SessionCarry`` as numpy arrays — and this module
builds the port's objects from them.  The JAX carry's PRNG key is not
carried: the port draws from a ``torch.Generator`` and parity runs pass
the JAX draws explicitly (session.SlamSession.step).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import EKFParams, RansacParams, SimConfig, resolve_device
from .ops.ransac import LandmarkTable
from .session import SessionCarry
from .state import FilterState

_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}
_CONFIGS = (EKFParams, RansacParams, SimConfig)


def _dtype(v):
    if v is None or isinstance(v, torch.dtype):
        return v
    if str(v) not in _DTYPES:
        raise ValueError(f"unknown dtype {v!r}")
    return _DTYPES[str(v)]


def params_from_dict(d: dict):
    """EKFParams / RansacParams / SimConfig from a plain field dict; the
    class is the one whose field names the dict holds, and dtype fields
    are names ('float32', 'bfloat16', ...)."""
    keys = set(d)
    for cls in _CONFIGS:
        names = {f.name for f in dataclasses.fields(cls)}
        if keys == names:
            kw = dict(d)
            for k in ("dtype", "cov_dtype"):
                if k in kw:
                    kw[k] = _dtype(kw[k])
            for k in ("q_floor", "rc"):
                if k in kw:
                    kw[k] = tuple(kw[k])
            return cls(**kw)
    raise ValueError(f"no config class has the fields {sorted(keys)}")


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """numpy → torch, including ml_dtypes' bfloat16 (viewed as uint16)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(resolve_device(device))


def carry_from_numpy(carry, device=None) -> SessionCarry:
    """The port's SessionCarry from the JAX SessionCarry's leaves as numpy
    arrays (any object with ``filt`` (x, P, sig, active, n_active),
    ``table`` (loc, observe, index, fresh, used), ``old_odom`` and, for an
    'srekf_fast' carry, ``sr_tick``, which becomes a host int)."""
    def conv(obj, cls):
        return cls(*(tensor_from_numpy(getattr(obj, f), device)
                     for f in cls._fields))
    sr_tick = getattr(carry, "sr_tick", None)
    return SessionCarry(filt=conv(carry.filt, FilterState),
                        table=conv(carry.table, LandmarkTable),
                        old_odom=tensor_from_numpy(carry.old_odom, device),
                        sr_tick=None if sr_tick is None else int(sr_tick))
