"""Checkpoint and resume of a session carry (counterpart of
ekf_slam_tpu/utils/checkpointing.py).

The session's whole dynamic state is its carry (filter state, extractor
table, odometry anchor, the ICP seed, the square-root schedule's tick)
plus the session's random generator, which the port keeps outside the
carry (session.py).  A checkpoint is one ``torch.save`` of a flat dict:
the carry's leaves in field order under index keys, as the JAX package
stores them (checkpointing.py:35-36), with ``None`` leaves kept as None
(so a carry of another configuration fails the template check) and the
square-root schedule's tick as a host int; beside them the generator's
state and the device type it came from.  The file holds tensors, ints,
strings and None only, and is read back with ``weights_only=True``.

A checkpoint of step ``n`` under a root directory is the directory
``step_%08d`` holding ``carry.pt``.  It is written under a temporary name
beside it and renamed into place, so a reader never sees half a
checkpoint; ``latest_step_dir`` takes only names that are ``step_`` and
exactly eight digits (the JAX package takes any name that starts with
``step_``, orbax's temporary directories included).
"""
from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, List, Optional

import torch

CARRY_FILE = "carry.pt"
_STEP_DIR = re.compile(r"step_\d{8}")


def carry_leaves(carry: Any) -> List[Any]:
    """The leaves of a (nested) NamedTuple carry in field order: tensors,
    host ints and None, each a leaf."""
    if isinstance(carry, tuple):
        return [leaf for v in carry for leaf in carry_leaves(v)]
    return [carry]


def _unflatten(template: Any, leaves) -> Any:
    if isinstance(template, tuple):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    return next(leaves)


def host_leaves(carry: Any) -> List[Any]:
    """Host copies of the carry's leaves.  Each copy is enqueued on the
    current stream and complete when this returns, so the caller may
    enqueue a step that updates P in place right after."""
    return [leaf.to("cpu") if isinstance(leaf, torch.Tensor) else leaf
            for leaf in carry_leaves(carry)]


def write_checkpoint(path: str, leaves: List[Any],
                     generator_state: Optional[torch.Tensor] = None,
                     generator_device: Optional[str] = None) -> str:
    """Write host leaves (and a generator state) as the checkpoint
    directory ``path``: to a temporary directory beside it, then renamed
    into place.  Returns the absolute path."""
    path = os.path.abspath(path)
    root, name = os.path.split(path)
    os.makedirs(root, exist_ok=True)
    flat = {f"leaf_{i:05d}": leaf for i, leaf in enumerate(leaves)}
    flat["generator_state"] = generator_state
    flat["generator_device"] = generator_device
    tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=root)
    try:
        with open(os.path.join(tmp, CARRY_FILE), "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(path):
            # an earlier checkpoint of this step: set it aside first (a
            # rename cannot replace a directory that is not empty)
            old = tempfile.mkdtemp(prefix=f".{name}.old-", dir=root)
            os.replace(path, os.path.join(old, name))
            os.replace(tmp, path)
            shutil.rmtree(old)
        else:
            os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def save_checkpoint(path: str, carry: Any, step: Optional[int] = None,
                    generator: Optional[torch.Generator] = None) -> str:
    """Snapshot a session carry (and ``generator``'s state, where given:
    the session's, ``SlamSession.generator``); returns the checkpoint
    directory, ``path/step_%08d`` when ``step`` is given.  Returns once
    the host copy of every leaf is complete and the file is in place."""
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}")
    leaves = host_leaves(carry)
    state = device = None
    if generator is not None:
        state, device = generator.get_state(), generator.device.type
    return write_checkpoint(path, leaves, state, device)


def load_checkpoint(path: str, template: Any,
                    generator: Optional[torch.Generator] = None) -> Any:
    """Restore a carry saved by ``save_checkpoint`` onto the device of
    ``template`` (e.g. ``session.init_carry()``), which gives its
    structure, dtypes and shapes; restore ``generator``'s state too, where
    given.  Build the template first: ``init_carry`` reseeds the session's
    generator.  Raises ValueError where the checkpoint does not fit the
    template, or its generator state came from another device type."""
    flat_t = carry_leaves(template)
    device = next(leaf.device for leaf in flat_t
                  if isinstance(leaf, torch.Tensor))
    flat = torch.load(os.path.join(os.path.abspath(path), CARRY_FILE),
                      map_location=device, weights_only=True)
    flat_r = [flat[k] for k in sorted(k for k in flat
                                      if k.startswith("leaf_"))]
    if len(flat_r) != len(flat_t) or any(
            (r is None) != (t is None) for r, t in zip(flat_r, flat_t)):
        raise ValueError(
            f"checkpoint has {sum(r is not None for r in flat_r)} leaves, "
            f"template expects {sum(t is not None for t in flat_t)} — "
            "incompatible config?")
    leaves = []
    for i, (r, t) in enumerate(zip(flat_r, flat_t)):
        if isinstance(t, torch.Tensor):
            if not isinstance(r, torch.Tensor) or r.numel() != t.numel():
                raise ValueError(
                    f"checkpoint leaf {i} does not fit the template's "
                    f"{tuple(t.shape)} — incompatible config?")
            r = r.to(dtype=t.dtype).reshape(t.shape)
        elif t is not None:
            r = int(r)
        leaves.append(r)
    if generator is not None:
        state = flat.get("generator_state")
        if state is None:
            raise ValueError(f"checkpoint {path} holds no generator state")
        if flat["generator_device"] != generator.device.type:
            raise ValueError(
                f"checkpoint {path} holds the state of a "
                f"{flat['generator_device']} generator; it cannot restore a "
                f"{generator.device.type} generator")
        generator.set_state(state.cpu())
    return _unflatten(template, iter(leaves))


def step_of(path: str) -> int:
    """The step of a ``step_%08d`` checkpoint directory."""
    name = os.path.basename(os.path.normpath(path))
    if not _STEP_DIR.fullmatch(name):
        raise ValueError(f"{path} is not a step_%08d checkpoint directory")
    return int(name[5:])


def latest_step_dir(root: str) -> Optional[str]:
    """Most recent ``step_%08d`` checkpoint directory under root, or
    None."""
    if not os.path.isdir(root):
        return None
    steps = sorted(d for d in os.listdir(root) if _STEP_DIR.fullmatch(d)
                   and os.path.isdir(os.path.join(root, d)))
    return os.path.join(root, steps[-1]) if steps else None
