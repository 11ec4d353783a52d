"""ekf_slam_tpu_torch's checkpoints (utils/checkpointing.py) on the CPU.

A checkpoint is one ``torch.save`` of the carry's leaves in field order
(None leaves kept, the square-root schedule's tick a host int) and the
session generator's state, read back with ``weights_only=True`` onto the
template's device, each leaf cast to the template's dtype and shape.
Round trips are bit-exact (f64, bf16 P, the square-root carry, the ICP
carry); a carry of another configuration raises ValueError, as in the
JAX package; the step directories are the JAX package's ``step_%08d``,
written under a temporary name and renamed into place, and
``latest_step_dir`` ignores every other name (orbax's temporary
directories and the port's own)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu.config import EKFParams as JParams
from ekf_slam_tpu.utils import checkpointing as jckpt
from ekf_slam_tpu_torch import SlamSession
from ekf_slam_tpu_torch.utils import checkpointing as ckpt

from test_sim_session import SIM_RANSAC, make_traj
from torch_parity_helpers import port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def traj():
    tr, _ = make_traj(T=12)
    return np.array(tr.odom), np.array(tr.ranges), np.array(tr.beam_angles)


def session(seed=1, cov_dtype=None, dtype=jnp.float64, **kw):
    mode = kw.pop("update_mode", "batched")
    extra = dict(sr_noise_buffer=4) if mode == "srekf_fast" else {}
    ep = port(JParams(capacity=16, max_obs=8, ref_compat=False,
                      update_mode=mode, dtype=dtype, cov_dtype=cov_dtype,
                      **extra))
    return SlamSession(algorithm="EKF_SLAM_UC", ekf_params=ep,
                       ransac_params=port(SIM_RANSAC), seed=seed,
                       device="cpu", **kw)


def ran(sess, traj, ticks=6):
    """The carry after ``ticks`` ticks of ``traj`` (landmarks mapped)."""
    odom, ranges, beams = traj
    carry, _ = sess.run(odom[:ticks], ranges[:ticks], beams)
    return carry


def assert_same_carry(a, b):
    la, lb = ckpt.carry_leaves(a), ckpt.carry_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(y, torch.Tensor):
            assert isinstance(x, torch.Tensor), i
            assert x.dtype == y.dtype and x.shape == y.shape, i
            assert torch.equal(x, y), i
        else:
            assert type(x) is type(y) and x == y, i


@pytest.mark.parametrize("kind", ["batched", "bf16", "srekf_fast", "fused"])
def test_round_trip_is_bit_exact(traj, tmp_path, kind):
    """Save and load give every leaf back bit for bit with its dtype (a
    bf16 P, which numpy has no type for, included), the None leaves as
    None and the square-root schedule's tick as a host int; the
    generator's state comes back too, so the next draws are the same."""
    kw = {"batched": {}, "bf16": dict(cov_dtype=jnp.bfloat16),
          "srekf_fast": dict(update_mode="srekf_fast"),
          "fused": dict(control_source="fused", icp_iters=5)}[kind]
    sess = session(**kw)
    carry = ran(sess, traj)
    if kind == "bf16":
        assert carry.filt.P.dtype == torch.bfloat16
    if kind == "srekf_fast":
        assert carry.sr_tick == 6
    path = ckpt.save_checkpoint(str(tmp_path), carry, step=6,
                                generator=sess.generator)
    assert path == os.path.join(str(tmp_path), "step_00000006")
    want_draw = torch.rand(5, generator=sess.generator)
    fresh = session(**kw)
    template = fresh.init_carry(first_odom=traj[0][0],
                                n_beams=traj[1].shape[1])
    got = ckpt.load_checkpoint(path, template, generator=fresh.generator)
    assert_same_carry(got, carry)
    assert torch.equal(torch.rand(5, generator=fresh.generator), want_draw)
    flat = torch.load(os.path.join(path, ckpt.CARRY_FILE),
                      weights_only=True)
    assert sorted(flat) == ["generator_device", "generator_state"] + [
        f"leaf_{i:05d}" for i in range(len(ckpt.carry_leaves(carry)))]


def test_two_argument_calls_and_cast_to_the_template(traj, tmp_path):
    """``save_checkpoint(path, carry)`` and ``load_checkpoint(path,
    template)`` work without a generator, as the JAX calls do; each leaf
    takes the template's dtype (f64 into f32 here)."""
    carry = ran(session(), traj)
    path = ckpt.save_checkpoint(str(tmp_path / "c"), carry)
    assert path == str(tmp_path / "c")
    tmpl = session(dtype=jnp.float32).init_carry(first_odom=traj[0][0])
    got = ckpt.load_checkpoint(path, tmpl)
    assert got.filt.P.dtype == torch.float32
    assert torch.equal(got.filt.P, carry.filt.P.float())
    assert torch.equal(got.table.index, carry.table.index)


@pytest.mark.parametrize("saved,loaded", [("fused", "odometry"),
                                          ("odometry", "fused"),
                                          ("batched", "srekf_fast")])
def test_carry_of_another_config_raises(traj, tmp_path, saved, loaded):
    """A checkpoint from an ICP session loaded into an odometry template
    (and the other ways round) raises ValueError naming the leaf counts,
    as the JAX package's load does (checkpointing.py:48-50)."""
    kinds = {"fused": dict(control_source="fused", icp_iters=5),
             "odometry": {}, "batched": {},
             "srekf_fast": dict(update_mode="srekf_fast")}
    carry = ran(session(**kinds[saved]), traj, ticks=2)
    path = ckpt.save_checkpoint(str(tmp_path), carry, step=2)
    tmpl = session(**kinds[loaded]).init_carry(first_odom=traj[0][0],
                                               n_beams=traj[1].shape[1])
    with pytest.raises(ValueError, match="incompatible config"):
        ckpt.load_checkpoint(path, tmpl)


def test_generator_state_must_fit(traj, tmp_path):
    """A checkpoint without a generator state cannot restore one, and the
    state of a CUDA generator cannot restore a CPU generator: both raise
    ValueError.  The carry itself loads either way."""
    sess = session()
    carry = ran(sess, traj, ticks=2)
    bare = ckpt.save_checkpoint(str(tmp_path / "bare"), carry)
    with pytest.raises(ValueError, match="no generator state"):
        ckpt.load_checkpoint(bare, carry, generator=sess.generator)
    cuda = ckpt.write_checkpoint(str(tmp_path / "cuda"),
                                 ckpt.host_leaves(carry),
                                 torch.zeros(16, dtype=torch.uint8), "cuda")
    with pytest.raises(ValueError, match="cuda generator"):
        ckpt.load_checkpoint(cuda, carry, generator=sess.generator)
    assert_same_carry(ckpt.load_checkpoint(cuda, carry), carry)


def test_latest_step_dir_ignores_other_names(tmp_path):
    """Only ``step_`` and eight digits count: orbax's temporary directory
    (``step_XXXXXXXX.orbax-checkpoint-tmp-…``, which the JAX package's
    prefix match would take), the port's own temporary names, other
    lengths and files do not.  Where only real steps lie, the JAX package
    picks the same."""
    root = tmp_path / "ck"
    assert ckpt.latest_step_dir(str(root)) is None
    for name in ("step_00000020", "step_00000008"):
        (root / name).mkdir(parents=True)
    assert ckpt.latest_step_dir(str(root)) == str(root / "step_00000020")
    assert jckpt.latest_step_dir(str(root)) == str(root / "step_00000020")
    for name in ("step_00000040.orbax-checkpoint-tmp-1697",
                 ".step_00000050.tmp-abc", "step_123", "step_000000600",
                 "stepx00000070"):
        (root / name).mkdir()
    (root / "step_00000090").write_text("")      # a file, not a checkpoint
    assert ckpt.latest_step_dir(str(root)) == str(root / "step_00000020")
    assert ckpt.step_of(str(root / "step_00000020")) == 20
    with pytest.raises(ValueError):
        ckpt.step_of(str(root / "step_123"))


def test_failed_write_raises_and_leaves_nothing(traj, tmp_path,
                                                monkeypatch):
    """A checkpoint that cannot be written raises; no step directory and
    no temporary directory is left behind, and an earlier checkpoint of
    the same step stays whole."""
    carry = ran(session(), traj, ticks=2)
    root = str(tmp_path / "ck")
    ckpt.save_checkpoint(root, carry, step=2)

    def full_disk(*a, **k):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(torch, "save", full_disk)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(root, carry, step=4)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(root, carry, step=2)
    monkeypatch.undo()
    assert sorted(os.listdir(root)) == ["step_00000002"]
    assert_same_carry(ckpt.load_checkpoint(os.path.join(root,
                                                        "step_00000002"),
                                           carry), carry)


def test_saving_a_step_again_replaces_it(traj, tmp_path):
    """A second checkpoint of one step replaces the first whole (the JAX
    package saves with force=True)."""
    odom, ranges, beams = traj
    sess = session()
    c2 = ran(sess, traj, ticks=2)
    root = str(tmp_path)
    ckpt.save_checkpoint(root, c2, step=5)
    c4, _ = sess.run(odom[2:4], ranges[2:4], beams, carry=c2)
    path = ckpt.save_checkpoint(root, c4, step=5)
    assert sorted(os.listdir(root)) == ["step_00000005"]
    assert_same_carry(ckpt.load_checkpoint(path, c4), c4)
