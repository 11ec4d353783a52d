"""ekf_slam_tpu_torch configuration, schedule, conversion and package
rules against ekf_slam_tpu: same fields and defaults, same validation,
same tuned schedule; no import of JAX or of the JAX package; no quiet
fallback to the CPU."""
import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ekf_slam_tpu import config as jc
from ekf_slam_tpu.utils import schedule as js
from ekf_slam_tpu_torch import config as tc
from ekf_slam_tpu_torch import convert
from ekf_slam_tpu_torch.utils import schedule as ts

from torch_parity_helpers import dict_of

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _norm(v):
    """Field values comparable across the packages (dtypes by name)."""
    if isinstance(v, torch.dtype):
        return str(v).split(".")[-1]
    if isinstance(v, (type, np.dtype)):
        return np.dtype(v).name
    return v


@pytest.mark.parametrize("name", ["EKFParams", "RansacParams", "SimConfig"])
def test_fields_and_defaults_match(name):
    jf = {f.name: f.default for f in dataclasses.fields(getattr(jc, name))}
    tf = {f.name: f.default for f in dataclasses.fields(getattr(tc, name))}
    assert list(jf) == list(tf)
    assert {k: _norm(v) for k, v in jf.items()} == \
        {k: _norm(v) for k, v in tf.items()}


BAD_EKF = [
    dict(pht_mode="cols"), dict(update_mode="fast"),
    dict(update_mode="srekf", joseph=True),
    dict(update_mode="srekf_fast", pht_mode="rows"),
    dict(association="nearest"), dict(noise_model="huber"),
    dict(noise_model="constant"),                 # with ref_compat=True
    dict(ml_losers="keep"), dict(ml_losers="drop", association="ml"),
    dict(rows_gather="dma"), dict(rows_gather="pallas"),
    dict(correction="trsm"), dict(correction="syrk", joseph=True),
    dict(correction="syrk", update_mode="srekf"),
    dict(update_mode="srekf", update_chunks=2),
    dict(update_mode="srekf_fast", sr_noise_buffer=0),
]


@pytest.mark.parametrize("kw", BAD_EKF, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_ekf_validation_errors_match(kw):
    with pytest.raises(ValueError) as ej:
        jc.EKFParams(**kw)
    with pytest.raises(ValueError) as et:
        tc.EKFParams(**kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kw", [dict(writeback_mode="pos"),
                                dict(match_mode="any")])
def test_ransac_validation_errors_match(kw):
    with pytest.raises(ValueError) as ej:
        jc.RansacParams(**kw)
    with pytest.raises(ValueError) as et:
        tc.RansacParams(**kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("preset,args", [
    ("ref_compat_uc", (64,)), ("ref_compat_known", (32,)),
    ("sim_ransac", (720,)), ("ref_compat_legacy", (16,))])
def test_presets_match(preset, args):
    a, b = getattr(jc, preset)(*args), getattr(tc, preset)(*args)
    assert {k: _norm(v) for k, v in dataclasses.asdict(a).items()} == \
        {k: _norm(v) for k, v in dataclasses.asdict(b).items()}


@pytest.mark.parametrize("capacity,batch,cov,mode", [
    (1000, None, "auto", "batched"), (10000, 8, "auto", "batched"),
    (10000, None, "auto", "batched"), (3000, 1024, None, "batched"),
    (5000, None, "auto", "srekf_fast"), (5000, None, "auto", "srekf")])
def test_tuned_params_match(capacity, batch, cov, mode):
    jp = js.tuned_params(jc.EKFParams(capacity=capacity, update_mode=mode),
                         batch=batch, cov_dtype=cov)
    tp = ts.tuned_params(tc.EKFParams(capacity=capacity, update_mode=mode),
                         batch=batch, cov_dtype=cov)
    assert {k: _norm(v) for k, v in dataclasses.asdict(jp).items()} == \
        {k: _norm(v) for k, v in dataclasses.asdict(tp).items()}
    assert {k: _norm(v) for k, v in
            js.recommended_schedule(capacity, batch).items()} == \
        {k: _norm(v) for k, v in
         ts.recommended_schedule(capacity, batch).items()}


@pytest.mark.parametrize("params", [
    jc.EKFParams(capacity=20, dtype=jnp.float64, cov_dtype=jnp.bfloat16,
                 q_floor=(1e-4, 1e-4, 0.01), ref_compat=False,
                 noise_model="fit"),
    jc.RansacParams(n_hypotheses=16, dtype=jnp.float64, match_mode="nearest"),
    jc.SimConfig(n_beams=256)], ids=["ekf", "ransac", "sim"])
def test_params_from_dict(params):
    got = convert.params_from_dict(dict_of(params))
    assert type(got).__name__ == type(params).__name__
    assert {k: _norm(v) for k, v in dataclasses.asdict(got).items()} == \
        {k: _norm(v) for k, v in dataclasses.asdict(params).items()}


def test_params_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        convert.params_from_dict({"capacity": 3, "colour": "red"})


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _scanned_files():
    """The files the import scan reads: every module of the port and
    chip_smoke.py."""
    files = sorted((ROOT / "ekf_slam_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _scanned_files()
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "ekf_slam_tpu"), (f, mod)


@pytest.mark.parametrize("module", [
    "io/stream.py", "io/socket_feed.py", "io/scanlog.py", "io/native.py",
    "utils/quat.py", "utils/metrics.py"])
def test_import_scan_covers_the_operating_modules(module):
    """The live operating path's modules are the port's own copies: the
    scan reads each, and each imports neither JAX nor the JAX package
    (io/scanlog.py and io/socket_feed.py, jax-free in the JAX package,
    are copied, not imported)."""
    path = ROOT / "ekf_slam_tpu_torch" / module
    assert path in _scanned_files()
    mods = list(_imports(path))
    assert mods and not any(m.split(".")[0] in ("jax", "jaxlib",
                                                "ekf_slam_tpu")
                            for m in mods), mods


def test_exports_match():
    """The port's __all__ holds every name the JAX package exports but
    MeshConfig (the distributed layers, a later slice), each bound; the
    algorithm and extractor registries have the same names; and the
    exported presets and constants are the port's own."""
    import ekf_slam_tpu
    import ekf_slam_tpu_torch
    want = set(ekf_slam_tpu.__all__) - {"MeshConfig"}
    assert want <= set(ekf_slam_tpu_torch.__all__)
    assert "MeshConfig" not in ekf_slam_tpu_torch.__all__
    for name in ekf_slam_tpu_torch.__all__:
        assert hasattr(ekf_slam_tpu_torch, name), name
    assert sorted(ekf_slam_tpu_torch.ALGORITHMS) == sorted(
        ekf_slam_tpu.ALGORITHMS)
    assert sorted(ekf_slam_tpu_torch.EXTRACTORS) == sorted(
        ekf_slam_tpu.EXTRACTORS)
    assert ekf_slam_tpu_torch.config is tc
    for name in ("ASSOC_SIGNATURE", "ASSOC_ML", "ASSOC_KNOWN"):
        assert getattr(ekf_slam_tpu_torch, name) == getattr(ekf_slam_tpu,
                                                            name)
    assert ekf_slam_tpu_torch.init_state(
        ekf_slam_tpu_torch.ref_compat_legacy(4), device="cpu").P.shape == (
        11, 11)


def test_no_cuda_and_no_device_raises(monkeypatch):
    from ekf_slam_tpu_torch import SlamSession
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlamSession(ekf_params=tc.EKFParams(update_mode="batched"),
                    ransac_params=tc.RansacParams(n_hypotheses=8))
    from ekf_slam_tpu_torch.ops.ransac import init_table
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_table(tc.RansacParams())
    assert tc.resolve_device("cpu") == torch.device("cpu")
