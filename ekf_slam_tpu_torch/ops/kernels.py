"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
launch counters and the nvcc + ctypes loader.

* ``syrk_downdate`` — P ← P − W·Wᵀ in place, lower-triangle tiles only,
  mirrored from the same accumulator (csrc/syrk_downdate.cu; replaces
  ekf_slam_tpu/ops/pallas/kernels.py ``syrk_downdate_pallas``).
* ``score_lines`` — RANSAC inlier counts of NH lines over B points
  (csrc/score_lines.cu; replaces ``score_lines_pallas``).

Each wrapper runs its kernel on CUDA tensors and its plain version
(``*_ref``) on CPU tensors, and on nothing else: a CUDA tensor the kernel
does not take raises, it never falls back.  ``<wrapper>.launches`` counts
the kernel launches.

The kernels are compiled on first use, one ``nvcc`` per source started
together, for ``sm_90a`` into ``build/torch_kernels/`` at the repository
root (file names carry a hash of the source, so an edited source
rebuilds), and loaded with ctypes: a plain C interface, no PyTorch
headers.  Each launch goes on the tensor's current CUDA stream; the C
function returns ``cudaGetLastError()`` and the wrapper raises if that is
not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = {"syrk_downdate": "syrk_downdate.cu",
            "score_lines": "score_lines.cu"}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of "
                       "ekf_slam_tpu_torch are built with the CUDA toolkit")


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, name)
    fn.restype = ci
    if name == "syrk_downdate":
        # (P, W, D, R, dtype code, vec_ok, stream)
        fn.argtypes = [vp, vp, ci, ci, ci, ci, vp]
    else:
        # (points, valid, lines, B, NH, thresh, out, stream)
        fn.argtypes = [vp, vp, vp, ci, ci, ctypes.c_float, vp, vp]


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile (where not built yet) and load the kernel libraries: one
    nvcc per source, all started together, each writing a temporary file
    that is renamed into place once it is whole."""
    todo = {}
    for name in names or _SOURCES:
        if name not in _libs:
            src = _CSRC / _SOURCES[name]
            digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
            todo[name] = (src, BUILD_DIR / f"lib{name}-{digest}.so")
    procs = {}
    for name, (src, so) in todo.items():
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # wait for every nvcc before raising, so none outlives a failed build
    outs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SOURCES[name]}:\n"
                               f"{outs[name]}")
        os.replace(tmp, todo[name][1])
    for name, (_, so) in todo.items():
        lib = ctypes.CDLL(str(so))
        _bind(name, lib)
        _libs[name] = lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build([name])
    return _libs[name]


def _launch_check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K1 · symmetric rank-R downdate P ← P − W·Wᵀ
# ---------------------------------------------------------------------------

def syrk_downdate_ref(P: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Plain version: P − W·Wᵀ as a new tensor, accumulated in f32 when
    the storage dtype is narrower (the batched path's GEMM policy)."""
    acc = (torch.float32 if P.dtype in (torch.bfloat16, torch.float16)
           else P.dtype)
    Wa = W.to(acc)
    return (P.to(acc) - Wa @ Wa.T).to(P.dtype)


_SYRK_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def syrk_downdate(P: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """P ← P − W·Wᵀ IN PLACE (the JAX kernel aliases P to its output,
    kernels.py:350); returns P.  Any D and any rank R: the kernel masks
    the ragged edge itself, so no padding of D or R is asked for."""
    _require(P.dim() == 2 and P.shape[0] == P.shape[1],
             f"P must be square, got {tuple(P.shape)}")
    _require(W.dim() == 2 and W.shape[0] == P.shape[0],
             f"W must be [D, R] with D={P.shape[0]}, got {tuple(W.shape)}")
    _require(W.dtype == P.dtype, f"W dtype {W.dtype} != P dtype {P.dtype}")
    _require(W.device == P.device, "P and W must be on one device")
    if P.device.type == "cpu":
        P.copy_(syrk_downdate_ref(P, W))
        return P
    _require(P.device.type == "cuda",
             f"syrk_downdate runs on CUDA or CPU tensors, not {P.device}")
    _require(P.dtype in _SYRK_DTYPES,
             f"the syrk_downdate kernel takes float32 or bfloat16, "
             f"not {P.dtype}")
    _require(P.is_contiguous() and W.is_contiguous(),
             "syrk_downdate needs contiguous P and W")
    D, R = W.shape
    vec_ok = int((D * P.element_size()) % 16 == 0
                 and P.data_ptr() % 16 == 0)
    lib = _lib("syrk_downdate")
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = lib.syrk_downdate(P.data_ptr(), W.data_ptr(), D, R,
                                _SYRK_DTYPES[P.dtype], vec_ok, stream)
    _launch_check("syrk_downdate", err)
    syrk_downdate.launches += 1
    return P


syrk_downdate.launches = 0


# ---------------------------------------------------------------------------
# K3 · RANSAC line scoring
# ---------------------------------------------------------------------------

def score_lines_ref(points: torch.Tensor, valid: torch.Tensor,
                    lines: torch.Tensor, thresh: float) -> torch.Tensor:
    """Plain version: int32 counts [NH] of valid points within ``thresh``
    of each line y = m·x + b (lines [NH,2])."""
    m, b = lines[:, 0:1], lines[:, 1:2]                        # [NH,1]
    x, y = points[None, :, 0], points[None, :, 1]              # [1,B]
    d = torch.abs(m * x - y + b) / torch.sqrt(m * m + 1.0)
    inl = (d < thresh) & valid[None, :]
    return inl.sum(dim=1, dtype=torch.int32)


def score_lines(points: torch.Tensor, valid: torch.Tensor,
                lines: torch.Tensor, thresh: float) -> torch.Tensor:
    """Inlier counts int32 [NH] (kernel on CUDA, plain version on CPU)."""
    _require(points.dim() == 2 and points.shape[1] == 2,
             f"points must be [B, 2], got {tuple(points.shape)}")
    _require(valid.shape == points.shape[:1] and valid.dtype == torch.bool,
             "valid must be bool [B]")
    _require(lines.dim() == 2 and lines.shape[1] == 2,
             f"lines must be [NH, 2], got {tuple(lines.shape)}")
    _require(points.device == valid.device == lines.device,
             "points, valid and lines must be on one device")
    if points.device.type == "cpu":
        return score_lines_ref(points, valid, lines, thresh)
    _require(points.device.type == "cuda",
             f"score_lines runs on CUDA or CPU tensors, not {points.device}")
    _require(points.dtype == torch.float32 and lines.dtype == torch.float32,
             f"the score_lines kernel takes float32 points and lines, not "
             f"{points.dtype}/{lines.dtype}")
    _require(points.is_contiguous() and valid.is_contiguous()
             and lines.is_contiguous(),
             "score_lines needs contiguous points, valid and lines")
    B, NH = points.shape[0], lines.shape[0]
    out = torch.empty((NH,), dtype=torch.int32, device=points.device)
    if NH == 0:
        return out
    lib = _lib("score_lines")
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream(points.device).cuda_stream
        err = lib.score_lines(points.data_ptr(), valid.data_ptr(),
                              lines.data_ptr(), B, NH, float(thresh),
                              out.data_ptr(), stream)
    _launch_check("score_lines", err)
    score_lines.launches += 1
    return out


score_lines.launches = 0
