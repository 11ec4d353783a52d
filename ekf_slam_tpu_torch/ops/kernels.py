"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
launch counters and the nvcc + ctypes loader.

* ``syrk_downdate`` — P ← P − W·Wᵀ in place, lower-triangle tiles only,
  mirrored from the same accumulator; bf16 on tensor cores (mma.sync,
  persistent blocks streaming P), f32 on CUDA-core FMAs
  (csrc/syrk_downdate.cu; replaces ekf_slam_tpu/ops/pallas/kernels.py
  ``syrk_downdate_pallas``).
* ``score_lines`` — RANSAC inlier counts of NH lines over B points
  (csrc/score_lines.cu; replaces ``score_lines_pallas``).
* ``cov_update`` — P ← P − K·V in place, any shape, ragged edges masked
  (csrc/cov_update.cu; replaces ``cov_update_pallas``).
* ``pair_gather`` — out[2i:2i+2] = P[starts[i]:starts[i]+2], starts read
  on the device (csrc/pair_gather.cu; replaces ``pair_gather_pallas``).
* ``syrk_gram`` — G = S·Sᵀ from the lower tile pairs, each mirrored from
  the same registers (csrc/syrk_gram.cu; replaces ``syrk_gram_pallas``).
* ``wall_search`` — the batched RANSAC wall search: the initial scoring
  and every greedy round of ``ransac.find_walls_batched`` in one launch of
  one thread block (csrc/wall_search.cu; replaces the 1 + T
  ``score_lines_pallas`` launches of a scan and the XLA work between them).
  It shares its scoring test with ``score_lines`` (csrc/score_lines.cuh).

The fused gate kernel (csrc/gate_costs.cu, ``gating.gate_costs_pallas``
in the JAX package) has its wrapper, ``gate_costs_state``, in
``ops/gating.py`` and is built and loaded here with the others.

Each wrapper runs its kernel on CUDA tensors and its plain version
(``*_ref``) on CPU tensors, and on nothing else: a CUDA tensor the kernel
does not take raises, it never falls back.  ``<wrapper>.launches`` counts
the kernel launches.

The kernels are compiled on first use, one ``nvcc`` per source started
together, for ``sm_90a`` into ``build/torch_kernels/`` at the repository
root (file names carry a hash of the source, so an edited source
rebuilds, as do an edited header of ``csrc/`` and changed flags), and
loaded with ctypes: a plain C interface, no PyTorch
headers.  Each launch goes on the tensor's current CUDA stream; the C
function returns ``cudaGetLastError()`` and the wrapper raises if that is
not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_SOURCES = {"syrk_downdate": "syrk_downdate.cu",
            "score_lines": "score_lines.cu",
            "gate_costs": "gate_costs.cu",
            "cov_update": "cov_update.cu",
            "pair_gather": "pair_gather.cu",
            "syrk_gram": "syrk_gram.cu",
            "wall_search": "wall_search.cu"}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
# gate_costs and wall_search round every product and sum on their own, as
# the plain versions' separate PyTorch kernels do, so that they agree to
# the bit where their order of operations is the same
_EXTRA_FLAGS = {"gate_costs": ["-fmad=false"],
                "wall_search": ["-fmad=false"]}
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
    fn.argtypes = {
        # (P, W, D, R, dtype code, vec_ok, stream)
        "syrk_downdate": [vp, vp, ci, ci, ci, ci, vp],
        # (points, valid, lines, B, NH, thresh, out, stream)
        "score_lines": [vp, vp, vp, ci, ci, ctypes.c_float, vp, vp],
        # (x, P, ld, P dtype code, lm, sig, active, zs, Rs, rad2deg,
        #  1/s_cost, wrap, M, K, out, zphi_out, stream)
        "gate_costs": [vp, vp, ctypes.c_int64, ci] + [vp] * 5
                      + [ctypes.c_float, ctypes.c_float, ci, ci, ci, vp, vp,
                         vp],
        # (P, K, V, N, D, R, stream)
        "cov_update": [vp, vp, vp, ci, ci, ci, vp],
        # (P, starts, starts are int64, pairs, rows, D, element bytes,
        #  out, stream)
        "pair_gather": [vp, vp, ci, ci, ci, ci, ci, vp, vp],
        # (S, G, D, R, dtype code, stream)
        "syrk_gram": [vp, vp, ci, ci, ci, vp],
        # (points, valid, trial, trial_ok, B, NH, T, inlier_dist,
        #  consensus, refine_passes, refine_frac, use_gap, split_gap,
        #  use_kink, kink_rad, use_rms, max_rms, lines, ok, avail, stats,
        #  counts, pools, stream)
        "wall_search": [vp] * 4 + [ci] * 3 + [ctypes.c_double, ci, ci,
                                                ctypes.c_double]
                       + [ci, ctypes.c_float] * 3 + [vp] * 7,
    }[name]
    if name == "wall_search":
        for fn in (lib.wall_search_smem, lib.wall_search_smem_limit):
            fn.restype = ctypes.c_longlong
        lib.wall_search_smem.argtypes = [ci, ci]
        lib.wall_search_smem_limit.argtypes = [ci]
        lib.wall_search_error_name.restype = ctypes.c_char_p
        lib.wall_search_error_name.argtypes = [ci]


def _digest(name: str, flags) -> str:
    """Hash of a kernel's source, every header of ``csrc/`` (a source may
    include any of them) and its nvcc flags: the build's file name, so an
    edit to any of them rebuilds."""
    h = hashlib.sha256((_CSRC / _SOURCES[name]).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile (where not built yet) and load the kernel libraries: one
    nvcc per source, all started together, each writing a temporary file
    that is renamed into place once it is whole."""
    todo = {}
    for name in names or _SOURCES:
        if name not in _libs:
            flags = _NVCC_FLAGS + _EXTRA_FLAGS.get(name, [])
            todo[name] = (_CSRC / _SOURCES[name], flags,
                          BUILD_DIR / f"lib{name}-{_digest(name, flags)}.so")
    procs = {}
    for name, (src, flags, so) in todo.items():
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    # wait for every nvcc before raising, so none outlives a failed build
    outs = {name: proc.communicate()[0] for name, (_, proc) in procs.items()}
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SOURCES[name]}:\n"
                               f"{outs[name]}")
        os.replace(tmp, todo[name][2])
    for name, (_, _, so) in todo.items():
        lib = ctypes.CDLL(str(so))
        _bind(name, lib)
        _libs[name] = lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build([name])
    return _libs[name]


def library_path(name: str) -> Path:
    """The built shared library of kernel ``name`` (built if need be)."""
    return Path(_lib(name)._name)


def _stream(device: torch.device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``: every launch
    goes there.  The launch itself is made under
    ``torch.cuda.device(device)``, so it reaches that device's context."""
    return torch.cuda.current_stream(device).cuda_stream


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
    the ragged edge and zero-fills the last rank slab itself, so no
    padding of D or R is asked for.  A bit-symmetric P stays
    bit-symmetric."""
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
        err = lib.syrk_downdate(P.data_ptr(), W.data_ptr(), D, R,
                                _SYRK_DTYPES[P.dtype], vec_ok,
                                _stream(P.device))
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
        err = lib.score_lines(points.data_ptr(), valid.data_ptr(),
                              lines.data_ptr(), B, NH, float(thresh),
                              out.data_ptr(), _stream(points.device))
    _launch_check("score_lines", err)
    score_lines.launches += 1
    return out


score_lines.launches = 0


# ---------------------------------------------------------------------------
# K3, redesigned · the batched wall search in one launch
# ---------------------------------------------------------------------------

_smem_limit: Dict[int, int] = {}


def _wall_search_limit(lib, dev: int) -> int:
    """The most dynamic shared memory a ``wall_search`` launch on CUDA
    device ``dev`` may ask for, cached per device.  A failed lookup raises
    the CUDA error by name and caches nothing."""
    if dev not in _smem_limit:
        limit = lib.wall_search_smem_limit(dev)
        if limit < 0:
            name = lib.wall_search_error_name(-limit).decode()
            raise RuntimeError(f"wall_search: the shared-memory limit of "
                               f"cuda:{dev} could not be read: CUDA error "
                               f"{-limit} ({name})")
        _smem_limit[dev] = limit
    return _smem_limit[dev]


def wall_search(points: torch.Tensor, valid: torch.Tensor,
                trial: torch.Tensor, trial_ok: torch.Tensor, params,
                counts_out: Optional[torch.Tensor] = None,
                pools_out: Optional[torch.Tensor] = None):
    """The greedy rounds of ``ransac.find_walls_batched`` from its NH
    seeded trial lines: (lines [T,2] as (m, b), ok [T], the remaining
    pool avail [B], fit stats [T,3]), T = ``params.wall_search_timeout``
    (``params`` a RansacParams).  One kernel launch on CUDA tensors, the
    plain version ``ransac.wall_search_ref`` on CPU tensors.

    On CUDA: float32 points [B,2] and trial [NH,2], bool valid [B] and
    trial_ok [NH], all contiguous; any NH ≥ 1 and T ≥ 1, and B as far as
    the block's shared memory holds (10·B + 4·P2 + 13·NH bytes, P2 the
    next power of two ≥ B: B ≤ 16,384 at NH = 64 on an H100).
    Records for checks, where given: ``counts_out`` (int32 [T+1, NH]) gets
    in row r the counts that round r picks its winner from, in row T those
    after the last round; ``pools_out`` (bool [T, B]) the pool each round
    leaves."""
    from .ransac import wall_search_ref     # ransac imports this module
    T = params.wall_search_timeout
    _require(points.dim() == 2 and points.shape[1] == 2,
             f"points must be [B, 2], got {tuple(points.shape)}")
    B = points.shape[0]
    _require(valid.shape == (B,) and valid.dtype == torch.bool,
             "valid must be bool [B]")
    _require(trial.dim() == 2 and trial.shape[1] == 2,
             f"trial must be [NH, 2], got {tuple(trial.shape)}")
    NH = trial.shape[0]
    _require(trial_ok.shape == (NH,) and trial_ok.dtype == torch.bool,
             "trial_ok must be bool [NH]")
    _require(B >= 1 and NH >= 1 and T >= 1,
             f"wall_search needs B, NH and T ≥ 1, got {B}, {NH}, {T}")
    _require(points.device == valid.device == trial.device
             == trial_ok.device,
             "points, valid, trial and trial_ok must be on one device")
    if counts_out is not None:
        _require(counts_out.shape == (T + 1, NH)
                 and counts_out.dtype == torch.int32
                 and counts_out.is_contiguous()
                 and counts_out.device == points.device,
                 f"counts_out must be a contiguous int32 [{T + 1}, {NH}] "
                 "on the points' device")
    if pools_out is not None:
        _require(pools_out.shape == (T, B) and pools_out.dtype == torch.bool
                 and pools_out.is_contiguous()
                 and pools_out.device == points.device,
                 f"pools_out must be a contiguous bool [{T}, {B}] on the "
                 "points' device")
    if points.device.type == "cpu":
        return wall_search_ref(points, valid, trial, trial_ok, params,
                               counts_out=counts_out, pools_out=pools_out)
    _require(points.device.type == "cuda",
             f"wall_search runs on CUDA or CPU tensors, not {points.device}")
    _require(points.dtype == torch.float32 and trial.dtype == torch.float32,
             f"the wall_search kernel takes float32 points and trial lines, "
             f"not {points.dtype}/{trial.dtype}")
    _require(points.is_contiguous() and valid.is_contiguous()
             and trial.is_contiguous() and trial_ok.is_contiguous(),
             "wall_search needs contiguous points, valid, trial and "
             "trial_ok")
    lib = _lib("wall_search")
    dev = points.device.index if points.device.index is not None \
        else torch.cuda.current_device()
    limit = _wall_search_limit(lib, dev)
    smem = lib.wall_search_smem(B, NH)
    _require(smem <= limit,
             f"wall_search at B={B}, NH={NH} needs {smem} bytes of shared "
             f"memory, more than the {limit} a block has")
    f32 = dict(dtype=torch.float32, device=points.device)
    lines = torch.empty((T, 2), **f32)
    ok = torch.empty((T,), dtype=torch.bool, device=points.device)
    avail = torch.empty((B,), dtype=torch.bool, device=points.device)
    stats = torch.empty((T, 3), **f32)
    with torch.cuda.device(points.device):
        err = lib.wall_search(
            points.data_ptr(), valid.data_ptr(), trial.data_ptr(),
            trial_ok.data_ptr(), B, NH, T, float(params.inlier_dist),
            int(params.line_consensus), int(params.refine_passes),
            float(params.refine_frac), int(params.split_gap > 0),
            float(params.split_gap), int(params.split_kink_deg > 0),
            math.radians(params.split_kink_deg),
            int(params.max_fit_rms > 0), float(params.max_fit_rms),
            lines.data_ptr(), ok.data_ptr(), avail.data_ptr(),
            stats.data_ptr(),
            0 if counts_out is None else counts_out.data_ptr(),
            0 if pools_out is None else pools_out.data_ptr(),
            _stream(points.device))
    _launch_check("wall_search", err)
    wall_search.launches += 1
    return lines, ok, avail, stats


wall_search.launches = 0


# ---------------------------------------------------------------------------
# K4 · rank-R covariance correction P ← P − K·V
# ---------------------------------------------------------------------------

def cov_update_ref(P: torch.Tensor, K: torch.Tensor, V: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version: P − K·V as a new tensor."""
    return P - K @ V


def cov_update(P: torch.Tensor, K: torch.Tensor, V: torch.Tensor
               ) -> torch.Tensor:
    """P ← P − K·V IN PLACE (the JAX kernel aliases P to its output,
    kernels.py:90); returns P.  P [N,D], K [N,R], V [R,D], all of one
    dtype, float32 for the kernel.  All three must be contiguous: the
    kernel takes no strides, so a caller holding a transposed view (the
    dense-mode V = (P·Hᵀ)ᵀ) passes ``.contiguous()``.  Any N, D and R: the
    kernel masks the ragged edge, so nothing is padded."""
    _require(P.dim() == 2 and K.dim() == 2 and V.dim() == 2,
             "P, K and V must be matrices")
    _require(K.shape[0] == P.shape[0] and V.shape == (K.shape[1], P.shape[1]),
             f"shapes P {tuple(P.shape)}, K {tuple(K.shape)}, "
             f"V {tuple(V.shape)} do not chain as P − K·V")
    _require(K.dtype == P.dtype and V.dtype == P.dtype,
             f"K/V dtypes {K.dtype}/{V.dtype} != P dtype {P.dtype}")
    _require(P.device == K.device == V.device,
             "P, K and V must be on one device")
    if P.device.type == "cpu":
        P.copy_(cov_update_ref(P, K, V))
        return P
    _require(P.device.type == "cuda",
             f"cov_update runs on CUDA or CPU tensors, not {P.device}")
    _require(P.dtype == torch.float32,
             f"the cov_update kernel takes float32, not {P.dtype}")
    _require(P.is_contiguous() and K.is_contiguous() and V.is_contiguous(),
             "cov_update needs contiguous P, K and V")
    (N, D), R = P.shape, K.shape[1]
    if N == 0 or D == 0 or R == 0:
        return P
    lib = _lib("cov_update")
    with torch.cuda.device(P.device):
        err = lib.cov_update(P.data_ptr(), K.data_ptr(), V.data_ptr(), N, D,
                             R, _stream(P.device))
    _launch_check("cov_update", err)
    cov_update.launches += 1
    return P


cov_update.launches = 0


# ---------------------------------------------------------------------------
# K5 · row-pair gather
# ---------------------------------------------------------------------------

def pair_gather_ref(P: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Plain version: out[2i:2i+2] = P[s_i:s_i+2] with s_i = starts[i]
    clamped into [0, rows − 2] (the kernel's guard)."""
    s = torch.clamp(starts.to(torch.int64), 0, P.shape[0] - 2)
    return P.index_select(0, (s[:, None] + torch.arange(
        2, device=s.device)).reshape(-1))


_GATHER_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def pair_gather(P: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Row pairs [2·len(starts), D] of P (kernel on CUDA, plain version on
    CPU).  float32 or bfloat16 P of any shape with at least 2 rows; starts
    int32 or int64, read by the kernel on the device (no host copy).  A
    start outside [0, rows − 2] is clamped into it, so the kernel never
    reads outside P."""
    _require(P.dim() == 2 and P.shape[0] >= 2,
             f"P must be a matrix of at least 2 rows, got {tuple(P.shape)}")
    _require(starts.dim() == 1
             and starts.dtype in (torch.int32, torch.int64),
             "starts must be int32 or int64 [pairs]")
    _require(P.device == starts.device, "P and starts must be on one device")
    if P.device.type == "cpu":
        return pair_gather_ref(P, starts)
    _require(P.device.type == "cuda",
             f"pair_gather runs on CUDA or CPU tensors, not {P.device}")
    _require(P.dtype in _GATHER_BYTES,
             f"the pair_gather kernel takes float32 or bfloat16, "
             f"not {P.dtype}")
    _require(P.is_contiguous() and starts.is_contiguous(),
             "pair_gather needs contiguous P and starts")
    (rows, D), pairs = P.shape, starts.shape[0]
    out = torch.empty((2 * pairs, D), dtype=P.dtype, device=P.device)
    if pairs == 0 or D == 0:
        return out
    lib = _lib("pair_gather")
    with torch.cuda.device(P.device):
        err = lib.pair_gather(P.data_ptr(), starts.data_ptr(),
                              int(starts.dtype == torch.int64), pairs, rows,
                              D, _GATHER_BYTES[P.dtype], out.data_ptr(),
                              _stream(P.device))
    _launch_check("pair_gather", err)
    pair_gather.launches += 1
    return out


pair_gather.launches = 0


def gather_pairs(P: torch.Tensor, starts: torch.Tensor, mode: str
                 ) -> torch.Tensor:
    """The rows-mode gather (``mode`` is ``EKFParams.rows_gather``):
    'pallas' runs the pair-gather kernel, 'take' ``index_select``."""
    if mode == "pallas":
        return pair_gather(P, starts)
    rp = (starts.to(torch.int64)[:, None]
          + torch.arange(2, device=P.device)).reshape(-1)
    return P.index_select(0, rp)


# ---------------------------------------------------------------------------
# K6 · symmetric Gram G = S·Sᵀ
# ---------------------------------------------------------------------------

def _gram_acc(dtype: torch.dtype) -> torch.dtype:
    """The Gram's accumulation and output dtype: f32 for narrow storage."""
    return (torch.float32 if dtype in (torch.bfloat16, torch.float16)
            else dtype)


def syrk_gram_ref(S: torch.Tensor) -> torch.Tensor:
    """Plain version: S·Sᵀ in the accumulation dtype (kernels.py:364-368)."""
    A = S.to(_gram_acc(S.dtype))
    return A @ A.T


_GRAM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def syrk_gram(S: torch.Tensor, use_pallas: Optional[bool] = None
              ) -> torch.Tensor:
    """G = S·Sᵀ [D,D] for S [D,R], in the accumulation dtype (f32 for
    f32/bf16/f16 S, f64 for f64), with the JAX dispatch (kernels.py:483):

    * ``use_pallas`` falsy: the plain product, ``torch.matmul``, which the
      JAX default leaves to XLA — what the recompression runs;
    * truthy, CUDA tensor: the Gram kernel (float32, bfloat16 or float64
      S), at any D and R: nothing is padded and nothing falls back;
    * truthy, CPU tensor: the plain version ``syrk_gram_ref``."""
    _require(S.dim() == 2, f"S must be a matrix, got {tuple(S.shape)}")
    if not use_pallas:
        A = S.to(_gram_acc(S.dtype))
        return torch.matmul(A, A.T)
    if S.device.type == "cpu":
        return syrk_gram_ref(S)
    _require(S.device.type == "cuda",
             f"syrk_gram runs on CUDA or CPU tensors, not {S.device}")
    _require(S.dtype in _GRAM_DTYPES,
             f"the syrk_gram kernel takes float32, bfloat16 or float64, "
             f"not {S.dtype}")
    _require(S.is_contiguous(), "syrk_gram needs a contiguous S")
    D, R = S.shape
    G = torch.empty((D, D), dtype=_gram_acc(S.dtype), device=S.device)
    if D == 0:
        return G
    lib = _lib("syrk_gram")
    with torch.cuda.device(S.device):
        err = lib.syrk_gram(S.data_ptr(), G.data_ptr(), D, R,
                            _GRAM_DTYPES[S.dtype], _stream(S.device))
    _launch_check("syrk_gram", err)
    syrk_gram.launches += 1
    return G


syrk_gram.launches = 0
