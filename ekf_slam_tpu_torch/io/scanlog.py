"""Scan-log recording and replay (counterpart of ekf_slam_tpu/io/scanlog.py):
(odometry, scan) streams persisted so a session is replayable.

The file format is the JAX package's, byte for byte (native/
scanlog_format.h): a header ``magic "EKSL" | u32 version | u32 n_ticks |
u32 n_beams``, then per tick ``f32 odom[3]; f32 ranges[n_beams]`` (NaN =
no return).  The codec is the C++ one (native/scanlog.cc), built with g++
into the port's build directory (io/native.py) and bound through ctypes;
a numpy codec writes the same bytes where there is no toolchain.
``native=None`` tries the C++ codec and falls back to numpy, ``True``
raises where it is unavailable, ``False`` uses numpy.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from . import native as _native

_MAGIC = 0x4C534B45  # "EKSL"
_VERSION = 1


@functools.cache
def _load_native() -> Optional[ctypes.CDLL]:
    """Build (once) and load the C++ codec; None where it cannot be."""
    try:
        lib = ctypes.CDLL(str(_native.build("scanlog.cc", shared=True)))
    except (OSError, subprocess.SubprocessError):
        return None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.scanlog_write.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                  ctypes.c_uint32, f32p, f32p]
    lib.scanlog_write.restype = ctypes.c_int
    lib.scanlog_info.argtypes = [ctypes.c_char_p, u32p, u32p]
    lib.scanlog_info.restype = ctypes.c_int
    lib.scanlog_read.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                 ctypes.c_uint32, f32p, f32p]
    lib.scanlog_read.restype = ctypes.c_int
    return lib


def _codec(native: Optional[bool]) -> Optional[ctypes.CDLL]:
    """The C++ codec under ``native`` (None for the numpy codec)."""
    lib = _load_native() if native in (None, True) else None
    if lib is None and native is True:
        raise RuntimeError("native codec unavailable")
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write(path, odom: np.ndarray, ranges: np.ndarray,
          native: Optional[bool] = None) -> None:
    """Write a log: odom [T,3], ranges [T,B] (NaN = no return)."""
    odom = np.ascontiguousarray(np.asarray(odom, np.float32))
    ranges = np.ascontiguousarray(np.asarray(ranges, np.float32))
    if ranges.ndim != 2 or odom.shape != (ranges.shape[0], 3):
        raise ValueError(f"odom {odom.shape} and ranges {ranges.shape}: "
                         "expected [T,3] and [T,B]")
    T, B = ranges.shape
    lib = _codec(native)
    if lib is not None:
        rc = lib.scanlog_write(os.fsencode(path), T, B, _f32p(odom),
                               _f32p(ranges))
        if rc != 0:
            raise IOError(f"scanlog_write failed: rc={rc}")
        return
    with open(path, "wb") as f:
        f.write(np.array([_MAGIC, _VERSION, T, B], np.uint32).tobytes())
        f.write(np.concatenate([odom, ranges], axis=1).tobytes())


def info(path, native: Optional[bool] = None) -> Tuple[int, int]:
    """(n_ticks, n_beams) from the header."""
    lib = _codec(native)
    if lib is not None:
        t, b = ctypes.c_uint32(), ctypes.c_uint32()
        rc = lib.scanlog_info(os.fsencode(path), ctypes.byref(t),
                              ctypes.byref(b))
        if rc != 0:
            raise IOError(f"scanlog_info failed: rc={rc}")
        return t.value, b.value
    hdr = np.fromfile(path, np.uint32, 4)
    if hdr.size < 4 or hdr[0] != _MAGIC or hdr[1] != _VERSION:
        raise IOError("bad scanlog header")
    return int(hdr[2]), int(hdr[3])


def read(path, native: Optional[bool] = None
         ) -> Tuple[np.ndarray, np.ndarray]:
    """(odom [T,3], ranges [T,B]) from a log, f32."""
    T, B = info(path, native=native)
    lib = _codec(native)
    if lib is not None:
        odom = np.empty((T, 3), np.float32)
        ranges = np.empty((T, B), np.float32)
        rc = lib.scanlog_read(os.fsencode(path), T, B, _f32p(odom),
                              _f32p(ranges))
        if rc != 0:
            raise IOError(f"scanlog_read failed: rc={rc}")
        return odom, ranges
    raw = np.fromfile(path, np.float32, count=T * (3 + B), offset=16)
    if raw.size != T * (3 + B):
        raise IOError(f"truncated scanlog: {raw.size} of {T * (3 + B)} "
                      "values")
    raw = raw.reshape(T, 3 + B)
    return raw[:, :3].copy(), raw[:, 3:].copy()
