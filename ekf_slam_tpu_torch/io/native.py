"""Builds the repository's native C++ sources (``native/*.cc``: the
scan-log codec and the robot-side scan feeder) with g++ into the port's
own build directory, ``build/torch_native/``.

The output's name carries a hash of the source and of every header of
``native/``, so an edited source builds anew; each build writes a
temporary file that is renamed into place once it is whole, so
concurrent processes never load a half-written file.  The JAX package
builds the same sources into ``native/build/`` (its io/scanlog.py and
io/socket_feed.py); the two packages share no built file.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "torch_native"


def build(source: str, shared: bool) -> Path:
    """Compile ``native/<source>`` (where not built yet) and return the
    built file: a shared library (``g++ -O2 -shared -fPIC``) or an
    executable (``g++ -O2``).  Raises ``OSError`` where there is no g++
    and ``subprocess.CalledProcessError`` where it fails."""
    src = SOURCE_DIR / source
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.h")):
        h.update(header.name.encode() + header.read_bytes())
    stem = f"{src.stem}-{h.hexdigest()[:12]}"
    out = BUILD_DIR / (f"lib{stem}.so" if shared else stem)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        flags = ["-O2", "-shared", "-fPIC"] if shared else ["-O2"]
        try:
            subprocess.run(["g++", *flags, "-o", str(tmp), str(src)],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out
