"""Build and load the native wire codec (``runtime/wire_codec.cpp``).

The source is the JAX package's ``runtime/wire_codec.cpp``, copied. It
compiles with g++ at first use into ``qwen3_asr_swift_tpu_torch/build/``
(listed in .gitignore) under a name keyed by the hash of the source and
the flags, so an edited source never loads a stale library. The flags are
the reference Makefile's (``-O3 -fPIC -std=c++17 -shared``), with no
``-ffast-math`` or ``-march=native``: either could move a µ-law rounding.

Where no ``g++`` exists, :func:`wire_codec_library` returns None and the
encoders take their numpy path; where it exists, a failed build raises.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

RUNTIME_DIR = Path(__file__).resolve().parent
SOURCE = RUNTIME_DIR / "wire_codec.cpp"
BUILD_DIR = RUNTIME_DIR.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib = None
#: what the last build did: {"seconds", "path", "cached"}
build_info: dict = {}


def build_library(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` into ``build_dir`` unless a library of the same
    source and flags is already there. Returns its path; raises
    ``RuntimeError`` if g++ is missing or fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    out = build_dir / f"libwirecodec_{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(seconds=0.0, path=str(out), cached=True)
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0, path=str(out), cached=False)
    return out


def wire_codec_library() -> Optional[ctypes.CDLL]:
    """The loaded codec (built on the first call; ``build_info`` says what
    that build did), with the reference's ctypes signatures; None where no
    g++ exists."""
    global _lib
    if shutil.which("g++") is None:
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.qs_mulaw_encode.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int8), ctypes.c_int64]
            lib.qs_pcm4_encode.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_uint16)]
            lib.qs_dpcm4_encode.argtypes = list(lib.qs_pcm4_encode.argtypes)
            for fn in (lib.qs_mulaw_encode, lib.qs_pcm4_encode, lib.qs_dpcm4_encode):
                fn.restype = None
            _lib = lib
        return _lib
