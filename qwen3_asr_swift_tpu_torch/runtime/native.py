"""Build and load the native libraries: the wire codec
(``runtime/wire_codec.cpp``) and the voice-agent engine
(``runtime/speech_core.cpp`` + ``speech_core.h``).

The sources are the JAX package's, copied. Each compiles with g++ at first
use into ``qwen3_asr_swift_tpu_torch/build/`` (listed in .gitignore) under a
name keyed by the hash of its sources and flags, so an edited source never
loads a stale library. The flags are the reference Makefile's: the codec's
``-O3 -fPIC -std=c++17 -shared``, with no ``-ffast-math`` or
``-march=native`` (either could move a µ-law rounding); the engine's
``-O2 -fPIC -std=c++17 -pthread -shared``.

Where no ``g++`` exists, :func:`wire_codec_library` returns None and the
encoders take their numpy path (the engine has no such path:
:func:`speech_core_library` raises); where g++ exists, a failed build
raises. Nothing here runs at import time.
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
from typing import Optional, Sequence

RUNTIME_DIR = Path(__file__).resolve().parent
SOURCE = RUNTIME_DIR / "wire_codec.cpp"
BUILD_DIR = RUNTIME_DIR.parent / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
ENGINE_SOURCE = RUNTIME_DIR / "speech_core.cpp"
ENGINE_HEADER = RUNTIME_DIR / "speech_core.h"
ENGINE_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_lib = None
#: what the last build did: {"seconds", "path", "cached"}
build_info: dict = {}


def build_library(source: Path = SOURCE, build_dir: Path = BUILD_DIR,
                  flags: Sequence[str] = CXX_FLAGS, name: str = "wirecodec",
                  headers: Sequence[Path] = ()) -> Path:
    """Compile ``source`` into ``build_dir`` unless a library of the same
    sources (``source`` and the ``headers`` it includes) and flags is
    already there. Returns its path; raises ``RuntimeError`` if g++ is
    missing or fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    digest = hashlib.sha256(source.read_bytes())
    for header in headers:
        digest.update(header.read_bytes())
    digest.update(" ".join(flags).encode())
    out = build_dir / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(seconds=0.0, path=str(out), cached=True)
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(source)],
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


_engine = None


def build_engine_library() -> Path:
    """Build the voice-agent engine unless a build of its current sources
    is there; returns its path (raises where g++ is missing or fails)."""
    return build_library(ENGINE_SOURCE, flags=ENGINE_FLAGS, name="speechcore",
                         headers=(ENGINE_HEADER,))


def speech_core_library() -> ctypes.CDLL:
    """The loaded voice-agent engine, built on the first call (``build_info``
    says what that build did)."""
    global _engine
    with _lock:
        if _engine is None:
            _engine = ctypes.CDLL(str(build_engine_library()))
        return _engine
