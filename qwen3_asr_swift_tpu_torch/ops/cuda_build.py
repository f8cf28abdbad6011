"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
and the objects link into ONE shared library with a plain C interface,
loaded with ``ctypes`` — seconds per build, against minutes for a source
that includes PyTorch's headers. The build happens at first
use, into ``qwen3_asr_swift_tpu_torch/build/`` (listed in .gitignore),
under a name keyed by the sources' and flags' hash, so an edited source
never loads a stale library. Nothing here runs at import time.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero value into an
exception. Each kernel's wrapper counts its launches in a
:class:`LaunchCounter` (``core/trace.py``, where :func:`core.trace.counters`
reads every counter).
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

from ..core.trace import LaunchCounter  # noqa: F401  (the kernels' wrappers count here)

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signatures: name → argtypes (every function returns cudaError_t as int,
#: except those in RESTYPES)
SIGNATURES = {
    # x, codes, scales, biases, y, workspace, B, K, N, bits, group_size,
    # x is bf16, stream
    "qs_quant_matmul": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # B, K, N, bits, group_size, x is bf16 → fp32 floats of K1's workspace
    "qs_quant_matmul_workspace": [_I, _I, _I, _I, _I, _I],
    # x, codes, scales, biases, y, workspace, B, K, N, bits, group_size,
    # x is bf16, stream
    "qs_quant_matmul_plane": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # B, K, N, bits, group_size, x is bf16 → fp32 floats of K2's workspace
    "qs_quant_matmul_plane_workspace": [_I, _I, _I, _I, _I, _I],
    # q, k, k_scale, v, v_scale, valid, out, workspace, B, Hkv, G, L, D, split,
    # q is bf16, out is bf16, scale, stream
    "qs_decode_attn_int8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, ctypes.c_float, _P],
}

RESTYPES = {"qs_quant_matmul_workspace": ctypes.c_longlong,
            "qs_quant_matmul_plane_workspace": ctypes.c_longlong}

_lock = threading.Lock()
_lib = None
#: what the last build did: {"seconds", "path", "log", "cached"}
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def build() -> Path:
    """Compile ``csrc/*.cu`` into the build directory unless a library of
    the same sources and flags is already there. Returns its path."""
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"libqs_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        build_info.update(seconds=0.0, path=str(out), log="", cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]   # every compile runs to its end
    try:
        for s, p, text in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name} ({p.returncode}):\n{text}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, path=str(out),
                      log="".join(logs), cached=False)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            lib.qs_error_string.argtypes = [ctypes.c_int]
            lib.qs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().qs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
