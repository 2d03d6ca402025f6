"""Build the CUDA kernels with nvcc on first use and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so ...

``-fmad=false`` and the absence of fast-math keep the float32 DP bit-equal
to its plain PyTorch version. Libraries go to ``npore_tpu_torch/_build/``
(or ``$NPORE_TORCH_BUILD``), named by a hash of source and flags. A missing
nvcc or a failed build raises; nothing falls back to the plain path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("band_dp", "traceback", "tier_select", "npinfo")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]       # -v: registers/spills into build_logs

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of each library's entry points, the launch first (every
# pointer and the stream as void*)
_ARGTYPES = {
    "band_dp": {"npore_band_dp": [_P] * 15 + [_I] * 5 + [_F] * 3 + [_P],
                "npore_band_dp_occupancy": [_I]},
    "traceback": {"npore_traceback": [_P] * 8 + [_I] * 7 + [_P],
                  "npore_traceback_occupancy": [_I] * 2},
    "tier_select": {"npore_tier_select": [_P] * 3 + [_I] * 5 + [_P]},
    "npinfo": {"npore_npinfo": [_P] * 10 + [_I] * 5 + [_P]},
}


def build_dir() -> str:
    return os.environ.get("NPORE_TORCH_BUILD", os.path.join(_PKG, "_build"))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set PATH to include the CUDA toolkit)")
    return path


def _target(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        h = hashlib.sha256(fh.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together. Returns name -> library path."""
    os.makedirs(build_dir(), exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        out = _target(name)
        paths[name] = out
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc()] + FLAGS + [
            "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build([name])[name])
            for fn_name, argtypes in _ARGTYPES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def entry(name: str, fn: str = ""):
    """Entry point ``fn`` of kernel ``name``'s library (its launch by
    default)."""
    return getattr(load(name), fn or next(iter(_ARGTYPES[name])))


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
