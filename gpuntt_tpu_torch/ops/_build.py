"""Build and load the port's CUDA kernels at first use.

`library()` compiles csrc/merge_u64.cu with nvcc into a shared library
with a plain C interface and loads it with ctypes.  The build lands in
the gitignored csrc/build/ directory under a name that carries a hash
of the sources and flags, so an edited source never loads a stale
build; concurrent first uses each build to a private temporary name and
rename it into place.  Importing this module needs no nvcc: only the
first launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..common.errors import NTTDeviceError

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_BUILD = os.path.join(_CSRC, "build")
_SOURCES = ("merge_u64.cu", "merge_u64.cuh")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}  # "seconds" and "log" of this process's build, if any


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise NTTDeviceError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                         "build from csrc/ at their first launch")


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"libmerge_u64-{h.hexdigest()[:12]}.so")


def _compile(so: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_FLAGS, "-o", tmp, os.path.join(_CSRC, "merge_u64.cu")]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise NTTDeviceError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=res.stdout + res.stderr)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = _so_path()
        if not os.path.exists(so):
            _compile(so)
        lib = ctypes.CDLL(so)
        p, u64, i32, i64 = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
                            ctypes.c_longlong)
        lib.merge_u64_forward.argtypes = [i32, p, p, i64, i32, i32, p, p, u64, u64,
                                          i32, p]
        lib.merge_u64_inverse.argtypes = [i32, p, p, i64, i32, i32, p, p, u64, u64,
                                          u64, u64, i32, p]
        lib.merge_u64_polymul_inverse.argtypes = [i32, p, p, p, i64, i32, i32, p, p,
                                                  u64, i32, u64, u64, u64, i32, p]
        for fn in (lib.merge_u64_forward, lib.merge_u64_inverse,
                   lib.merge_u64_polymul_inverse):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib
