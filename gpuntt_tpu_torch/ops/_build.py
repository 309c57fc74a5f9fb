"""Build and load the port's CUDA kernels at first use.

Each source in csrc/ (merge_u64.cu, merge_u64_large.cu, merge_u32.cu,
fourstep.cu, kmerge.cu, and probe.cu, the modmul-peak probe of
utils/profiling.py) is compiled by its own nvcc call into a shared library with
a plain C interface and loaded with ctypes: `library(name)` builds and loads one,
`build_all()` starts every missing build at once and waits for them
together.  Builds land in the gitignored csrc/build/ directory under
names that carry a hash of the library's source, every header in csrc/
(a source may include another's) and the flags, so an edited source
never loads a stale build; concurrent first uses each build to a
private temporary name and rename it into place.  Importing this module
needs no nvcc: only the first launch on a CUDA tensor builds.
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
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_p, _u32, _u64, _i32, _i64 = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
                              ctypes.c_int, ctypes.c_longlong)
# library -> entry -> ctypes argtypes
_ENTRIES = {
    "merge_u64": {
        "merge_u64_forward": [_i32, _p, _p, _i64, _i32, _i32, _p, _p, _u64, _u64, _i32,
                              _p],
        "merge_u64_inverse": [_i32, _p, _p, _i64, _i32, _i32, _p, _p, _u64, _u64, _u64,
                              _u64, _i32, _p],
        "merge_u64_polymul_inverse": [_i32, _p, _p, _p, _i64, _i32, _i32, _p, _p, _u64,
                                      _i32, _u64, _u64, _u64, _i32, _p],
        **{f"rns_u64_{e}": [_i32, _p, _p, _i64, _i32, _i32, _p, _i64, _i32, _p, _p, _p,
                            _i32, _p] for e in ("forward", "inverse")},
        "rns_u64_polymul_inverse": [_i32, _p, _p, _p, _i64, _i32, _i32, _p, _i64, _i32, _p,
                                    _p, _p, _i32, _p],
    },
    "merge_u64_large": {
        "merge_u64_large_colfwd": [_i32, _p, _p, _i64, _i32, _i32, _p, _p, _p, _p, _p, _p,
                                   _i32, _u64, _u64, _i32, _p],
        "merge_u64_large_colinv": [_i32, _p, _p, _i64, _i32, _i32, _p, _p, _p, _p, _p, _p,
                                   _i32, _u64, _u64, _u64, _u64, _i32, _p],
        "merge_u64_large_colfwd_local": [_i32, _p, _p, _i64, _i32, _i32, _i64, _p, _p, _p, _p,
                                         _p, _p, _i32, _u64, _u64, _i32, _p],
        "merge_u64_large_colinv_local": [_i32, _p, _p, _i64, _i32, _i32, _i64, _p, _p, _p, _p,
                                         _p, _p, _i32, _u64, _u64, _u64, _u64, _i32, _p],
        "merge_u64_large_rowmat": [_i32, _p, _p, _i64, _i32, _p, _p, _u64, _u64, _u64,
                                   _u64, _i32, _i32, _p],
        **{f"rns_u64_large_{d}": [_i32, _p, _p, _i64, _i32, _i32, _p, _p, _p, _p, _p, _p,
                                  _p, _i32, _p, _i32, _p] for d in ("colfwd", "colinv")},
        "rns_u64_large_rowmat": [_i32, _p, _p, _i64, _i32, _p, _i64, _i32, _p, _p, _p, _i32,
                                 _i32, _p],
    },
    "merge_u32": {
        "merge_u32_forward": [_i32, _p, _p, _i64, _i32, _i32, _p, _u32, _u32, _i32, _p],
        "merge_u32_inverse": [_i32, _p, _p, _i64, _i32, _i32, _p, _u32, _u32, _u32, _u32,
                              _i32, _p],
        **{f"rns_u32_{e}": [_i32, _p, _p, _i64, _i32, _i32, _p, _i64, _i32, _p, _p, _i32,
                            _p] for e in ("forward", "inverse")},
        "rns_u32_polymul_inverse": [_i32, _p, _p, _p, _i64, _i32, _i32, _p, _i64, _i32, _p,
                                    _p, _i32, _p],
    },
    "fourstep": {
        **{f"fourstep_{w}_col_{d}": [_i32, _p, _p, _i64, _i32, _i32, _i32, _i32, _p, _p, _p,
                                     _p, _p, _p, word, word, _p]
           for w, word in (("u64", _u64), ("u32", _u32)) for d in ("fwd", "inv")},
        **{f"rns_fourstep_u64_col_{d}": [_i32, _p, _p, _i64, _i32, _i32, _i32, _i32, _p, _p,
                                         _p, _p, _p, _p, _p, _p, _p]
           for d in ("fwd", "inv")},
    },
    "kmerge": {
        **{f"kmerge_{w}_forward": [_i32, _p, _p, _i64, _i32, _p, _p, _p, _p, _p,
                                   word, word, _i32, _p]
           for w, word in (("u64", _u64), ("u32", _u32))},
        **{f"kmerge_{w}_inverse": [_i32, _p, _p, _i64, _i32, _p, _p, _p, _p, _p,
                                   word, word, word, word, _i32, _p]
           for w, word in (("u64", _u64), ("u32", _u32))},
    },
    "probe": {f"shoup_chain_{w}": [_i32, _p, _p, _i64, _i32, word, word, word, _p]
              for w, word in (("u64", _u64), ("u32", _u32))},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_info: dict = {}  # name -> {"seconds", "log"} of this process's builds


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise NTTDeviceError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                         "build from csrc/ at their first launch")


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in (name + ".cu", *headers):
        with open(os.path.join(_CSRC, path), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def _compile(names) -> None:
    """Compile the libraries `names`, one nvcc process each, all at once."""
    os.makedirs(_BUILD, exist_ok=True)
    nvcc, t0, jobs = _nvcc(), time.perf_counter(), {}
    for name in names:
        so = _so_path(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
        jobs[name] = (so, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (so, tmp, proc) in jobs.items():
        try:
            out, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            else:
                os.replace(tmp, so)
                build_info[name] = dict(seconds=time.perf_counter() - t0,
                                        log=out + err)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            failed.append(f"{name}: nvcc timed out")
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    if failed:
        raise NTTDeviceError("\n".join(failed))


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(_so_path(name))
    for entry, argtypes in _ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _libs[name] = lib
    return lib


def build_all() -> None:
    """Build every kernel library not yet built, in parallel, and load all."""
    with _lock:
        missing = [n for n in _ENTRIES if not os.path.exists(_so_path(n))]
        if missing:
            _compile(missing)
        for name in _ENTRIES:
            if name not in _libs:
                _load(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built on first call."""
    with _lock:
        if name in _libs:
            return _libs[name]
        if not os.path.exists(_so_path(name)):
            _compile([name])
        return _load(name)
