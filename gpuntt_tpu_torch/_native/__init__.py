"""ctypes loader for the native exact-arithmetic core.

Builds nttref.cpp on first use (g++ -O3 -shared, ~1s) into the
gitignored `build/` directory beside this file; the library name
carries a hash of the source and flags, so an edited source never loads
a stale build, and concurrent first uses (test workers) each build to a
private temporary name and rename it into place.  Every entry point has
a pure-Python fallback elsewhere in the package, so `available()`
gating keeps the framework functional without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "nttref.cpp")
_BUILD = os.path.join(_HERE, "build")
# no -march=native: a build copied to another machine must still run there
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()
    return os.path.join(_BUILD, f"libnttref-{digest[:12]}.so")


def _build(so: str) -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None

        u64 = ctypes.c_uint64
        p64 = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
        ci = ctypes.c_int
        sz = ctypes.c_size_t

        # the entry points the merge slice uses (nttref.cpp has more)
        lib.power_table_u64.argtypes = [u64, u64, p64, sz]
        lib.shoup_table_u64.argtypes = [p64, u64, p64, sz]
        lib.ntt_merge_u64.argtypes = [p64, ci, p64, u64, ci]
        lib.intt_merge_u64.argtypes = [p64, ci, p64, u64, ci]
        lib.ntt_merge_batch_u64.argtypes = [p64, ci, ci, p64, u64, ci]
        lib.intt_merge_batch_u64.argtypes = [p64, ci, ci, p64, u64, ci]
        lib.pointwise_mult_u64.argtypes = [p64, p64, p64, sz, u64]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


# ------------------------------------------------ convenience wrappers
#
# The native core reduces with Shoup mulmod, which needs 2q < 2^64:
# every wrapper asserts q < 2^63 so out-of-domain moduli fail loudly
# instead of returning silently wrong residues.  (The reference's own
# Barrett is documented only to 62 bits, modular_arith.cuh:66-67.)

def _check_q(q: int) -> None:
    if q >= 1 << 63:
        raise ValueError(
            f"native core needs q < 2^63 (Shoup mulmod domain), got {q}")


def power_table(base: int, q: int, n: int) -> np.ndarray:
    _check_q(q)
    lib = get_lib()
    out = np.empty(n, dtype=np.uint64)
    lib.power_table_u64(base, q, out, n)
    return out


def shoup_table(w: np.ndarray, q: int) -> np.ndarray:
    _check_q(q)
    lib = get_lib()
    w = np.ascontiguousarray(w, dtype=np.uint64)
    out = np.empty_like(w)
    lib.shoup_table_u64(w, q, out, w.size)
    return out


def ntt_merge(data: np.ndarray, logn: int, table: np.ndarray, q: int, xnp: bool) -> np.ndarray:
    _check_q(q)
    lib = get_lib()
    d = np.ascontiguousarray(data, dtype=np.uint64).copy()
    t = np.ascontiguousarray(table, dtype=np.uint64)
    if d.ndim == 1:
        lib.ntt_merge_u64(d, logn, t, q, int(xnp))
    else:
        lib.ntt_merge_batch_u64(d.reshape(-1, 1 << logn), d.size >> logn, logn, t, q, int(xnp))
    return d


def intt_merge(data: np.ndarray, logn: int, table: np.ndarray, q: int, xnp: bool) -> np.ndarray:
    _check_q(q)
    lib = get_lib()
    d = np.ascontiguousarray(data, dtype=np.uint64).copy()
    t = np.ascontiguousarray(table, dtype=np.uint64)
    if d.ndim == 1:
        lib.intt_merge_u64(d, logn, t, q, int(xnp))
    else:
        lib.intt_merge_batch_u64(d.reshape(-1, 1 << logn), d.size >> logn, logn, t, q, int(xnp))
    return d


def pointwise_mult(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    _check_q(q)
    lib = get_lib()
    a = np.ascontiguousarray(a, dtype=np.uint64)
    b = np.ascontiguousarray(b, dtype=np.uint64)
    out = np.empty_like(a)
    lib.pointwise_mult_u64(a.ravel(), b.ravel(), out.ravel(), a.size, q)
    return out
