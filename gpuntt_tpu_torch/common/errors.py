"""Error handling for gpuntt_tpu.

TPU-native equivalent of the reference's error layer
(reference: src/include/gpuntt/common/common.cuh:20-50, CudaException /
GPUNTT_CUDA_CHECK, and src/lib/common/common.cu:5-11 customAssert).

On TPU there is no per-launch error code to check: XLA raises Python
exceptions at trace/compile/execute time.  What remains useful is a typed
exception hierarchy plus the argument-validation assertions the reference
performs at dispatch time (ring-size ranges, dtype checks, ...).
"""

from __future__ import annotations


class NTTError(Exception):
    """Base class for all gpuntt_tpu errors."""


class NTTParameterError(NTTError, ValueError):
    """Invalid NTT parameterisation (logn out of range, bad modulus, ...).

    Mirrors the reference's customAssert failures
    (src/lib/common/common.cu:5-11, e.g. nttparameters.cu:88-95).
    """


class NTTDeviceError(NTTError, RuntimeError):
    """Device enumeration / placement failure (reference: common.cu:13-22)."""


class NTTDispatchError(NTTError, ValueError):
    """Unsupported (n_power, layout, dtype) combination at dispatch time.

    Mirrors the reference's range checks in GPU_NTT / GPU_4STEP_NTT hosts
    (e.g. ntt.cu:2087-2094, ntt_4step.cu:2303 switch default).
    """


def custom_assert(condition: bool, message: str) -> None:
    """Reference-parity assertion helper (common.cu:5-11).

    The reference prints and exits; we raise a typed exception instead,
    which is the idiomatic Python/JAX failure path.
    """
    if not condition:
        raise NTTParameterError(f"Assertion failed: {message}")
