"""Profiling and the work model: the port of gpuntt_tpu/utils/profiling.py.

- `trace(logdir)`: a context manager around `torch.profiler.profile`
  (the host, and the card where there is one) that writes a Chrome
  trace into `logdir`, the counterpart of jax.profiler's xplane trace;
- `ntt_cost(...)`: the declared work of one batched transform
  (butterflies, device-memory bytes), as in the JAX package;
- `measure_modmul_peak(...)`: the measured rate of canonical Shoup
  products on the card, from the probe kernel of csrc/probe.cu
  (`shoup_chain`), the counterpart of measure_vpu_modmul_peak.

`shoup_chain` launches the probe on a CUDA tensor and runs its plain
version, the same chain of ops/barrett.py Shoup products, on a CPU
tensor; every launch adds one to its kernel's `launches`, every plain
call one to `plain_calls` (`reset_counts()` zeroes both).  The probe
replaces no TPU kernel.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..common.errors import NTTDeviceError, NTTDispatchError
from ..ops import barrett as bo
from ..ops.hopper_merge import KernelStats, _launch
from ..ops.limb import M32, from_numpy_u64, signed
from .timing import time_cuda

SOURCE = "gpuntt_tpu_torch/csrc/probe.cu"
_REPLACES = "none: the peak probe (gpuntt_tpu/utils/profiling.py:61, plain jnp)"
CHAIN64 = KernelStats("shoup_chain_u64", _REPLACES, source=SOURCE)
CHAIN32 = KernelStats("shoup_chain_u32", _REPLACES, source=SOURCE)
KERNELS = (CHAIN64, CHAIN32)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = k.plain_calls = 0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: `with trace('/tmp/ntt-trace'): run()` writes
    `logdir`/trace.json (chrome://tracing or Perfetto), with the card's
    activity where there is a card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass(frozen=True)
class NTTCost:
    """Declared work for one batched transform (reference analog:
    bench_merge_ntt.cu:34-38 declares (N + N/2)*batch reads etc.)."""

    butterflies: int
    modmuls: int
    hbm_read_bytes: int
    hbm_write_bytes: int


def ntt_cost(logn: int, batch: int, is64: bool) -> NTTCost:
    n = 1 << logn
    butterflies = (n // 2) * logn * batch
    itemsize = 8 if is64 else 4
    return NTTCost(
        butterflies=butterflies,
        modmuls=butterflies,  # one twiddle modmul per butterfly
        hbm_read_bytes=(n + n // 2) * batch * itemsize,
        hbm_write_bytes=n * batch * itemsize,
    )


# ------------------------------------------------------------- the probe


def companion(w: int, q: int, is64: bool) -> int:
    """w' = floor(w * 2^word / q), the Shoup companion of w."""
    return (w << (64 if is64 else 32)) // q


def shoup_chain_plain(x: torch.Tensor, w: int, q: int, depth: int,
                      is64: bool) -> torch.Tensor:
    """x * w^depth mod q as `depth` canonical Shoup products
    (bo.shoup_mul64 / bo.shoup_mul32) by w; x below q, as lanes."""
    ws = companion(w, q, is64)
    if is64:
        ws = signed(ws)
    else:
        x = x & M32
    mul = bo.shoup_mul64 if is64 else bo.shoup_mul32
    for _ in range(depth):
        x = mul(x, w, ws, q)
    return x


def _lib():
    from ..ops._build import library

    return library("probe")


def shoup_chain(x: torch.Tensor, w: int, q: int, depth: int, is64: bool) -> torch.Tensor:
    """The probe: shoup_chain_plain's chain in registers, one launch, on
    a contiguous 1-D int64 tensor (u64 words, or u32 values) on the card;
    the plain version on a CPU tensor.  0 < w < q, and q < 2^63 (u64) or
    2^31 (u32), so that a product's r < 2q fits the word."""
    stats = CHAIN64 if is64 else CHAIN32
    if not 0 < w < q or q >= (1 << (63 if is64 else 31)):
        raise NTTDispatchError(f"{stats.name} takes 0 < w < q < 2^{63 if is64 else 31}, "
                               f"got w={w} q={q}")
    if x.dtype != torch.int64 or x.dim() != 1 or not x.is_contiguous():
        raise NTTDispatchError(f"expected a contiguous 1-D int64 tensor, got "
                               f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return shoup_chain_plain(x, w, q, depth, is64)
    if x.device.type != "cuda":
        raise NTTDeviceError(f"no probe kernel for {x.device}")
    y = torch.empty_like(x)
    entry = _lib().shoup_chain_u64 if is64 else _lib().shoup_chain_u32
    _launch(stats, entry, x, x.data_ptr(), y.data_ptr(), x.numel(), depth, w,
            companion(w, q, is64), q)
    return y


# Defaults sized for the card: one launch must last long enough that the
# launch gap and the two passes over memory are noise.  The JAX defaults
# (depth 16 on 64 x 65536 u64 words, its docstring records a 3.6x swing
# from a window too short) would make a launch of tens of µs on an H100.
# 2^24 words (128 MiB in, 128 MiB out, ~0.08 ms of memory traffic) at
# depth 128 (u64, ~13 32-bit multiply-adds a product) or 512 (u32, 3)
# are 2.1e9 or 8.6e9 products, about 2.5 ms a launch on an H100
# (PERF.md section 2).  A CPU run takes 2^12 words, to check the path.
_DEPTH = {True: 128, False: 512}
_ELEMS = {"cuda": 1 << 24, "cpu": 1 << 12}


def measure_modmul_peak(q: int, is64: bool = True, depth: int | None = None,
                        elems=None, device=None) -> float:
    """Canonical Shoup products a second: `depth` products by one
    constant w (with companion w') on `elems` words (a count or a shape),
    as the JAX package's measure_vpu_modmul_peak draws them
    (gpuntt_tpu/utils/profiling.py:61-105).  On the card (the default
    device; NTTDeviceError without one) the probe kernel runs, timed
    with CUDA events (`time_cuda`: 3 warm-ups, the median of 10 windows);
    a failed build or launch raises.  With device="cpu" the plain chain
    runs, timed with perf_counter: a rate of PyTorch's CPU ops, not of
    any device."""
    if device is None:
        from ..common.device import default_device

        device = default_device()
    device = torch.device(device)
    if depth is None:
        depth = _DEPTH[is64]
    if elems is None:
        elems = _ELEMS[device.type]
    count = int(np.prod(elems))
    rng = np.random.default_rng(0)
    w = int(rng.integers(1, q))
    xp = rng.integers(0, q, size=count, dtype=np.uint64)
    x = from_numpy_u64(xp, device)
    fn = lambda: shoup_chain(x, w, q, depth, is64)  # noqa: E731
    if device.type == "cuda":
        ms, _spread = time_cuda(fn)
        return depth * count / (ms * 1e-3)
    fn()
    t0 = time.perf_counter()
    fn()
    return depth * count / (time.perf_counter() - t0)
