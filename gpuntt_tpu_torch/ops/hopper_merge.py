"""Hopper kernels of the u64 merge NTT main path, with their plain versions.

The counterpart of the JAX package's ops/pallas_mxu.py.  Three kernels,
written in CUDA C++ for sm_90a in csrc/merge_u64.cu, replace its three
Pallas kernels:

    merge_u64_fwd          <- _fwd_kernel      (pallas_mxu.py:621)
    merge_u64_inv          <- _inv_kernel      (pallas_mxu.py:632)
    merge_u64_polymul_inv  <- _inv_mul_kernel  (pallas_mxu.py:643)

Each wrapper takes a contiguous (batch, N) int64 tensor of u64 bit
patterns and a MergePlan on the same device.  On a CPU tensor it runs
the kernel's plain version, and only there; on a CUDA tensor it
launches the kernel or raises.  Each kernel is two launches: the ring
is viewed as an (A, B) matrix, the first log A butterfly stages run
down its columns and the last log B along its rows (see the note in
merge_u64.cu).  The plain versions run the same merge network split at
the same stage, in the engine's torch ops, so a mismatch can be traced
to a phase; they run on any device, which is how the kernels are
checked on the card.

The kernels take logn 11-17.  Dispatch routes rings of 2^12..2^17 to
them (`covers`, as the JAX package's "mxu" route starts at 2^12); logn
11 serves the rows of a 2^18 ring, which hopper_merge_large.py splits
128 x 2^11 as the JAX package does.  Their lazy butterflies hold values
below 4q, so they take q < 2^62 only (LAZY_Q): `takes` and, on its own,
every wrapper's refusal (`lazy_bound`) hold it.

Every launch adds one to its kernel's `launches`, every plain-version
call through a wrapper one to `plain_calls`; `common.tracing.reset()`
zeroes both.  Every C entry of the port is called through `_launch`,
the ntt.launch span site (common/tracing.py).
"""

from __future__ import annotations

import ctypes

import torch

from ..common import tracing
from ..common.errors import NTTDeviceError, NTTDispatchError
from ..common.tracing import KernelStats  # the kernel modules import it from here
from . import barrett as bo
from .limb import signed
from .merge_ntt import MergePlan, ct_stages, gs_stages

SOURCE = "gpuntt_tpu_torch/csrc/merge_u64.cu"
LAZY_Q = 1 << 62  # the u64 register-pass kernels take q below it: values stay below 4q < 2^64


FORWARD = KernelStats("merge_u64_forward", "gpuntt_tpu/ops/pallas_mxu.py:621", source=SOURCE)
INVERSE = KernelStats("merge_u64_inverse", "gpuntt_tpu/ops/pallas_mxu.py:632", source=SOURCE)
POLYMUL_INVERSE = KernelStats("merge_u64_polymul_inverse",
                              "gpuntt_tpu/ops/pallas_mxu.py:643", source=SOURCE)
KERNELS = (FORWARD, INVERSE, POLYMUL_INVERSE)


def split(logn: int) -> int:
    """log A of the (A, B) view: B = 2^max(ceil(logn / 2), 7), as the
    TPU kernels factor the ring (pallas_mxu.py:337)."""
    return logn - min(logn, max((logn + 1) // 2, 7))


def covers(plan: MergePlan) -> bool:
    """Plans whose transforms dispatch sends here: u64, q < 2^62, logn 12-17."""
    return plan.is64 and plan.q < LAZY_Q and 12 <= plan.logn <= 17


def takes(plan: MergePlan) -> bool:
    """Plans the kernels take: those `covers`, and the logn-11 rows of a
    2^18 ring."""
    return plan.is64 and plan.q < LAZY_Q and 11 <= plan.logn <= 17


def lazy_bound(name: str, q: int) -> None:
    """Refuse a modulus past the lazy butterflies' bound (4q must fit 64
    bits), whatever a route's `takes` lets through."""
    if q >= LAZY_Q:
        raise NTTDispatchError(f"{name} takes plans with q < 2^62, got q={q}")


# ------------------------------------------------------------ plain versions


def fwd_cols_plain(x, plan: MergePlan):
    """Forward phase 1: x mod q, then stages 0 .. log A - 1 (columns)."""
    x = bo.reduce_forced64(x, plan.q)
    return ct_stages(x, plan.fwd_table, plan.fwd_shoup, plan.ops(), plan.logn,
                     plan.xnp, range(split(plan.logn)))


def fwd_rows_plain(y, plan: MergePlan):
    """Forward phase 2: stages log A .. logn - 1 (rows)."""
    return ct_stages(y, plan.fwd_table, plan.fwd_shoup, plan.ops(), plan.logn,
                     plan.xnp, range(split(plan.logn), plan.logn))


def inv_rows_plain(x, plan: MergePlan):
    """Inverse phase 1 on canonical input: stages logn - 1 .. log A (rows)."""
    return gs_stages(x, plan.inv_table, plan.inv_shoup, plan.ops(), plan.logn,
                     plan.xnp, range(plan.logn - 1, split(plan.logn) - 1, -1))


def inv_cols_plain(y, plan: MergePlan):
    """Inverse phase 2: stages log A - 1 .. 0 (columns), then n^-1."""
    ops = plan.ops()
    y = gs_stages(y, plan.inv_table, plan.inv_shoup, ops, plan.logn, plan.xnp,
                  range(split(plan.logn) - 1, -1, -1))
    return ops.mulc(y, plan.n_inv, signed(plan.n_inv_shoup))


def merge_u64_fwd_plain(x, plan: MergePlan):
    return fwd_rows_plain(fwd_cols_plain(x, plan), plan)


def merge_u64_inv_plain(x, plan: MergePlan):
    return inv_cols_plain(inv_rows_plain(bo.reduce_forced64(x, plan.q), plan), plan)


def merge_u64_polymul_inv_plain(fa, fb, plan: MergePlan):
    prod = bo.barrett_mul64(fa, fb, plan.q, plan.bit, plan.mu)
    return inv_cols_plain(inv_rows_plain(prod, plan), plan)


# ------------------------------------------------------------------ wrappers


def _check(name: str, plan: MergePlan, *xs: torch.Tensor) -> None:
    lazy_bound(name, plan.q)
    if not takes(plan):
        raise NTTDispatchError(
            f"merge_u64 kernels take u64 plans with q < 2^62 and logn 11-17, "
            f"got q={plan.q} logn={plan.logn} is64={plan.is64}")
    for x in xs:
        if (x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != plan.n
                or not x.is_contiguous()):
            raise NTTDispatchError(
                f"expected a contiguous (batch, {plan.n}) int64 tensor, got "
                f"{tuple(x.shape)} {x.dtype} contiguous={x.is_contiguous()}")
        if x.device != plan.device or x.shape != xs[0].shape:
            raise NTTDispatchError(
                f"operand on {x.device} {tuple(x.shape)} does not match the plan "
                f"on {plan.device} / the first operand {tuple(xs[0].shape)}")
    if xs[0].device.type not in ("cpu", "cuda"):
        raise NTTDeviceError(f"no merge_u64 kernel for {xs[0].device}")


def _launch(stats: KernelStats, fn, x: torch.Tensor, *args, kernel: str | None = None,
            log_a: int | None = None) -> None:
    """Call the C entry `fn` on x's card and current stream, under an
    ntt.launch span whose `kernel` attr is `kernel` or the stats' name and
    whose `word` attr is x's element size in bytes (4 or 8), and, given
    the split's `log_a`, whose `passes` attr is the passes over device
    memory a transform takes (1 for log A 0, else 2); one launch more for
    `stats` once it returns 0."""
    span = tracing.begin(tracing.LAUNCH, "kernel", kernel or stats.name)
    try:
        if span:
            span.attrs["word"] = x.element_size()
            if log_a is not None:
                span.attrs["passes"] = 2 if log_a else 1
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.device.index, *args, ctypes.c_void_p(stream))
        if rc != 0:
            raise NTTDeviceError(f"{stats.name} launch failed: cudaError_t {rc}")
    finally:
        if span:
            span.end()
    stats.launches += 1


def _lib():
    from ._build import library

    return library("merge_u64")


def _one_s(q: int) -> int:
    return (1 << 64) // q


def merge_u64_fwd(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Forward merged NTT of each row (bit-reversed output order)."""
    _check(FORWARD.name, plan, x)
    if x.device.type == "cpu":
        FORWARD.plain_calls += 1
        return merge_u64_fwd_plain(x, plan)
    y = torch.empty_like(x)
    _launch(FORWARD, _lib().merge_u64_forward, x, x.data_ptr(), y.data_ptr(),
            x.shape[0], plan.logn, split(plan.logn), plan.fwd_table.data_ptr(),
            plan.fwd_shoup.data_ptr(), plan.q, _one_s(plan.q), int(plan.xnp))
    return y


def merge_u64_inv(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Inverse merged NTT of each row, n^-1 scaling included."""
    _check(INVERSE.name, plan, x)
    if x.device.type == "cpu":
        INVERSE.plain_calls += 1
        return merge_u64_inv_plain(x, plan)
    y = torch.empty_like(x)
    _launch(INVERSE, _lib().merge_u64_inverse, x, x.data_ptr(), y.data_ptr(),
            x.shape[0], plan.logn, split(plan.logn), plan.inv_table.data_ptr(),
            plan.inv_shoup.data_ptr(), plan.q, _one_s(plan.q), plan.n_inv,
            plan.n_inv_shoup, int(plan.xnp))
    return y


def merge_u64_polymul_inv(fa: torch.Tensor, fb: torch.Tensor,
                          plan: MergePlan) -> torch.Tensor:
    """INTT(fa o fb) for canonical spectra fa, fb: the Barrett product
    is fused into the inverse's first load."""
    _check(POLYMUL_INVERSE.name, plan, fa, fb)
    if fa.device.type == "cpu":
        POLYMUL_INVERSE.plain_calls += 1
        return merge_u64_polymul_inv_plain(fa, fb, plan)
    y = torch.empty_like(fa)
    _launch(POLYMUL_INVERSE, _lib().merge_u64_polymul_inverse, fa,
            fa.data_ptr(), fb.data_ptr(), y.data_ptr(), fa.shape[0], plan.logn,
            split(plan.logn), plan.inv_table.data_ptr(), plan.inv_shoup.data_ptr(),
            plan.q, plan.bit, plan.mu, plan.n_inv, plan.n_inv_shoup, int(plan.xnp))
    return y
