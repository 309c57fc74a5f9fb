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
128 x 2^11 as the JAX package does.

Every launch adds one to its kernel's `launches`, every plain-version
call through a wrapper one to `plain_calls`; `reset_counts()` zeroes
both.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..common.errors import NTTDeviceError, NTTDispatchError
from . import barrett as bo
from .limb import signed
from .merge_ntt import MergePlan, ct_stages, gs_stages

SOURCE = "gpuntt_tpu_torch/csrc/merge_u64.cu"


@dataclass
class KernelStats:
    """What a kernel replaces, and how often it ran since the last reset."""

    name: str
    replaces: str
    route: str = "cuda"
    source: str = SOURCE
    launches: int = 0
    plain_calls: int = 0


FORWARD = KernelStats("merge_u64_forward", "gpuntt_tpu/ops/pallas_mxu.py:621")
INVERSE = KernelStats("merge_u64_inverse", "gpuntt_tpu/ops/pallas_mxu.py:632")
POLYMUL_INVERSE = KernelStats("merge_u64_polymul_inverse",
                              "gpuntt_tpu/ops/pallas_mxu.py:643")
KERNELS = (FORWARD, INVERSE, POLYMUL_INVERSE)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = k.plain_calls = 0


def split(logn: int) -> int:
    """log A of the (A, B) view: B = 2^max(ceil(logn / 2), 7), as the
    TPU kernels factor the ring (pallas_mxu.py:337)."""
    return logn - min(logn, max((logn + 1) // 2, 7))


def covers(plan: MergePlan) -> bool:
    """Plans whose transforms dispatch sends here: u64, q < 2^62, logn 12-17."""
    return plan.is64 and plan.q < (1 << 62) and 12 <= plan.logn <= 17


def takes(plan: MergePlan) -> bool:
    """Plans the kernels take: those `covers`, and the logn-11 rows of a
    2^18 ring."""
    return plan.is64 and plan.q < (1 << 62) and 11 <= plan.logn <= 17


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


def _check(plan: MergePlan, *xs: torch.Tensor) -> None:
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


def _launch(stats: KernelStats, fn, x: torch.Tensor, *args) -> None:
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.device.index, *args, ctypes.c_void_p(stream))
    if rc != 0:
        raise NTTDeviceError(f"{stats.name} launch failed: cudaError_t {rc}")
    stats.launches += 1


def _lib():
    from ._build import library

    return library("merge_u64")


def _one_s(q: int) -> int:
    return (1 << 64) // q


def merge_u64_fwd(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Forward merged NTT of each row (bit-reversed output order)."""
    _check(plan, x)
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
    _check(plan, x)
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
    _check(plan, fa, fb)
    if fa.device.type == "cpu":
        POLYMUL_INVERSE.plain_calls += 1
        return merge_u64_polymul_inv_plain(fa, fb, plan)
    y = torch.empty_like(fa)
    _launch(POLYMUL_INVERSE, _lib().merge_u64_polymul_inverse, fa,
            fa.data_ptr(), fb.data_ptr(), y.data_ptr(), fa.shape[0], plan.logn,
            split(plan.logn), plan.inv_table.data_ptr(), plan.inv_shoup.data_ptr(),
            plan.q, plan.bit, plan.mu, plan.n_inv, plan.n_inv_shoup, int(plan.xnp))
    return y
