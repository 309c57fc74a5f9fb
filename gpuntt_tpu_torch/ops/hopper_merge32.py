"""Hopper kernels of the u32 merge NTT path, with their plain versions.

The counterpart of the JAX package's ops/pallas_merge2.py and
ops/pallas_mxu32.py.  The JAX route picks one of three Pallas kernels
by ring size (gpuntt_tpu/ops/dispatch.py:94-109); they compute one
function, the u32 merged NTT, so one CUDA family in csrc/merge_u32.cu
serves them all:

    logn 8-16   K4  _fwd_kernel / _inv_kernel      (pallas_merge2.py:147, :169)
    logn 17     K5  _fwd_kernel32 / _inv_kernel32  (pallas_mxu32.py:169, :178)
    logn 18-25  K6  _colfwd32 / _colinv32          (pallas_mxu32.py:377, :383),
                    with K5 for the rows

Each wrapper takes a contiguous (batch, N) int64 tensor of u32 values
and a u32 MergePlan on the same device.  On a CPU tensor it runs the
kernel's plain version, and only there; on a CUDA tensor it launches
the kernel or raises.  A transform is one launch up to logn 13 and two
above: the ring is viewed as an (A, B) matrix (`split`), the first
log A stages run down its columns and the last log B along its rows
(see the note in merge_u32.cu).  The plain versions run the engine's
merge network split at the same stage, so a mismatch can be traced to
a phase; they run on any device, which is how the kernels are checked
on the card.

The counts are kept per TPU kernel replaced, by the logn range that
served the call: every launch adds one to that kernel's `launches`,
every plain-version call through a wrapper one to its `plain_calls`;
`reset_counts()` zeroes them.  `forward`/`inverse` count under the
stats they are given: the 4-step's rows of 128-512 words (logn 7-9,
which `takes` admits and dispatch's `covers` does not) count under
K11's row kernel (hopper_fourstep.py).
"""

from __future__ import annotations

import torch

from ..common.errors import NTTDeviceError, NTTDispatchError
from . import barrett as bo
from .hopper_merge import KernelStats, _launch
from .merge_ntt import MergePlan, ct_stages, gs_stages

SOURCE = "gpuntt_tpu_torch/csrc/merge_u32.cu"


def _stats(direction: str, tpu: str, site: str) -> KernelStats:
    return KernelStats(f"merge_u32_{direction}_{tpu.lower()}", site, source=SOURCE)


FORWARD = {
    "K4": _stats("forward", "K4", "gpuntt_tpu/ops/pallas_merge2.py:147"),
    "K5": _stats("forward", "K5", "gpuntt_tpu/ops/pallas_mxu32.py:169"),
    "K6": _stats("forward", "K6", "gpuntt_tpu/ops/pallas_mxu32.py:377 (rows: :169)"),
}
INVERSE = {
    "K4": _stats("inverse", "K4", "gpuntt_tpu/ops/pallas_merge2.py:169"),
    "K5": _stats("inverse", "K5", "gpuntt_tpu/ops/pallas_mxu32.py:178"),
    "K6": _stats("inverse", "K6", "gpuntt_tpu/ops/pallas_mxu32.py:383 (rows: :178)"),
}
KERNELS = tuple(d[k] for k in ("K4", "K5", "K6") for d in (FORWARD, INVERSE))


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = k.plain_calls = 0


def tpu_kernel(logn: int) -> str:
    """The TPU kernel whose range serves logn (gpuntt_tpu dispatch)."""
    return "K4" if logn <= 16 else "K5" if logn == 17 else "K6"


def split(logn: int) -> int:
    """log A of the (A, B) view: B = 2^min(logn, 13) up to logn 22, 2^15
    above (merge_u32.cu's split rule)."""
    return logn - min(logn, 13 if logn <= 22 else 15)


def covers(plan: MergePlan) -> bool:
    """Plans whose transforms dispatch sends here: u32, q < 2^30, logn 8-25."""
    return not plan.is64 and plan.q < (1 << 30) and 8 <= plan.logn <= 25


def takes(plan: MergePlan) -> bool:
    """Plans the kernels take: those `covers`, and the logn-7 rows of the
    4-step (its 128-word rows; the tile holds whole rings up to logn 13)."""
    return not plan.is64 and plan.q < (1 << 30) and 7 <= plan.logn <= 25


# ------------------------------------------------------------ plain versions


def fwd_cols_plain(x, plan: MergePlan):
    """Forward phase 1: x mod q, then stages 0 .. log A - 1 (columns)."""
    x = bo.reduce_forced32(x, plan.q)
    return ct_stages(x, plan.fwd_table, plan.fwd_shoup, plan.ops(), plan.logn,
                     plan.xnp, range(split(plan.logn)))


def fwd_rows_plain(y, plan: MergePlan):
    """Forward phase 2: stages log A .. logn - 1 (rows)."""
    return ct_stages(y, plan.fwd_table, plan.fwd_shoup, plan.ops(), plan.logn,
                     plan.xnp, range(split(plan.logn), plan.logn))


def inv_rows_plain(x, plan: MergePlan):
    """Inverse phase 1: x mod q, then stages logn - 1 .. log A (rows)."""
    x = bo.reduce_forced32(x, plan.q)
    return gs_stages(x, plan.inv_table, plan.inv_shoup, plan.ops(), plan.logn,
                     plan.xnp, range(plan.logn - 1, split(plan.logn) - 1, -1))


def inv_cols_plain(y, plan: MergePlan):
    """Inverse phase 2: stages log A - 1 .. 0 (columns), then n^-1."""
    ops = plan.ops()
    y = gs_stages(y, plan.inv_table, plan.inv_shoup, ops, plan.logn, plan.xnp,
                  range(split(plan.logn) - 1, -1, -1))
    return ops.mulc(y, plan.n_inv, plan.n_inv_shoup)


def merge_u32_fwd_plain(x, plan: MergePlan):
    return fwd_rows_plain(fwd_cols_plain(x, plan), plan)


def merge_u32_inv_plain(x, plan: MergePlan):
    return inv_cols_plain(inv_rows_plain(x, plan), plan)


# ------------------------------------------------------------------ wrappers


def _check(plan: MergePlan, x: torch.Tensor) -> None:
    if not takes(plan):
        raise NTTDispatchError(
            f"merge_u32 kernels take u32 plans with q < 2^30 and logn 7-25, "
            f"got q={plan.q} logn={plan.logn} is64={plan.is64}")
    if (x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != plan.n
            or not x.is_contiguous() or x.device != plan.device):
        raise NTTDispatchError(
            f"expected a contiguous (batch, {plan.n}) int64 tensor on "
            f"{plan.device}, got {tuple(x.shape)} {x.dtype} on {x.device} "
            f"contiguous={x.is_contiguous()}")
    if x.device.type not in ("cpu", "cuda"):
        raise NTTDeviceError(f"no merge_u32 kernel for {x.device}")


def _lib():
    from ._build import library

    return library("merge_u32")


def forward(stats: KernelStats, x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """merge_u32_fwd with its launch counted under `stats`."""
    _check(plan, x)
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return merge_u32_fwd_plain(x, plan)
    y = torch.empty_like(x)
    _launch(stats, _lib().merge_u32_forward, x, x.data_ptr(), y.data_ptr(),
            x.shape[0], plan.logn, split(plan.logn), plan.fwd_table.data_ptr(),
            plan.fwd_shoup.data_ptr(), plan.q, (1 << 32) // plan.q, int(plan.xnp))
    return y


def inverse(stats: KernelStats, x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """merge_u32_inv with its launch counted under `stats`."""
    _check(plan, x)
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return merge_u32_inv_plain(x, plan)
    y = torch.empty_like(x)
    _launch(stats, _lib().merge_u32_inverse, x, x.data_ptr(), y.data_ptr(),
            x.shape[0], plan.logn, split(plan.logn), plan.inv_table.data_ptr(),
            plan.inv_shoup.data_ptr(), plan.q, (1 << 32) // plan.q, plan.n_inv,
            plan.n_inv_shoup, int(plan.xnp))
    return y


def merge_u32_fwd(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Forward merged NTT of each row (bit-reversed output order)."""
    return forward(FORWARD[tpu_kernel(plan.logn)], x, plan)


def merge_u32_inv(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Inverse merged NTT of each row, n^-1 scaling included."""
    return inverse(INVERSE[tpu_kernel(plan.logn)], x, plan)
