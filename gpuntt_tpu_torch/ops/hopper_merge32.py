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
the kernel or raises.  A transform is one launch up to logn 15 (whole
rings in shared memory: a block's tile up to logn 13, the tiles of a
cluster of two blocks at 14-15) and two above: the ring is viewed as an (A, B)
matrix (`split`), the first log A stages run down its columns and the
last log B along its rows, a tile of 2^13 words (2^15 from logn 23) in
shared memory per block.
Inside a launch the stages run as radix-32 passes in registers, with
lazy butterflies, and read the plan's table packed with its Shoup
companion, one 8-byte word per entry (`packed_tables`; see the note in
merge_u32.cu).  The plain versions run the engine's merge network split
at the same stage, so a mismatch can be traced to a phase; they run on
any device, which is how the kernels are checked on the card.

The counts are kept per TPU kernel replaced, by the logn range that
served the call: every launch adds one to that kernel's `launches`,
every plain-version call through a wrapper one to its `plain_calls`;
`tracing.reset()` zeroes them.  `forward`/`inverse` count under the
stats they are given: the 4-step's rows of 128-512 words (logn 7-9,
which `takes` admits and dispatch's `covers` does not) count under
K11's row kernel (hopper_fourstep.py).
"""

from __future__ import annotations

import torch

from ..common.tracing import KernelStats
from . import barrett as bo
from . import kernel
from .merge_ntt import MergePlan, ct_stages, gs_stages

SOURCE = "gpuntt_tpu_torch/csrc/merge_u32.cu"
# lazy butterflies, 4q < 2^32; the smallest ring taken serves the 4-step's rows, unrouted
FAMILY = kernel.Family(word=32, q_bits=30, takes=(7, 25), routes=(8, 25))


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


def tpu_kernel(logn: int) -> str:
    """The TPU kernel whose range serves logn (gpuntt_tpu dispatch)."""
    return "K4" if logn <= 16 else "K5" if logn == 17 else "K6"


def split(logn: int) -> int:
    """log A of the (A, B) view (merge_u32.cu's split rule): 0 up to logn
    15, where a whole ring of 32-bit words fits on chip (one block's tile
    up to logn 13, a cluster of two blocks' tiles at 14-15), so a transform
    is one launch and one pass over device memory; B = 2^13 up to logn 22,
    2^15 above."""
    return 0 if logn <= 15 else logn - (13 if logn <= 22 else 15)


def covers(plan: MergePlan) -> bool:
    """Plans whose transforms dispatch sends here (`FAMILY.routes`)."""
    return FAMILY.covers(plan.is64, plan.q, plan.logn)


def takes(plan: MergePlan) -> bool:
    """Plans the kernels take: those `covers`, and the logn-7 rows of the
    4-step (its 128-word rows; a launch takes whole rings up to logn 15)."""
    return FAMILY.admits(plan.is64, plan.q, plan.logn)


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


def packed_tables(plan) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward and inverse tables of a u32 MergePlan (or the stacked
    tables of a u32 RNSMergePlan) packed with their Shoup companions as
    the kernels read them: one int64 word per entry, the entry in the low
    32 bits and its companion in the high 32.  Built at the first launch
    and cached on the plan (on each device's copy)."""
    if "packed32" not in plan._lazy:
        pairs = (((plan.fwd_tables, plan.fwd_shoup), (plan.inv_tables, plan.inv_shoup))
                 if hasattr(plan, "fwd_tables") else
                 ((plan.fwd_table, plan.fwd_shoup), (plan.inv_table, plan.inv_shoup)))
        plan._lazy["packed32"] = tuple((t | (s << 32)).contiguous() for t, s in pairs)
    return plan._lazy["packed32"]


def _run(stats: KernelStats, x: torch.Tensor, plan: MergePlan, inverse: bool) -> torch.Tensor:
    FAMILY.admit(stats.name, plan.is64, plan.q, plan.logn)
    kernel.check(stats.name, (plan.n,), plan.device, x)
    log_a, scale = split(plan.logn), (plan.n_inv, plan.n_inv_shoup) if inverse else ()
    return kernel.call(stats, (x,), merge_u32_inv_plain if inverse else merge_u32_fwd_plain,
                       (x, plan), f"merge_u32_{'inverse' if inverse else 'forward'}",
                       lambda: (plan.logn, log_a, packed_tables(plan)[int(inverse)].data_ptr(),
                                plan.q, (1 << 32) // plan.q, *scale, int(plan.xnp)),
                       log_a=log_a)


def forward(stats: KernelStats, x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """merge_u32_fwd with its launch counted under `stats`."""
    return _run(stats, x, plan, False)


def inverse(stats: KernelStats, x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """merge_u32_inv with its launch counted under `stats`."""
    return _run(stats, x, plan, True)


def merge_u32_fwd(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Forward merged NTT of each row (bit-reversed output order)."""
    return forward(FORWARD[tpu_kernel(plan.logn)], x, plan)


def merge_u32_inv(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Inverse merged NTT of each row, n^-1 scaling included."""
    return inverse(INVERSE[tpu_kernel(plan.logn)], x, plan)
