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
launches the kernel or raises.  A transform is one launch up to logn 15
and two above (`split`; see the note in merge_u64.cu).  Up to logn 15 a
whole ring lies in shared memory: one block's tile up to logn 12, the
tiles of a thread-block cluster of 2, 4 or 8 blocks at logn 13, 14 and
15, the ring's first stages crossing the cluster through distributed
shared memory.  Above, the ring is viewed as an (A, B)
matrix, the first log A butterfly stages run down its columns and the
last log B along its rows, each phase a launch.  The plain versions run
the same merge network split at the same stage, in the engine's torch
ops, so a mismatch can be traced to a phase; they run on any device,
which is how the kernels are checked on the card.

The kernels take logn 11-17 and dispatch routes rings of 2^12..2^17 to
them (`FAMILY`, read by `covers`, as the JAX package's "mxu" route
starts at 2^12); logn 11 serves the rows of a 2^18 ring, which
hopper_merge_large.py splits 128 x 2^11 as the JAX package does.  Their
lazy butterflies hold values below 4q, so they take q < 2^62 only.

Every launch adds one to its kernel's `launches`, every plain-version
call through a wrapper one to `plain_calls`; `common.tracing.reset()`
zeroes both.  The wrappers call the kernels through ops/kernel.py.
"""

from __future__ import annotations

import torch

from ..common.tracing import KernelStats
from . import barrett as bo
from . import kernel
from .limb import signed
from .merge_ntt import MergePlan, ct_stages, gs_stages

SOURCE = "gpuntt_tpu_torch/csrc/merge_u64.cu"
# lazy butterflies, 4q < 2^64; the smallest ring taken serves a big ring's rows, unrouted
FAMILY = kernel.Family(word=64, q_bits=62, takes=(11, 17), routes=(12, 17))


FORWARD = KernelStats("merge_u64_forward", "gpuntt_tpu/ops/pallas_mxu.py:621", source=SOURCE)
INVERSE = KernelStats("merge_u64_inverse", "gpuntt_tpu/ops/pallas_mxu.py:632", source=SOURCE)
POLYMUL_INVERSE = KernelStats("merge_u64_polymul_inverse",
                              "gpuntt_tpu/ops/pallas_mxu.py:643", source=SOURCE)
KERNELS = (FORWARD, INVERSE, POLYMUL_INVERSE)


def split(logn: int) -> int:
    """log A of the (A, B) view (merge_u64.cu): 0 up to logn 15, where a
    whole ring of 8-byte words fits on chip (one block's tile up to logn
    12, a cluster of 2-8 blocks' tiles at 13-15), so a transform is one
    launch and one pass over device memory; above, B = 2^max(ceil(logn /
    2), 7), as the TPU kernels factor the ring (pallas_mxu.py:337)."""
    return 0 if logn <= 15 else logn - max((logn + 1) // 2, 7)


def covers(plan: MergePlan) -> bool:
    """Plans whose transforms dispatch sends here (`FAMILY.routes`)."""
    return FAMILY.covers(plan.is64, plan.q, plan.logn)


def takes(plan: MergePlan) -> bool:
    """Plans the kernels take: those `covers`, and the logn-11 rows of a
    2^18 ring."""
    return FAMILY.admits(plan.is64, plan.q, plan.logn)


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


def _one_s(q: int) -> int:
    return (1 << 64) // q


def _admit(stats: KernelStats, plan: MergePlan, *xs: torch.Tensor) -> None:
    FAMILY.admit(stats.name, plan.is64, plan.q, plan.logn)
    kernel.check(stats.name, (plan.n,), plan.device, *xs)


def merge_u64_fwd(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Forward merged NTT of each row (bit-reversed output order)."""
    _admit(FORWARD, plan, x)
    return kernel.call(FORWARD, (x,), merge_u64_fwd_plain, (x, plan), "merge_u64_forward",
                       lambda: (plan.logn, split(plan.logn), plan.fwd_table.data_ptr(),
                                plan.fwd_shoup.data_ptr(), plan.q, _one_s(plan.q),
                                int(plan.xnp)), log_a=split(plan.logn))


def merge_u64_inv(x: torch.Tensor, plan: MergePlan) -> torch.Tensor:
    """Inverse merged NTT of each row, n^-1 scaling included."""
    _admit(INVERSE, plan, x)
    return kernel.call(INVERSE, (x,), merge_u64_inv_plain, (x, plan), "merge_u64_inverse",
                       lambda: (plan.logn, split(plan.logn), plan.inv_table.data_ptr(),
                                plan.inv_shoup.data_ptr(), plan.q, _one_s(plan.q),
                                plan.n_inv, plan.n_inv_shoup, int(plan.xnp)),
                       log_a=split(plan.logn))


def merge_u64_polymul_inv(fa: torch.Tensor, fb: torch.Tensor,
                          plan: MergePlan) -> torch.Tensor:
    """INTT(fa o fb) for canonical spectra fa, fb: the Barrett product
    is fused into the inverse's first load."""
    _admit(POLYMUL_INVERSE, plan, fa, fb)
    return kernel.call(POLYMUL_INVERSE, (fa, fb), merge_u64_polymul_inv_plain, (fa, fb, plan),
                       "merge_u64_polymul_inverse",
                       lambda: (plan.logn, split(plan.logn), plan.inv_table.data_ptr(),
                                plan.inv_shoup.data_ptr(), plan.q, plan.bit, plan.mu,
                                plan.n_inv, plan.n_inv_shoup, int(plan.xnp)),
                       log_a=split(plan.logn))
