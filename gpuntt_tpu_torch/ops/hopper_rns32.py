"""Hopper kernels of the u32 RNS path (K16, and K6 per modulus) and
their plain versions.

The counterpart of the JAX package's stacked u32 kernel K16
(ops/pallas_mxu_rns.py:766-916, `pallas_mxu32_rns`), whose grid steps
gather each batch row's digit tables by a scalar-prefetched modulus
schedule.  Here the u32 merge kernels of csrc/merge_u32.cu are templates
over where a ring's constants come from (csrc/merge_u32.cuh: the
launch's arguments, or a schedule into stacked tables), instantiated a
second time for RNS; no separate source exists:

    rns_u32_forward          <- _rns32_fwd_kernel (pallas_mxu_rns.py:846)
    rns_u32_inverse          <- _rns32_inv_kernel (:857)
    rns_u32_polymul_inverse  <- _rns32_inv_kernel with the Barrett product
                                fused into its first load (the JAX
                                package leaves the product unfused; the
                                outputs are identical)
    rns_u32_polymul          both forwards, the product and the inverse
                                in one launch, at logn 14-15 (`PRODUCT`)

One stacked family serves u32 ladders at logn 8-25 with every q < 2^30.
The JAX package runs K16 up to logn 17 (pallas_mxu32.py:93) and splits a
larger u32 ladder per modulus onto K6 (gpuntt_tpu/ops/dispatch.py:
499-500), so the launches are counted per TPU kernel replaced, by the
logn that served the call, as hopper_merge32.py counts them: under K16
at logn 8-17, under K6 at 18-25.  A transform is one launch and one pass
over device memory up to logn 15 and two above (hopper_merge32.split);
below logn 14 a row block holds only rings of one schedule entry, and
at logn 14-15 a cluster of two blocks holds one ring (csrc/merge_u32.cu).
There a product on a card is one launch (`rns_u32_polymul`, prepared
once per plan, row count and schedule by `prepare`): a cluster holds a
row pair, both spectra stay on chip, and a call reads a and b once and
writes the product once.

Each wrapper takes contiguous (batch, N) tensors of u32 values on the
plan's device, all int64 lanes or all int32 lanes (4-byte words, for
ladders held as 32-bit words: every q < 2^30, so residues fit a
non-negative int32), and an int32 schedule `midx` on that device with
one entry in [0, mod_count) per ring of 2^shift rows (dispatch's
route keeps it, rns.schedule_memo); the output has the operands' dtype.  On
int32 lanes the kernels read and write 4-byte words themselves (the
rns_u32_*_i32 entries of merge_u32.cu): no pass widens or narrows them.
On a CPU tensor a wrapper runs the kernel's plain version — each
modulus's rows through hopper_merge32's plain versions with that
member's plan, int32 lanes widened for them and the result narrowed —
and only there; on a CUDA tensor it launches the kernel (through
ops/kernel.py) or raises.  Every launch adds one to its kernel's `launches`, every plain-version
call through a wrapper one to `plain_calls`; `tracing.reset()` zeroes
both.  The `*_plain` functions run the plain versions alone, on any
device, which is how the kernels are checked on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..common.errors import NTTDispatchError
from ..common.tracing import KernelStats
from . import barrett as bo
from . import hopper_merge32 as hm32
from . import kernel
from .rns import RNSMergePlan, per_modulus, row_schedule

# the u32 family's lazy butterflies over stacked tables, every q with 4q < 2^32
FAMILY = kernel.Family(word=32, q_bits=30, takes=(8, 25), routes=(8, 25))


def _stats(direction: str, tpu: str, site: str) -> KernelStats:
    return KernelStats(f"rns_u32_{direction}_{tpu.lower()}", site, source=hm32.SOURCE)


_K16 = "gpuntt_tpu/ops/pallas_mxu_rns.py:"
_K6 = "gpuntt_tpu/ops/pallas_mxu32.py:"
FORWARD = {
    "K16": _stats("forward", "K16", _K16 + "846"),
    "K6": _stats("forward", "K6", _K6 + "377 (per modulus; rows: :169)"),
}
INVERSE = {
    "K16": _stats("inverse", "K16", _K16 + "857"),
    "K6": _stats("inverse", "K6", _K6 + "383 (per modulus; rows: :178)"),
}
POLYMUL_INVERSE = {
    "K16": _stats("polymul_inverse", "K16", _K16 + "857"),
    "K6": _stats("polymul_inverse", "K6", _K6 + "383 (per modulus; rows: :178)"),
}
# both forwards, the product and the inverse in one launch (no TPU kernel fuses them)
POLYMUL = _stats("polymul", "K16", _K16 + "846 twice, then :857, with the product")
KERNELS = (*(d[k] for k in ("K16", "K6") for d in (FORWARD, INVERSE, POLYMUL_INVERSE)),
           POLYMUL)
# the fused product's rings: those a transform holds on a cluster (merge_u32.cu's `clustered`)
PRODUCT = kernel.Family(word=32, q_bits=30, takes=(14, 15), routes=(14, 15))


def tpu_kernel(logn: int) -> str:
    """The TPU kernel whose range serves a u32 ladder at logn."""
    return "K16" if logn <= 17 else "K6"


def covers(plan: RNSMergePlan) -> bool:
    """Plans whose transforms dispatch sends here: `FAMILY.routes`, with
    the stacked tables (dispatch checks the genuine root of every
    member)."""
    return FAMILY.covers(plan.is64, max(plan.qs), plan.logn) and plan.fwd_tables is not None


def fuses(plan: RNSMergePlan) -> bool:
    """Plans whose product on a card is one launch (`PRODUCT.routes`)."""
    return covers(plan) and PRODUCT.covers(plan.is64, max(plan.qs), plan.logn)


# ------------------------------------------------------------ plain versions


def _per_modulus(fn, plan: RNSMergePlan, midx, shift: int, *xs):
    """fn on each modulus's rows, on int64 lanes: int32 operands are
    widened for it and the result narrowed back to int32."""
    out = per_modulus(fn, plan.members, row_schedule(midx, shift), *(x.long() for x in xs))
    return out.to(xs[0].dtype)


def rns_u32_fwd_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return _per_modulus(hm32.merge_u32_fwd_plain, plan, midx, shift, x)


def rns_u32_inv_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return _per_modulus(hm32.merge_u32_inv_plain, plan, midx, shift, x)


def _polymul_inv_plain(fa, fb, member):
    return hm32.merge_u32_inv_plain(bo.barrett_mul32(fa, fb, member.q, member.bit, member.mu),
                                    member)


def rns_u32_polymul_inv_plain(fa, fb, plan: RNSMergePlan, midx, shift: int = 0):
    """Each modulus's Barrett product (barrett_mul32), then its inverse."""
    return _per_modulus(_polymul_inv_plain, plan, midx, shift, fa, fb)


# ------------------------------------------------------------------ wrappers


# the lanes the kernels take, and the suffix of their C entries
WORDS = {torch.int64: "", torch.int32: "_i32"}


def _run(family: dict, plain, entry: str, plan: RNSMergePlan, midx, shift: int,
         inverse: bool, *xs):
    stats = family[tpu_kernel(plan.logn)]
    FAMILY.admit(stats.name, plan.is64, max(plan.qs), plan.logn)
    if plan.fwd_tables is None:
        raise NTTDispatchError(f"{stats.name} takes plans with stacked tables")
    kernel.check(stats.name, (plan.n,), plan.device, *xs, dtypes=tuple(WORDS), midx=midx,
                 shift=shift)
    log_a = hm32.split(plan.logn)
    return kernel.call(stats, xs, plain, (*xs, plan, midx, shift), entry + WORDS[xs[0].dtype],
                       lambda: (plan.logn, log_a, midx.data_ptr(), midx.numel(), shift,
                                hm32.packed_tables(plan)[int(inverse)].data_ptr(),
                                plan.consts.data_ptr(), int(plan.xnp)), log_a=log_a)


def rns_u32_fwd(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                shift: int = 0) -> torch.Tensor:
    """Forward merged NTT of each row under modulus midx[r >> shift]."""
    return _run(FORWARD, rns_u32_fwd_plain, "rns_u32_forward", plan, midx, shift, False, x)


def rns_u32_inv(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                shift: int = 0) -> torch.Tensor:
    """Inverse merged NTT of each row, its modulus's n^-1 last."""
    return _run(INVERSE, rns_u32_inv_plain, "rns_u32_inverse", plan, midx, shift, True, x)


def rns_u32_polymul_inv(fa: torch.Tensor, fb: torch.Tensor, plan: RNSMergePlan,
                        midx: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """INTT(fa o fb) per row, the Barrett product with the row's modulus
    fused into the first load."""
    return _run(POLYMUL_INVERSE, rns_u32_polymul_inv_plain, "rns_u32_polymul_inverse", plan,
                midx, shift, True, fa, fb)


class Prepared(NamedTuple):
    """The fused product for one plan, row count and schedule on a card:
    the C entries, by lanes, and their arguments that do not change from
    call to call."""

    fns: dict           # lanes dtype -> merge_u32.cu's rns_u32_polymul or its _i32 twin
    rows: int
    n: int
    device: torch.device
    midx: torch.Tensor  # the schedule on the card, kept alive for its pointer in `args`
    args: tuple         # batch, logn, logA, schedule, entries, shift, tables, consts, xnp


def prepare(plan: RNSMergePlan, midx: torch.Tensor) -> Prepared:
    """The Prepared product of `plan` (on a card) over midx.numel() rows,
    row r under modulus midx[r]; refused as the wrappers refuse a plan,
    and outside `PRODUCT`'s rings."""
    PRODUCT.admit(POLYMUL.name, plan.is64, max(plan.qs), plan.logn)
    lib = kernel.library("merge_u32")
    rows = midx.numel()
    return Prepared({dtype: getattr(lib, "rns_u32_polymul" + w) for dtype, w in WORDS.items()},
                    rows, plan.n, plan.device, midx,
                    (rows, plan.logn, hm32.split(plan.logn), midx.data_ptr(), rows, 0,
                     *(t.data_ptr() for t in hm32.packed_tables(plan)), plan.consts.data_ptr(),
                     int(plan.xnp)))


def rns_u32_polymul(a: torch.Tensor, b: torch.Tensor, prepared: Prepared) -> torch.Tensor:
    """INTT(NTT(a) o NTT(b)) per row of (rows, N) operands, int64 or int32
    lanes, in one launch (merge_u32.cu's rns_u32_polymul or its _i32
    twin), counted under POLYMUL; an operand the wrappers would refuse
    raises their error."""
    p = prepared
    a, b = a.contiguous(), b.contiguous()
    if not (a.dtype == b.dtype and a.dtype in p.fns and a.shape == b.shape == (p.rows, p.n)
            and a.device == b.device == p.device):
        kernel.check(POLYMUL.name, (p.n,), p.device, a, b, dtypes=tuple(WORDS), midx=p.midx)
    y = torch.empty_like(a)
    kernel.launch(POLYMUL, p.fns[a.dtype], a, a.data_ptr(), b.data_ptr(), y.data_ptr(), *p.args,
                  kernel="rns_u32_polymul" + WORDS[a.dtype], log_a=p.args[2])
    return y
