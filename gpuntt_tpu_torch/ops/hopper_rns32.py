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

One stacked family serves u32 ladders at logn 8-25 with every q < 2^30.
The JAX package runs K16 up to logn 17 (pallas_mxu32.py:93) and splits a
larger u32 ladder per modulus onto K6 (gpuntt_tpu/ops/dispatch.py:
499-500), so the launches are counted per TPU kernel replaced, by the
logn that served the call, as hopper_merge32.py counts them: under K16
at logn 8-17, under K6 at 18-25.  A transform is one launch up to logn
13 and two above (hopper_merge32.split); below logn 14 a row block holds
only rings of one schedule entry (csrc/merge_u32.cu).

Each wrapper takes contiguous (batch, N) int64 tensors of u32 values on
the plan's device and an int32 schedule `midx` on that device with one
entry in [0, mod_count) per ring of 2^shift rows (hopper_rns.schedule
caches it).  On a CPU tensor it runs the kernel's plain version — each
modulus's rows through hopper_merge32's plain versions with that
member's plan — and only there; on a CUDA tensor it launches the kernel
or raises.  Every launch adds one to its kernel's `launches`, every
plain-version call through a wrapper one to `plain_calls`;
`reset_counts()` zeroes both.  The `*_plain` functions run the plain
versions alone, on any device, which is how the kernels are checked on
the card.
"""

from __future__ import annotations

import torch

from ..common.errors import NTTDispatchError
from . import barrett as bo
from . import hopper_merge32 as hm32
from .hopper_merge import KernelStats, _launch
from .hopper_rns import _check, _row_schedule
from .rns import RNSMergePlan, per_modulus


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
KERNELS = tuple(d[k] for k in ("K16", "K6") for d in (FORWARD, INVERSE, POLYMUL_INVERSE))


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = k.plain_calls = 0


def tpu_kernel(logn: int) -> str:
    """The TPU kernel whose range serves a u32 ladder at logn."""
    return "K16" if logn <= 17 else "K6"


def covers(plan: RNSMergePlan) -> bool:
    """Plans whose transforms dispatch sends here: u32, every q < 2^30,
    logn 8-25, with the stacked tables (dispatch checks the genuine
    root of every member)."""
    return (not plan.is64 and max(plan.qs) < 1 << 30 and 8 <= plan.logn <= 25
            and plan.fwd_tables is not None)


# ------------------------------------------------------------ plain versions


def rns_u32_fwd_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return per_modulus(hm32.merge_u32_fwd_plain, plan.members, _row_schedule(midx, shift), x)


def rns_u32_inv_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return per_modulus(hm32.merge_u32_inv_plain, plan.members, _row_schedule(midx, shift), x)


def _polymul_inv_plain(fa, fb, member):
    return hm32.merge_u32_inv_plain(bo.barrett_mul32(fa, fb, member.q, member.bit, member.mu),
                                    member)


def rns_u32_polymul_inv_plain(fa, fb, plan: RNSMergePlan, midx, shift: int = 0):
    """Each modulus's Barrett product (barrett_mul32), then its inverse."""
    return per_modulus(_polymul_inv_plain, plan.members, _row_schedule(midx, shift), fa, fb)


# ------------------------------------------------------------------ wrappers


def _lib():
    from ._build import library

    return library("merge_u32")


def _run(family: dict, plain, entry: str, plan: RNSMergePlan, midx, shift: int,
         inverse: bool, *xs):
    if not covers(plan):
        raise NTTDispatchError(
            f"rns_u32 kernels take u32 plans with stacked tables, every q < 2^30 and logn "
            f"8-25, got logn={plan.logn} is64={plan.is64} qs={plan.qs}")
    for x in xs:
        _check(x, plan.n, plan.device, midx, shift)
    stats = family[tpu_kernel(plan.logn)]
    if xs[0].device.type == "cpu":
        stats.plain_calls += 1
        return plain(*xs, plan, midx, shift)
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    y = torch.empty_like(xs[0])
    _launch(stats, getattr(_lib(), entry), xs[0], *(x.data_ptr() for x in xs), y.data_ptr(),
            xs[0].shape[0], plan.logn, hm32.split(plan.logn), midx.data_ptr(), midx.numel(),
            shift, table.data_ptr(), shoup.data_ptr(), plan.consts.data_ptr(), int(plan.xnp))
    return y


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
