"""Hopper kernels of the u64 RNS path (K12, K13, K14), their plain
versions, the stacked kernel plans and the compositions.

The counterpart of the JAX package's ops/pallas_mxu_rns.py, whose
kernels gather each batch row's tables by a scalar-prefetched modulus
schedule.  Here the kernels of the single-modulus paths are templates
over where a ring's constants come from (csrc/merge_u64.cuh: the
launch's arguments, or a schedule into stacked tables), instantiated a
second time in the sources that hold them; no separate RNS source
exists.  Every block covers rows of one ring and reads that ring's
modulus once.

    K12  rns_u64_forward          <- _rns_fwd_kernel (pallas_mxu_rns.py:178)   merge_u64.cu
         rns_u64_inverse          <- _rns_inv_kernel (:190)
         rns_u64_polymul_inverse  <- _rns_inv_kernel with the Barrett product
                                     fused into its first load (the JAX
                                     package leaves the product unfused;
                                     the outputs are identical)
    K13  rns_u64_large_colfwd     <- _rns_colfwd_kernel (:375)   merge_u64_large.cu
         rns_u64_large_colinv     <- _rns_colinv_kernel (:388)
         rns_u64_large_rowmat     <- _rns_rowmat_kernel (:448), rows <= 512
    K14  rns_fourstep_u64_col     <- _rns_4step_col_kernel (:629)   fourstep.cu

K12 takes rings of 2^11..2^17 (dispatch routes 2^12..2^17; 2^11 serves
the rows of a 2^18 ring).  K13 is the big-ring composition of
hopper_merge_large.py over stacked LargePlans at logn 18-23 (A = 128,
rows of 2^11..2^16 on K12).  K14 is the 4-step's column kernel over
stacked FourStepKernelPlans at logn 14-23, its rows on K13's row kernel
(512 words, logn 14-16) or on K12 (2^12..2^16 words).  A schedule
`midx` is an int32 tensor on the device with entries in [0, mod_count)
(dispatch normalises it and caches the copy, `schedule`); the row
kernels take one entry per ring of 2^shift rows.

Each wrapper takes contiguous (batch, N) int64 tensors of u64 bit
patterns on the plan's device.  On a CPU tensor it runs the kernel's
plain version — each modulus's rows through the single-modulus kernel's
plain version with that member's plan — and only there; on a CUDA tensor
it launches the kernel or raises.  Every launch adds one to its kernel's
`launches`, every plain-version call through a wrapper one to
`plain_calls`; `reset_counts()` zeroes both.  The `*_plain`
compositions run the plain versions alone, on any device, which is how
the kernels are checked on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..common.errors import NTTDeviceError, NTTDispatchError
from . import hopper_fourstep as hf
from . import hopper_merge as hm
from . import hopper_merge_large as hml
from .hopper_merge import KernelStats, _launch
from .rns import RNSMergePlan, per_modulus

_REPLACES = "gpuntt_tpu/ops/pallas_mxu_rns.py:"
FORWARD = KernelStats("rns_u64_forward", _REPLACES + "178", source=hm.SOURCE)
INVERSE = KernelStats("rns_u64_inverse", _REPLACES + "190", source=hm.SOURCE)
POLYMUL_INVERSE = KernelStats("rns_u64_polymul_inverse", _REPLACES + "190",
                              source=hm.SOURCE)
LARGE_COLFWD = KernelStats("rns_u64_large_colfwd", _REPLACES + "375", source=hml.SOURCE)
LARGE_COLINV = KernelStats("rns_u64_large_colinv", _REPLACES + "388", source=hml.SOURCE)
LARGE_ROWMAT = KernelStats("rns_u64_large_rowmat", _REPLACES + "448", source=hml.SOURCE)
FOURSTEP_COL = KernelStats("rns_fourstep_u64_col", _REPLACES + "629", source=hf.SOURCE)
KERNELS = (FORWARD, INVERSE, POLYMUL_INVERSE, LARGE_COLFWD, LARGE_COLINV, LARGE_ROWMAT,
           FOURSTEP_COL)

ROW_TILE_LOG = 12  # K13's row kernel holds 2^12 words per block


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = k.plain_calls = 0


def _narrow(plan) -> bool:
    return plan.is64 and max(plan.qs) < 1 << 62


def takes(plan: RNSMergePlan) -> bool:
    """Plans K12 takes: u64, every q < 2^62, logn 11-17."""
    return _narrow(plan) and 11 <= plan.logn <= 17


def covers(plan: RNSMergePlan) -> bool:
    """Plans whose transforms dispatch sends to K12: logn 12-17 (with a
    genuine root for every member, which dispatch checks)."""
    return _narrow(plan) and 12 <= plan.logn <= 17


def covers_large(plan: RNSMergePlan) -> bool:
    """Plans whose transforms dispatch sends to K13: logn 18-23, the JAX
    route's top (gpuntt_tpu/ops/dispatch.py:560)."""
    return _narrow(plan) and 18 <= plan.logn <= 23


def schedule(owner, mod_idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """`mod_idx` (normalised, int64) as an int32 tensor on `device`,
    copied once per schedule and cached on `owner` (an RNS plan): a
    host-to-device copy from pageable memory waits for the stream, which
    would hold the host back on every call."""
    cache = owner._lazy.setdefault("schedules", {})
    key = (str(device), np.asarray(mod_idx, dtype=np.int64).tobytes())
    if key not in cache:
        if len(cache) >= 64:
            cache.clear()
        cache[key] = torch.from_numpy(np.asarray(mod_idx, dtype=np.int32)).to(device)
    return cache[key]


# ------------------------------------------------------------------ plans

_W = ("wt_fwd", "wt_fwd_shoup", "ws_fwd", "ws_fwd_shoup", "wt_inv", "wt_inv_shoup", "ws_inv",
      "ws_inv_shoup")


def _shape(p) -> tuple:
    if isinstance(p, hml.LargePlan):
        return (p.logn, p.A, p.B, p.tile)
    return (p.logn, p.n1, p.n2, p.tile, p.w_tile, p.is64)


@dataclass(frozen=True, eq=False)
class RNSColumnPlan:
    """K13's and K14's plan: per-modulus kernel plans of one shape
    (LargePlans, or FourStepKernelPlans), with their column plans, row
    plans and factored W tables stacked on a leading (mod_count,) axis.
    Each member becomes a view of its rows of the stacks, which its
    plain version reads.  No table has N entries."""

    members: tuple
    col: RNSMergePlan
    rows: RNSMergePlan
    wt_fwd: torch.Tensor  # (mod_count, A or n1, T)
    wt_fwd_shoup: torch.Tensor
    ws_fwd: torch.Tensor  # (mod_count, B / T or n2 / T, A or n1)
    ws_fwd_shoup: torch.Tensor
    wt_inv: torch.Tensor
    wt_inv_shoup: torch.Tensor
    ws_inv: torch.Tensor
    ws_inv_shoup: torch.Tensor

    @property
    def first(self) -> Any:
        """Member 0, whose shape every member shares."""
        return self.members[0]

    @property
    def device(self) -> torch.device:
        return self.col.device

    @staticmethod
    def from_members(plans) -> "RNSColumnPlan":
        if any(_shape(p) != _shape(plans[0]) for p in plans):
            raise ValueError("RNS members must share the kernels' split")
        if any(p.rows is None for p in plans):
            raise ValueError("rows on a nested big-ring plan (logn 27-28) are not stacked")
        w = {f: torch.stack([getattr(p, f) for p in plans]) for f in _W}
        return RNSColumnPlan._build(plans, RNSMergePlan.from_plans([p.col for p in plans]),
                                    RNSMergePlan.from_plans([p.rows for p in plans]), w)

    @staticmethod
    def _build(plans, col: RNSMergePlan, rows: RNSMergePlan, w: dict) -> "RNSColumnPlan":
        members = tuple(dataclasses.replace(p, col=col.members[i], rows=rows.members[i],
                                            **{f: w[f][i] for f in _W})
                        for i, p in enumerate(plans))
        return RNSColumnPlan(members=members, col=col, rows=rows, **w)

    def to(self, device) -> "RNSColumnPlan":
        """This plan with every table on `device`."""
        col = self.col.to(device)
        if col.device == self.device:
            return self
        return RNSColumnPlan._build(self.members, col, self.rows.to(device),
                                    {f: getattr(self, f).to(device) for f in _W})

    def device_bytes(self) -> int:
        """Bytes of every stacked table and constant."""
        return (self.col.device_bytes() + self.rows.device_bytes()
                + sum(getattr(self, f).numel() * 8 for f in _W))


def large_plan(plan: RNSMergePlan) -> RNSColumnPlan:
    """K13's plan of an RNSMergePlan: each member's big-ring plan (the
    route's split, A = 128), stacked; built on the plan's device at first
    use and cached on it.  The members' N-entry tables are never built."""
    if "large" not in plan._lazy:
        plan._lazy["large"] = RNSColumnPlan.from_members([
            hml.LargePlan.from_spec(m.q, m.logn, m.root, m.iroot, m.xnp, m.n_inv,
                                    a_col=hml._route_a_col(m.logn), device=m.device)
            for m in plan.members])
    return plan._lazy["large"]


def fourstep_plan(plan) -> RNSColumnPlan:
    """K14's plan of an RNSFourStepPlan: each member's 4-step kernel plan,
    stacked; built at first use and cached on it (no W table is read)."""
    if "kernel" not in plan._lazy:
        plan._lazy["kernel"] = RNSColumnPlan.from_members([
            hf.FourStepKernelPlan.from_spec(m.q, m.logn, m.n1, m.n2, m.root, m.iroot,
                                            m.n_inv, m.is64, device=m.device)
            for m in plan.members])
    return plan._lazy["kernel"]


# ------------------------------------------------------------ plain versions


def _row_schedule(midx: torch.Tensor, shift: int) -> torch.Tensor:
    return midx.repeat_interleave(1 << shift) if shift else midx


def rns_u64_fwd_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return per_modulus(hm.merge_u64_fwd_plain, plan.members, _row_schedule(midx, shift), x)


def rns_u64_inv_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return per_modulus(hm.merge_u64_inv_plain, plan.members, _row_schedule(midx, shift), x)


def rns_u64_polymul_inv_plain(fa, fb, plan: RNSMergePlan, midx, shift: int = 0):
    """Each modulus's Barrett product (barrett_mul64), then its inverse."""
    return per_modulus(hm.merge_u64_polymul_inv_plain, plan.members,
                        _row_schedule(midx, shift), fa, fb)


def colfwd_plain(x, sp: RNSColumnPlan, midx):
    return per_modulus(hml.colfwd_plain, sp.members, midx, x)


def colinv_plain(x, sp: RNSColumnPlan, midx):
    return per_modulus(hml.colinv_plain, sp.members, midx, x)


def rowmat_plain(x, plan: RNSMergePlan, midx, shift: int, inverse: bool):
    return per_modulus(lambda v, mp: hml.rowmat_plain(v, mp, inverse), plan.members,
                        _row_schedule(midx, shift), x)


def col4_plain(x, sp: RNSColumnPlan, midx, inverse: bool):
    return per_modulus(lambda v, kp: hf.col_plain(v, kp, inverse), sp.members, midx, x)


# ------------------------------------------------------------------ wrappers


def _check(x: torch.Tensor, n: int, device: torch.device, midx: torch.Tensor,
           shift: int) -> None:
    if (x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != n
            or not x.is_contiguous() or x.device != device):
        raise NTTDispatchError(
            f"expected a contiguous (batch, {n}) int64 tensor on {device}, got "
            f"{tuple(x.shape)} {x.dtype} on {x.device} contiguous={x.is_contiguous()}")
    if (midx.dtype != torch.int32 or midx.dim() != 1 or midx.device != device
            or midx.numel() << shift != x.shape[0]):
        raise NTTDispatchError(
            f"expected an int32 schedule of {x.shape[0] >> shift} entries on {device}, got "
            f"{tuple(midx.shape)} {midx.dtype} on {midx.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise NTTDeviceError(f"no RNS kernel for {x.device}")


def _lib(name: str):
    from ._build import library

    return library(name)


def _k12(stats: KernelStats, plain, entry: str, plan: RNSMergePlan, midx, shift, inverse,
         *xs):
    if not takes(plan):
        raise NTTDispatchError(
            f"rns_u64 kernels take u64 plans with every q < 2^62 and logn 11-17, got "
            f"logn={plan.logn} is64={plan.is64}")
    for x in xs:
        _check(x, plan.n, plan.device, midx, shift)
    if xs[0].device.type == "cpu":
        stats.plain_calls += 1
        return plain(*xs, plan, midx, shift)
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    y = torch.empty_like(xs[0])
    _launch(stats, getattr(_lib("merge_u64"), entry), xs[0], *(x.data_ptr() for x in xs),
            y.data_ptr(), xs[0].shape[0], plan.logn, hm.split(plan.logn), midx.data_ptr(),
            midx.numel(), shift, table.data_ptr(), shoup.data_ptr(), plan.consts.data_ptr(),
            int(plan.xnp))
    return y


def rns_u64_fwd(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                shift: int = 0) -> torch.Tensor:
    """K12 forward: row r under modulus midx[r >> shift]."""
    return _k12(FORWARD, rns_u64_fwd_plain, "rns_u64_forward", plan, midx, shift, False, x)


def rns_u64_inv(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                shift: int = 0) -> torch.Tensor:
    """K12 inverse, each row's n^-1 last."""
    return _k12(INVERSE, rns_u64_inv_plain, "rns_u64_inverse", plan, midx, shift, True, x)


def rns_u64_polymul_inv(fa: torch.Tensor, fb: torch.Tensor, plan: RNSMergePlan,
                        midx: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """K12's fused inverse: INTT(fa o fb) per row, the Barrett product
    with the row's modulus fused into the first load."""
    return _k12(POLYMUL_INVERSE, rns_u64_polymul_inv_plain, "rns_u64_polymul_inverse", plan,
                midx, shift, True, fa, fb)


def _col13(stats: KernelStats, entry: str, x, sp: RNSColumnPlan, midx, inverse: bool):
    lp = sp.first
    _check(x, lp.n, sp.device, midx, 0)
    if x.device.type == "cpu":
        stats.plain_calls += 1
        return (colinv_plain if inverse else colfwd_plain)(x, sp, midx)
    col = sp.col
    if inverse:
        tables = (col.inv_tables, col.inv_shoup, sp.wt_inv, sp.wt_inv_shoup, sp.ws_inv,
                  sp.ws_inv_shoup)
    else:
        tables = (col.fwd_tables, col.fwd_shoup, sp.wt_fwd, sp.wt_fwd_shoup, sp.ws_fwd,
                  sp.ws_fwd_shoup)
    y = torch.empty_like(x)
    _launch(stats, getattr(_lib("merge_u64_large"), entry), x, x.data_ptr(), y.data_ptr(),
            x.shape[0], col.logn, lp.B.bit_length() - 1, midx.data_ptr(),
            *(t.data_ptr() for t in tables), lp.tile.bit_length() - 1, col.consts.data_ptr(),
            int(col.xnp))
    return y


def rns_u64_large_colfwd(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor):
    """K13's column kernel forward on a contiguous (batch, A * B) tensor."""
    return _col13(LARGE_COLFWD, "rns_u64_large_colfwd", x, sp, midx, False)


def rns_u64_large_colinv(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor):
    """K13's column kernel inverse on a contiguous (batch, A * B) tensor."""
    return _col13(LARGE_COLINV, "rns_u64_large_colinv", x, sp, midx, True)


def rns_u64_large_rowmat(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                         shift: int, inverse: bool) -> torch.Tensor:
    """K13's row kernel on a contiguous (rows, B) tensor, B = 2..512,
    with the stacked B-point row plans: row r under modulus
    midx[r >> shift].  A block's 2^12 / B rows must lie in one ring of
    2^shift rows (they do whenever the ring has >= 2^12 words)."""
    if not (_narrow(plan) and 1 <= plan.logn <= 9):
        raise NTTDispatchError(
            f"rns_u64_large_rowmat takes u64 row plans with every q < 2^62 and logn 1-9, "
            f"got logn={plan.logn} is64={plan.is64}")
    if ROW_TILE_LOG - plan.logn > shift:
        raise NTTDispatchError(
            f"rows of 2^{plan.logn} words in rings of 2^{shift} rows: a block of "
            f"2^{ROW_TILE_LOG - plan.logn} rows would span two rings")
    _check(x, plan.n, plan.device, midx, shift)
    if x.device.type == "cpu":
        LARGE_ROWMAT.plain_calls += 1
        return rowmat_plain(x, plan, midx, shift, inverse)
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    y = torch.empty_like(x)
    _launch(LARGE_ROWMAT, _lib("merge_u64_large").rns_u64_large_rowmat, x, x.data_ptr(),
            y.data_ptr(), x.shape[0], plan.logn, midx.data_ptr(), midx.numel(), shift,
            table.data_ptr(), shoup.data_ptr(), plan.consts.data_ptr(), int(inverse),
            int(plan.xnp))
    return y


def rns_fourstep_u64_col(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor,
                         inverse: bool) -> torch.Tensor:
    """K14 on a contiguous (batch, N) tensor in the (n2, n1) layout; the
    result in the (n1, n2) layout."""
    kp = sp.first
    if not kp.is64 or kp.n1 > hf.COL_MAX:
        raise NTTDispatchError(f"{FOURSTEP_COL.name} takes u64 plans with n1 <= "
                               f"{hf.COL_MAX}, got is64={kp.is64} n1={kp.n1}")
    _check(x, kp.n, sp.device, midx, 0)
    if x.device.type == "cpu":
        FOURSTEP_COL.plain_calls += 1
        return col4_plain(x, sp, midx, inverse)
    col = sp.col
    tables = ((col.inv_tables, col.inv_shoup, sp.wt_inv, sp.wt_inv_shoup, sp.ws_inv,
               sp.ws_inv_shoup) if inverse else
              (col.fwd_tables, col.fwd_shoup, sp.wt_fwd, sp.wt_fwd_shoup, sp.ws_fwd,
               sp.ws_fwd_shoup))
    entry = f"rns_fourstep_u64_col_{'inv' if inverse else 'fwd'}"
    y = torch.empty_like(x)
    _launch(FOURSTEP_COL, getattr(_lib("fourstep"), entry), x, x.data_ptr(), y.data_ptr(),
            x.shape[0], kp.n1.bit_length() - 1, kp.n2.bit_length() - 1,
            kp.tile.bit_length() - 1, kp.w_tile.bit_length() - 1, midx.data_ptr(),
            *(t.data_ptr() for t in tables), col.consts.data_ptr())
    return y


# --------------------------------------------------------------- composition


class _Steps(NamedTuple):
    fwd: Any          # K12: (x, plan, midx, shift)
    inv: Any
    polymul_inv: Any  # (fa, fb, plan, midx, shift)
    colfwd: Any       # K13 columns: (x, sp, midx)
    colinv: Any
    rowmat: Any       # K13 rows: (x, plan, midx, shift, inverse)
    col4: Any         # K14: (x, sp, midx, inverse)


KERNEL_STEPS = _Steps(rns_u64_fwd, rns_u64_inv, rns_u64_polymul_inv, rns_u64_large_colfwd,
                      rns_u64_large_colinv, rns_u64_large_rowmat, rns_fourstep_u64_col)
PLAIN_STEPS = _Steps(rns_u64_fwd_plain, rns_u64_inv_plain, rns_u64_polymul_inv_plain,
                     colfwd_plain, colinv_plain, rowmat_plain, col4_plain)


def _rows(r, plan: RNSMergePlan, midx, shift: int, inverse: bool, steps: _Steps):
    """The rows of a composition, 2^shift per ring: K13's row kernel up to
    512 words, K12 above."""
    if plan.logn <= 9:
        return steps.rowmat(r, plan, midx, shift, inverse)
    return (steps.inv if inverse else steps.fwd)(r, plan, midx, shift)


def _large(x, sp: RNSColumnPlan, midx, inverse: bool, steps: _Steps):
    lp = sp.first
    log_a = lp.A.bit_length() - 1
    if inverse:
        y = _rows(x.view(-1, lp.B), sp.rows, midx, log_a, True, steps)
        return steps.colinv(y.view(x.shape), sp, midx)
    y = steps.colfwd(x, sp, midx)
    return _rows(y.view(-1, lp.B), sp.rows, midx, log_a, False, steps).view(x.shape)


def _large_polymul_inv(fa, fb, sp: RNSColumnPlan, midx, steps: _Steps):
    lp = sp.first
    if lp.B <= hml.ROW_MAT_MAX:
        raise ValueError("the fused RNS polymul needs rows of 2^11..2^17 words")
    y = steps.polymul_inv(fa.view(-1, lp.B), fb.view(-1, lp.B), sp.rows, midx,
                          lp.A.bit_length() - 1)
    return steps.colinv(y.view(fa.shape), sp, midx)


def _fourstep(x, sp: RNSColumnPlan, midx, inverse: bool, steps: _Steps):
    kp = sp.first
    r = steps.col4(x, sp, midx, inverse).view(-1, kp.n2)
    return _rows(r, sp.rows, midx, kp.n1.bit_length() - 1, inverse, steps).view(x.shape)


def rns_u64_large(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor,
                  inverse: bool = False) -> torch.Tensor:
    """The RNS big-ring merge NTT of each row of a contiguous (batch, N)
    tensor through the kernels (pallas_mxu_large_rns_u64)."""
    return _large(x, sp, midx, inverse, KERNEL_STEPS)


def rns_u64_large_plain(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor,
                        inverse: bool = False) -> torch.Tensor:
    return _large(x, sp, midx, inverse, PLAIN_STEPS)


def rns_u64_large_polymul_inv(fa: torch.Tensor, fb: torch.Tensor, sp: RNSColumnPlan,
                              midx: torch.Tensor) -> torch.Tensor:
    """INTT(fa o fb) with the product fused into K12's row inverse."""
    return _large_polymul_inv(fa, fb, sp, midx, KERNEL_STEPS)


def rns_u64_large_polymul_inv_plain(fa, fb, sp: RNSColumnPlan, midx):
    return _large_polymul_inv(fa, fb, sp, midx, PLAIN_STEPS)


def rns_fourstep(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor,
                 inverse: bool = False) -> torch.Tensor:
    """The RNS 4-step transform of each row of a contiguous (batch, N)
    tensor in the lanes convention, through the kernels
    (fourstep_mxu_rns_lanes)."""
    return _fourstep(x, sp, midx, inverse, KERNEL_STEPS)


def rns_fourstep_plain(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor,
                       inverse: bool = False) -> torch.Tensor:
    return _fourstep(x, sp, midx, inverse, PLAIN_STEPS)
