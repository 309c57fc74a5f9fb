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
         rns_u64_polymul          the two forwards and the fused inverse
                                     in one C call (`rns_u64_polymul`)
    K13  rns_u64_large_colfwd     <- _rns_colfwd_kernel (:375)   merge_u64_large.cu
         rns_u64_large_colinv     <- _rns_colinv_kernel (:388)
         rns_u64_large_rowmat     <- _rns_rowmat_kernel (:448), rows <= 512
    K14  rns_fourstep_u64_col     <- _rns_4step_col_kernel (:629)   fourstep.cu

K12 takes rings of 2^11..2^17 (dispatch routes 2^12..2^17; 2^11 serves
the rows of a 2^18 ring).  K13 is the big-ring composition of
hopper_merge_large.py over stacked LargePlans at logn 18-23 (A = 128,
rows of 2^11..2^16 on K12).  K14 is the 4-step's column kernel over
stacked FourStepKernelPlans at logn 14-23, its rows on K13's row kernel
(512 words, logn 14-16) or on K12 (2^12..2^16 words).  Each family's
limits are its `kernel.Family` record (`K12`, `K13`, `K13_ROWS`, `K14`).
A schedule `midx` is an int32 tensor on the device with entries in [0,
mod_count) (the routes normalise it and keep its copy,
`rns.schedule_memo`); the row kernels take one entry per ring of
2^shift rows.

Each wrapper takes contiguous (batch, N) int64 tensors of u64 bit
patterns on the plan's device.  On a CPU tensor it runs the kernel's
plain version — each modulus's rows through the single-modulus kernel's
plain version with that member's plan — and only there; on a CUDA tensor
it launches the kernel (through ops/kernel.py) or raises.  Every
launch adds one to its kernel's `launches`, every plain-version call
through a wrapper one to `plain_calls`; `tracing.reset()` zeroes both.
`rns_u64_polymul`, given the `Prepared` record of a plan, row count and
schedule on a card (`prepare`), checks its operands against the record
and launches K12's product through one C call: FORWARD counts its two
forwards, POLYMUL_INVERSE its fused inverse, under one ntt.launch span.
The `*_plain` compositions run the plain versions alone, on any device,
which is how the kernels are checked on the card.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..common.errors import NTTDispatchError
from ..common.tracing import KernelStats
from . import hopper_fourstep as hf
from . import hopper_merge as hm
from . import hopper_merge_large as hml
from . import kernel
from .rns import RNSMergePlan, per_modulus, row_schedule

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
# K1-K3's, K7's, K8's and K9's lazy butterflies over stacked tables, every q with 4q < 2^64;
# K13 and K14 are routed over narrower rings than K7's and K9's
K12 = kernel.Family(word=64, q_bits=62, takes=(11, 17), routes=(12, 17))
K13 = kernel.Family(word=64, q_bits=62, takes=None, routes=(18, 23))
K13_ROWS = kernel.Family(word=64, q_bits=62, takes=(1, 9), routes=None)
K14 = kernel.Family(word=64, q_bits=62, takes=None, routes=(14, 23))


def takes(plan: RNSMergePlan) -> bool:
    """Plans K12 takes (`K12.takes`)."""
    return K12.admits(plan.is64, max(plan.qs), plan.logn)


def covers(plan: RNSMergePlan) -> bool:
    """Plans whose transforms dispatch sends to K12 (`K12.routes`, with a
    genuine root for every member, which dispatch checks)."""
    return K12.covers(plan.is64, max(plan.qs), plan.logn)


def covers_large(plan: RNSMergePlan) -> bool:
    """Plans whose transforms dispatch sends to K13 (`K13.routes`, the
    JAX route's top, gpuntt_tpu/ops/dispatch.py:560)."""
    return K13.covers(plan.is64, max(plan.qs), plan.logn)


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
                                    a_col=hml.route_a_col(m.logn), device=m.device)
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


def rns_u64_fwd_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return per_modulus(hm.merge_u64_fwd_plain, plan.members, row_schedule(midx, shift), x)


def rns_u64_inv_plain(x, plan: RNSMergePlan, midx, shift: int = 0):
    return per_modulus(hm.merge_u64_inv_plain, plan.members, row_schedule(midx, shift), x)


def rns_u64_polymul_inv_plain(fa, fb, plan: RNSMergePlan, midx, shift: int = 0):
    """Each modulus's Barrett product (barrett_mul64), then its inverse."""
    return per_modulus(hm.merge_u64_polymul_inv_plain, plan.members,
                        row_schedule(midx, shift), fa, fb)


def colfwd_plain(x, sp: RNSColumnPlan, midx):
    return per_modulus(hml.colfwd_plain, sp.members, midx, x)


def colinv_plain(x, sp: RNSColumnPlan, midx):
    return per_modulus(hml.colinv_plain, sp.members, midx, x)


def rowmat_plain(x, plan: RNSMergePlan, midx, shift: int, inverse: bool):
    return per_modulus(lambda v, mp: hml.rowmat_plain(v, mp, inverse), plan.members,
                        row_schedule(midx, shift), x)


def col4_plain(x, sp: RNSColumnPlan, midx, inverse: bool):
    return per_modulus(lambda v, kp: hf.col_plain(v, kp, inverse), sp.members, midx, x)


# ------------------------------------------------------------------ wrappers


def _k12(stats: KernelStats, plain, plan: RNSMergePlan, midx, shift, inverse, *xs):
    K12.admit(stats.name, plan.is64, max(plan.qs), plan.logn)
    kernel.check(stats.name, (plan.n,), plan.device, *xs, midx=midx, shift=shift)
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    log_a = hm.split(plan.logn)
    return kernel.call(stats, xs, plain, (*xs, plan, midx, shift), stats.name, lambda: (
        plan.logn, log_a, midx.data_ptr(), midx.numel(), shift, table.data_ptr(),
        shoup.data_ptr(), plan.consts.data_ptr(), int(plan.xnp)), log_a=log_a)


def rns_u64_fwd(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                shift: int = 0) -> torch.Tensor:
    """K12 forward: row r under modulus midx[r >> shift]."""
    return _k12(FORWARD, rns_u64_fwd_plain, plan, midx, shift, False, x)


def rns_u64_inv(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                shift: int = 0) -> torch.Tensor:
    """K12 inverse, each row's n^-1 last."""
    return _k12(INVERSE, rns_u64_inv_plain, plan, midx, shift, True, x)


def rns_u64_polymul_inv(fa: torch.Tensor, fb: torch.Tensor, plan: RNSMergePlan,
                        midx: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """K12's fused inverse: INTT(fa o fb) per row, the Barrett product
    with the row's modulus fused into the first load."""
    return _k12(POLYMUL_INVERSE, rns_u64_polymul_inv_plain, plan, midx, shift, True, fa, fb)


class Prepared(NamedTuple):
    """K12's product for one plan, row count and schedule on a card: the
    C entry and its arguments that do not change from call to call."""

    fn: Any             # merge_u64.cu's rns_u64_polymul
    rows: int
    n: int
    device: torch.device
    midx: torch.Tensor  # the schedule on the card, kept alive for its pointer in `args`
    args: tuple         # batch, logn, logA, schedule, entries, shift, tables, consts, xnp


def prepare(plan: RNSMergePlan, midx: torch.Tensor) -> Prepared:
    """The Prepared product of `plan` (on a card) over midx.numel() rows,
    row r under modulus midx[r]; refused as the wrappers refuse a plan."""
    K12.admit(POLYMUL_INVERSE.name, plan.is64, max(plan.qs), plan.logn)
    rows = midx.numel()
    return Prepared(kernel.library("merge_u64").rns_u64_polymul, rows, plan.n, plan.device, midx,
                    (rows, plan.logn, hm.split(plan.logn), midx.data_ptr(), rows, 0,
                     *(t.data_ptr() for t in (plan.fwd_tables, plan.fwd_shoup,
                                              plan.inv_tables, plan.inv_shoup, plan.consts)),
                     int(plan.xnp)))


def rns_u64_polymul(a: torch.Tensor, b: torch.Tensor, prepared: Prepared) -> torch.Tensor:
    """INTT(NTT(a) o NTT(b)) per row of (rows, N) operands, the same
    kernel launches as rns_u64_fwd twice and rns_u64_polymul_inv (three up
    to logn 15, six above), in one C call; an operand the wrappers would
    refuse raises their error."""
    p = prepared
    a, b = a.contiguous(), b.contiguous()
    if not (a.dtype == b.dtype == torch.int64 and a.shape == b.shape == (p.rows, p.n)
            and a.device == b.device == p.device):
        for x in (a, b):  # each as the forward of it would refuse it
            kernel.check(FORWARD.name, (p.n,), p.device, x, midx=p.midx)
    spectra = torch.empty((2, p.rows, p.n), dtype=torch.int64, device=p.device)
    y = torch.empty_like(a)
    fa = spectra.data_ptr()
    kernel.launch(POLYMUL_INVERSE, p.fn, a, a.data_ptr(), b.data_ptr(), fa, fa + 8 * a.numel(),
                  y.data_ptr(), *p.args, kernel="rns_u64_polymul", log_a=p.args[2])
    FORWARD.launches += 2
    return y


def _col13(stats: KernelStats, x, sp: RNSColumnPlan, midx, inverse: bool):
    col, lp = sp.col, sp.first
    K13.admit(stats.name, col.is64, max(col.qs), lp.logn)
    kernel.check(stats.name, (lp.n,), sp.device, x, midx=midx)
    if inverse:
        tables = (col.inv_tables, col.inv_shoup, sp.wt_inv, sp.wt_inv_shoup, sp.ws_inv,
                  sp.ws_inv_shoup)
    else:
        tables = (col.fwd_tables, col.fwd_shoup, sp.wt_fwd, sp.wt_fwd_shoup, sp.ws_fwd,
                  sp.ws_fwd_shoup)
    return kernel.call(stats, (x,), colinv_plain if inverse else colfwd_plain, (x, sp, midx),
                       stats.name, lambda: (
                           col.logn, lp.B.bit_length() - 1, midx.data_ptr(),
                           *(t.data_ptr() for t in tables), lp.tile.bit_length() - 1,
                           col.consts.data_ptr(), int(col.xnp)))


def rns_u64_large_colfwd(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor):
    """K13's column kernel forward on a contiguous (batch, A * B) tensor."""
    return _col13(LARGE_COLFWD, x, sp, midx, False)


def rns_u64_large_colinv(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor):
    """K13's column kernel inverse on a contiguous (batch, A * B) tensor."""
    return _col13(LARGE_COLINV, x, sp, midx, True)


def rns_u64_large_rowmat(x: torch.Tensor, plan: RNSMergePlan, midx: torch.Tensor,
                         shift: int, inverse: bool) -> torch.Tensor:
    """K13's row kernel on a contiguous (rows, B) tensor, B = 2..512,
    with the stacked B-point row plans: row r under modulus
    midx[r >> shift].  A block's 2^12 / B rows must lie in one ring of
    2^shift rows (they do whenever the ring has >= 2^12 words)."""
    K13_ROWS.admit(LARGE_ROWMAT.name, plan.is64, max(plan.qs), plan.logn)
    if ROW_TILE_LOG - plan.logn > shift:
        raise NTTDispatchError(
            f"rows of 2^{plan.logn} words in rings of 2^{shift} rows: a block of "
            f"2^{ROW_TILE_LOG - plan.logn} rows would span two rings")
    kernel.check(LARGE_ROWMAT.name, (plan.n,), plan.device, x, midx=midx, shift=shift)
    table, shoup = ((plan.inv_tables, plan.inv_shoup) if inverse
                    else (plan.fwd_tables, plan.fwd_shoup))
    return kernel.call(LARGE_ROWMAT, (x,), rowmat_plain, (x, plan, midx, shift, inverse),
                       LARGE_ROWMAT.name, lambda: (
                           plan.logn, midx.data_ptr(), midx.numel(), shift, table.data_ptr(),
                           shoup.data_ptr(), plan.consts.data_ptr(), int(inverse),
                           int(plan.xnp)))


def rns_fourstep_u64_col(x: torch.Tensor, sp: RNSColumnPlan, midx: torch.Tensor,
                         inverse: bool) -> torch.Tensor:
    """K14 on a contiguous (batch, N) tensor in the (n2, n1) layout; the
    result in the (n1, n2) layout."""
    col, kp = sp.col, sp.first
    K14.admit(FOURSTEP_COL.name, kp.is64, max(col.qs), kp.logn)
    if kp.n1 > hf.COL_MAX:
        raise NTTDispatchError(f"{FOURSTEP_COL.name} takes plans with n1 <= {hf.COL_MAX}, "
                               f"got n1={kp.n1}")
    kernel.check(FOURSTEP_COL.name, (kp.n,), sp.device, x, midx=midx)
    tables = ((col.inv_tables, col.inv_shoup, sp.wt_inv, sp.wt_inv_shoup, sp.ws_inv,
               sp.ws_inv_shoup) if inverse else
              (col.fwd_tables, col.fwd_shoup, sp.wt_fwd, sp.wt_fwd_shoup, sp.ws_fwd,
               sp.ws_fwd_shoup))
    entry = f"rns_fourstep_u64_col_{'inv' if inverse else 'fwd'}"
    return kernel.call(FOURSTEP_COL, (x,), col4_plain, (x, sp, midx, inverse), entry, lambda: (
        kp.n1.bit_length() - 1, kp.n2.bit_length() - 1, kp.tile.bit_length() - 1,
        kp.w_tile.bit_length() - 1, midx.data_ptr(), *(t.data_ptr() for t in tables),
        col.consts.data_ptr()))


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
    if K13_ROWS.takes_ring(plan.logn):
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
