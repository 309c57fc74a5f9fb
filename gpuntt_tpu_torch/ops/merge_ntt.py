"""Merged radix-2 NTT engine in plain PyTorch.

The port of the JAX package's XLA engine (ops/merge_ntt.py): logn
butterfly stages over a (..., m, 2, t) reshape of the coefficient axis,
with each stage's twiddles a slice of the bit-reversed table.  It runs
on any device and serves every shape no kernel covers (u64 logn
outside 12-28, u32 logn outside 8-25, caller factors that are not
roots of unity, u64 q >= 2^62, u32 q >= 2^30), as `merge_ntt_lanes`
does in the JAX package.  Every stage
keeps canonical residues, so the values between stages are those of
the reference's kernels (ntt.cu:2076-2256) and of the golden NTTCPU.

`ct_stages`/`gs_stages` take an optional stage range, so the main-path
kernels' plain versions (hopper_merge.py, hopper_merge32.py) run the
same network split at the kernels' phase boundary.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..arith.modulus import Modulus
from ..params.bitrev import bitrev_permute, bitreverse_indices
from ..params.merge import NTTParameters, ReductionPolynomial, _power_table
from . import barrett as bo
from .limb import from_numpy_u64, signed, to_numpy_u64


class ButterflyOps(NamedTuple):
    add: Any
    sub: Any
    mulc: Any


@dataclass(frozen=True, eq=False)
class MergePlan:
    """Transform plan: bit-reversed twiddle tables with their Shoup
    companions, as int64 tensors on `device`, plus the modulus
    constants.  `root`/`iroot` are the root pair the tables were built
    from; dispatch routes to the kernels only when they are a genuine
    root of unity and its inverse (`genuine_root`).

    A u64 plan that the big-ring kernels take in both directions
    (`bigring`: q < 2^62, a genuine root, logn 18-28) skips its N-entry
    tables, as the JAX package's does (gpuntt_tpu/ops/merge_ntt.py:
    140-190): the kernels' plan (hopper_merge_large.LargePlan) is
    exponent algebra over the root, and four 2^28-entry tables are 8 GiB.
    The four table fields are then None; `with_tables()` builds them for
    the engine, which calls it.  The JAX package refuses that rebuild
    inside a trace, where the tables would become compiled constants;
    eager torch has no trace, so the rebuild is always allowed and costs
    only the memory and the seconds.

    `twist` is (psi, ipsi) for a plan of the evaluation-twisted transform
    (`from_eval`), None otherwise."""

    logn: int
    q: int
    bit: int
    mu: int
    n_inv: int
    n_inv_shoup: int
    reduction_poly: ReductionPolynomial
    is64: bool
    root: int
    iroot: int
    fwd_table: torch.Tensor | None  # bit-reversed order; None when skipped
    fwd_shoup: torch.Tensor | None
    inv_table: torch.Tensor | None
    inv_shoup: torch.Tensor | None
    device: torch.device
    twist: tuple | None = None
    _moved: dict = dataclasses.field(default_factory=dict, repr=False)
    # lazily built: "tables" (with_tables), "large" (the big-ring plan),
    # ("dist", sp, rank) (a distributed transform's tail, parallel/merge_dist)
    _lazy: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def xnp(self) -> bool:
        return self.reduction_poly == ReductionPolynomial.X_N_plus

    @property
    def genuine_root(self) -> bool:
        """root is a (2)N-th root of unity and iroot its inverse — what
        the kernels' route asks (the JAX package's MXU route refuses
        other factors the same way, pallas_mxu.py:296-298)."""
        order = 2 * self.n if self.xnp else self.n
        return (pow(self.root, order, self.q) == 1
                and self.root * self.iroot % self.q == 1)

    @property
    def bigring(self) -> bool:
        """Every transform of this plan takes the big-ring kernels (the
        route "hopper-merge-large"), so it needs no N-entry table."""
        return (self.is64 and self.q < (1 << 62) and 18 <= self.logn <= 28
                and self.genuine_root)

    @staticmethod
    def from_params(p: NTTParameters, device=None,
                    tables: bool | str = "auto") -> "MergePlan":
        """The plan of `p`.  tables="auto" skips the N-entry tables of a
        `bigring` plan, True builds them always, False never."""
        plan = MergePlan.from_arrays(
            p.modulus.value, p.logn, p.poly_reduction, p.root_of_unity,
            p.inverse_root_of_unity, p.n_inv, None, None, device=device, dtype=p.dtype)
        if tables is True or (tables == "auto" and not plan.bigring):
            return plan.with_tables()
        return plan

    @staticmethod
    def from_arrays(q: int, logn: int, poly: ReductionPolynomial, root: int,
                    iroot: int, n_inv: int, fwd_table, inv_table,
                    device=None, dtype=np.uint64) -> "MergePlan":
        """Plan from plain numbers and numpy tables — the converter that
        carries a plan across from the JAX package.  The tables are in
        the engines' bit-reversed order, as the JAX MergePlan holds them
        (`u64_to_numpy(plan.fwd_table)` for u64), or both None for a plan
        without them (see the class note); `root`/`iroot` and `n_inv` as
        in NTTParameters; `poly` a ReductionPolynomial of either package,
        or its value.  The Shoup companions are derived here.  `device`
        defaults to the first CUDA card; without one that raises
        NTTDeviceError, and the CPU is used only when asked for
        (device="cpu")."""
        from ..common.device import default_device

        poly = ReductionPolynomial(getattr(poly, "value", poly))
        device = torch.device(device) if device is not None else default_device()
        is64 = np.dtype(dtype) == np.uint64
        word = 64 if is64 else 32
        m = Modulus(int(q), bits=word)
        plan = MergePlan(
            logn=int(logn), q=m.value, bit=m.bit, mu=m.mu, n_inv=int(n_inv),
            n_inv_shoup=(int(n_inv) << word) // m.value,
            reduction_poly=poly, is64=is64, root=int(root), iroot=int(iroot),
            fwd_table=None, fwd_shoup=None, inv_table=None, inv_shoup=None,
            device=device)
        if fwd_table is None and inv_table is None:
            return plan
        return plan._with(np.asarray(fwd_table, dtype=np.uint64),
                          np.asarray(inv_table, dtype=np.uint64))

    @staticmethod
    def from_eval(q: int, logn: int, omega: int, iomega: int, psi: int, ipsi: int,
                  n_inv: int, device=None, dtype=np.uint64) -> "MergePlan":
        """The plan of the evaluation-twisted transform
        out[k] = sum_j x_j (psi omega^br(k))^j, omega of order n (the JAX
        package's MXUMergePlan.from_eval): the merge network whose stage s,
        group g multiplies by (psi omega^br(g, s))^(n >> (s + 1)).  Its
        tables are laid out as an X^N + 1 plan's (entry 2^s + g; the
        kernels' and the engine's `xnp` indexing), so `reduction_poly`
        reads X_N_plus whatever the ring; psi = omega = psi_N^2 is the
        X^N + 1 transform, psi = 1 the X^N - 1 one.  A shard of a
        coefficient-sharded transform is one (parallel/merge_dist.py), and
        the kernels take it: `genuine_root` checks omega, not the twist.
        A u64 big ring (`bigring`) skips the N-entry tables, and its
        big-ring plan (hopper_merge_large.LargePlan.from_eval) carries
        the twist."""
        if pow(omega, 1 << logn, q) != 1 or omega * iomega % q != 1 or psi * ipsi % q != 1:
            raise ValueError("from_eval needs omega of order dividing n and the inverse pairs")
        plan = dataclasses.replace(
            MergePlan.from_arrays(q, logn, ReductionPolynomial.X_N_plus, omega, iomega,
                                  n_inv, None, None, device=device, dtype=dtype),
            twist=(psi % q, ipsi % q))
        return plan if plan.bigring else plan.with_tables()

    def _with(self, fwd: np.ndarray, inv: np.ndarray) -> "MergePlan":
        """This plan holding the bit-reversed tables `fwd`, `inv`."""
        if len(fwd) != len(inv) or len(fwd) not in (self.n, 1 << max(self.logn - 1, 0)):
            raise ValueError(f"tables of length {len(fwd)}/{len(inv)} do not "
                             f"fit logn={self.logn}")
        word = 64 if self.is64 else 32

        def dev(table):
            return from_numpy_u64(np.asarray(table, dtype=np.uint64), self.device)

        return dataclasses.replace(
            self, _moved={}, _lazy={},
            fwd_table=dev(fwd), fwd_shoup=dev(bo.shoup_companion(fwd, self.q, word)),
            inv_table=dev(inv), inv_shoup=dev(bo.shoup_companion(inv, self.q, word)))

    def with_tables(self) -> "MergePlan":
        """This plan with its N-entry tables, built from the root pair on
        first call and cached (the engine's; see the class note)."""
        if self.fwd_table is not None:
            return self
        if "tables" not in self._lazy and self.twist is not None:
            self._lazy["tables"] = self._with(
                _eval_table(self.q, self.logn, self.root, self.twist[0]),
                _eval_table(self.q, self.logn, self.iroot, self.twist[1]))
        if "tables" not in self._lazy:
            size = self.n if self.xnp else self.n >> 1
            self._lazy["tables"] = self._with(
                bitrev_permute(np.asarray(_power_table(self.root, self.q, size),
                                          dtype=np.uint64)),
                bitrev_permute(np.asarray(_power_table(self.iroot, self.q, size),
                                          dtype=np.uint64)))
        return self._lazy["tables"]

    def to(self, device) -> "MergePlan":
        """This plan with its tables on `device` (copies are cached).  A
        plan without tables moves its big-ring plan, if it has one."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        if device not in self._moved:
            tables = {f: (getattr(self, f) if getattr(self, f) is None
                          else getattr(self, f).to(device))
                      for f in ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup")}
            lazy = {"large": self._lazy["large"].to(device)} if "large" in self._lazy else {}
            self._moved[device] = dataclasses.replace(
                self, _moved={}, _lazy=lazy, device=device, **tables)
        return self._moved[device]

    def ops(self) -> ButterflyOps:
        q = self.q
        if self.is64:
            return ButterflyOps(
                add=lambda a, b: bo.modadd64(a, b, q),
                sub=lambda a, b: bo.modsub64(a, b, q),
                mulc=lambda x, w, ws: bo.shoup_mul64(x, w, ws, q))
        return ButterflyOps(
            add=lambda a, b: bo.modadd32(a, b, q),
            sub=lambda a, b: bo.modsub32(a, b, q),
            mulc=lambda x, w, ws: bo.shoup_mul32(x, w, ws, q))


def _eval_table(q: int, logn: int, omega: int, psi: int) -> np.ndarray:
    """The heap-ordered twiddles of `from_eval`: entry 2^s + g is
    (psi omega^br(g, s))^(n >> (s + 1)) for stage s and group g < 2^s."""
    out = np.ones(1 << logn, dtype=np.uint64)
    for s in range(logn):
        e = (1 << logn) >> (s + 1)
        pw = np.asarray(_power_table(pow(omega, e, q), q, 1 << s), dtype=np.uint64)
        row = pw[bitreverse_indices(s)].astype(object) * pow(psi, e, q) % q
        out[1 << s:2 << s] = row.astype(np.uint64)
    return out


# ------------------------------------------------------------- transforms


def ct_stages(x, table, shoup, ops: ButterflyOps, log_size: int, xnp: bool,
              stages: range | None = None):
    """Cooley-Tukey butterfly stage sweep along the last axis.

    Stage s (m = 2^s groups, t = N >> (s+1)) pairs j and j+t; with the
    bit-reversed table the group twiddles are table[0:m] (X_N_minus,
    cf. ntt_cpu.cu:102-104) or table[m:2m] (X_N_plus, :107-109).
    `stages` (ascending, default all) runs part of the sweep."""
    n = 1 << log_size
    lead = x.shape[:-1]
    for s in stages if stages is not None else range(log_size):
        m = 1 << s
        t = n >> (s + 1)
        lo, hi = (m, 2 * m) if xnp else (0, m)
        v = x.reshape(lead + (m, 2, t))
        u = v[..., 0, :]
        w = ops.mulc(v[..., 1, :], table[lo:hi, None], shoup[lo:hi, None])
        x = torch.stack([ops.add(u, w), ops.sub(u, w)], dim=-2).reshape(lead + (n,))
    return x


def gs_stages(x, table, shoup, ops: ButterflyOps, log_size: int, xnp: bool,
              stages: range | None = None):
    """Gentleman-Sande (inverse) butterfly stage sweep, no scaling.
    `stages` (descending, default all) runs part of the sweep."""
    n = 1 << log_size
    lead = x.shape[:-1]
    for s in stages if stages is not None else range(log_size - 1, -1, -1):
        h = 1 << s
        t = n >> (s + 1)
        lo, hi = (h, 2 * h) if xnp else (0, h)
        v = x.reshape(lead + (h, 2, t))
        u = v[..., 0, :]
        w = v[..., 1, :]
        lo_o = ops.mulc(ops.sub(u, w), table[lo:hi, None], shoup[lo:hi, None])
        x = torch.stack([ops.add(u, w), lo_o], dim=-2).reshape(lead + (n,))
    return x


def merge_ntt_lanes(x, plan: MergePlan):
    """Forward merged NTT along the last axis (ntt.cu:2076-2256)."""
    plan = plan.with_tables()
    return ct_stages(x, plan.fwd_table, plan.fwd_shoup, plan.ops(), plan.logn,
                     plan.xnp)


def merge_intt_lanes(x, plan: MergePlan, scale: bool = True):
    """Inverse merged NTT (Gentleman-Sande) along the last axis.

    n^-1 scaling happens once at the end, matching the reference's
    last-kernel placement (ntt.cu:1170-1192)."""
    plan = plan.with_tables()
    ops = plan.ops()
    x = gs_stages(x, plan.inv_table, plan.inv_shoup, ops, plan.logn, plan.xnp)
    if scale:
        x = ops.mulc(x, plan.n_inv, signed(plan.n_inv_shoup))
    return x


# ------------------------------------------------- lane <-> numpy boundary


def to_lanes(x, is64: bool, device=None) -> torch.Tensor:
    """numpy -> int64 lane tensor: u64 by bit pattern, u32 by value."""
    if is64:
        return from_numpy_u64(x, device)
    return torch.from_numpy(np.asarray(x, dtype=np.uint32).astype(np.int64)).to(device)


def from_lanes(x: torch.Tensor, is64: bool) -> np.ndarray:
    if is64:
        return to_numpy_u64(x)
    return x.detach().cpu().numpy().astype(np.uint32)
