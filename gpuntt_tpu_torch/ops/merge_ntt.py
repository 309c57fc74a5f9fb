"""Merged radix-2 NTT engine in plain PyTorch.

The port of the JAX package's XLA engine (ops/merge_ntt.py): logn
butterfly stages over a (..., m, 2, t) reshape of the coefficient axis,
with each stage's twiddles a slice of the bit-reversed table.  It runs
on any device and serves every shape no kernel covers (u32, logn
outside 12-17, caller factors that are not roots of unity, wide
moduli), as `merge_ntt_lanes` does in the JAX package.  Every stage
keeps canonical residues, so the values between stages are those of
the reference's kernels (ntt.cu:2076-2256) and of the golden NTTCPU.

`ct_stages`/`gs_stages` take an optional stage range, so the main-path
kernels' plain versions (hopper_merge.py) run the same network split
at the kernels' phase boundary.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from ..arith.modulus import Modulus
from ..params.bitrev import bitrev_permute
from ..params.merge import NTTParameters, ReductionPolynomial
from . import barrett as bo
from .limb import from_numpy_u64, signed, to_numpy_u64


class ButterflyOps(NamedTuple):
    add: Any
    sub: Any
    mulc: Any


@dataclass(frozen=True, eq=False)
class MergePlan:
    """Transform plan: bit-reversed twiddle tables with their Shoup
    companions, as int64 tensors on one device, plus the modulus
    constants.  `root`/`iroot` are the root pair the tables were built
    from; dispatch routes to the kernels only when they are a genuine
    root of unity and its inverse (`genuine_root`)."""

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
    fwd_table: torch.Tensor  # bit-reversed order
    fwd_shoup: torch.Tensor
    inv_table: torch.Tensor
    inv_shoup: torch.Tensor
    _moved: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def n(self) -> int:
        return 1 << self.logn

    @property
    def device(self) -> torch.device:
        return self.fwd_table.device

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

    @staticmethod
    def from_params(p: NTTParameters, device=None) -> "MergePlan":
        return MergePlan.from_arrays(
            p.modulus.value, p.logn, p.poly_reduction, p.root_of_unity,
            p.inverse_root_of_unity, p.n_inv,
            bitrev_permute(p.forward_root_of_unity_table),
            bitrev_permute(p.inverse_root_of_unity_table),
            device=device, dtype=p.dtype)

    @staticmethod
    def from_arrays(q: int, logn: int, poly: ReductionPolynomial, root: int,
                    iroot: int, n_inv: int, fwd_table, inv_table,
                    device=None, dtype=np.uint64) -> "MergePlan":
        """Plan from plain numbers and numpy tables — the converter that
        carries a plan across from the JAX package.  The tables are in
        the engines' bit-reversed order, as the JAX MergePlan holds them
        (`u64_to_numpy(plan.fwd_table)` for u64); `root`/`iroot` and
        `n_inv` as in NTTParameters; `poly` a ReductionPolynomial of
        either package, or its value.  The Shoup companions are derived
        here.  `device` defaults to the first CUDA card, else the CPU."""
        from ..common.device import default_device

        poly = ReductionPolynomial(getattr(poly, "value", poly))
        device = torch.device(device) if device is not None else default_device()
        is64 = np.dtype(dtype) == np.uint64
        word = 64 if is64 else 32
        fwd = np.asarray(fwd_table, dtype=np.uint64)
        inv = np.asarray(inv_table, dtype=np.uint64)
        if len(fwd) != len(inv) or len(fwd) not in (1 << logn, 1 << max(logn - 1, 0)):
            raise ValueError(f"tables of length {len(fwd)}/{len(inv)} do not "
                             f"fit logn={logn}")

        def dev(table):
            return from_numpy_u64(np.asarray(table, dtype=np.uint64), device)

        m = Modulus(int(q), bits=word)
        return MergePlan(
            logn=int(logn), q=m.value, bit=m.bit, mu=m.mu, n_inv=int(n_inv),
            n_inv_shoup=(int(n_inv) << word) // m.value,
            reduction_poly=poly, is64=is64, root=int(root), iroot=int(iroot),
            fwd_table=dev(fwd), fwd_shoup=dev(bo.shoup_companion(fwd, m.value, word)),
            inv_table=dev(inv), inv_shoup=dev(bo.shoup_companion(inv, m.value, word)))

    def to(self, device) -> "MergePlan":
        """This plan with its tables on `device` (copies are cached)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device == self.device:
            return self
        if device not in self._moved:
            self._moved[device] = dataclasses.replace(
                self, _moved={},
                **{f: getattr(self, f).to(device) for f in
                   ("fwd_table", "fwd_shoup", "inv_table", "inv_shoup")})
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
    return ct_stages(x, plan.fwd_table, plan.fwd_shoup, plan.ops(), plan.logn,
                     plan.xnp)


def merge_intt_lanes(x, plan: MergePlan, scale: bool = True):
    """Inverse merged NTT (Gentleman-Sande) along the last axis.

    n^-1 scaling happens once at the end, matching the reference's
    last-kernel placement (ntt.cu:1170-1192)."""
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
