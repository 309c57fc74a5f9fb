"""Every Hopper wrapper through the one kernel-call layer (ops/kernel.py).

For each wrapper entry of ops/hopper_*.py: a CPU operand runs the
kernel's plain version and counts one plain call and no launch; an
operand of another dtype, shape, contiguity or schedule raises
NTTDispatchError naming the kernel; a plan past its family's `Family`
record (q at the record's bound, or a ring below its range) raises
before any operand is looked at.  Rings of 2^12 words or fewer, no JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Callable, NamedTuple

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.common.tracing import KernelStats
from gpuntt_tpu_torch.ops import hopper_fourstep as hf
from gpuntt_tpu_torch.ops import hopper_kmerge as hk
from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
from gpuntt_tpu_torch.ops import kernel

torch.set_num_threads(2)

MINUS, PLUS = tg.ReductionPolynomial.X_N_minus, tg.ReductionPolynomial.X_N_plus
LOGN = 12


class Case(NamedTuple):
    """A wrapper's call: `run(xs, plan, midx)` through the layer, `plain`
    the same call of the kernel's plain version, on operands `xs`."""

    stats: KernelStats
    family: kernel.Family
    plan: Any
    xs: tuple
    midx: torch.Tensor | None
    run: Callable
    plain: Callable


def words(shape, q: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, q, size=shape,
                                                                 dtype=np.int64))


@functools.cache
def params(logn: int, dtype, poly=PLUS, count: int = 1, four: bool = False) -> tuple:
    """`count` NTT parameters at logn on primes just above 2^28 (u32) or
    2^59 (u64), below every record's bound."""
    bits = 29 if dtype == np.uint32 else 60
    mod = tg.Modulus32 if dtype == np.uint32 else tg.Modulus64
    cls = tg.NTTParameters4Step if four else tg.NTTParameters
    return tuple(cls(logn, poly, dtype,
                     factors=tg.NTTFactors(mod(q), *tg.ntt_root_pair(q, logn)))
                 for q in tg.find_ntt_primes(bits, logn, count))


@functools.cache
def merge_plan(logn: int, dtype=np.uint64, poly=PLUS):
    return tg.MergePlan.from_params(params(logn, dtype, poly)[0], device="cpu")


@functools.cache
def rns_plan(logn: int, dtype=np.uint64, poly=PLUS):
    return tg.RNSMergePlan.from_params(list(params(logn, dtype, poly, 2)), device="cpu")


@functools.cache
def large_plan():
    """A big-ring plan of 2^12 words, 8 columns of 512 (K8 rows) in W
    tiles of 128 (a shard of half the columns holds two)."""
    return hml.LargePlan.from_params(params(LOGN, np.uint64, MINUS)[0], a_col=8, tile=128,
                                     device="cpu")


@functools.cache
def fourstep_plan(dtype):
    """The 4-step kernels' plan at 2^12: 32 columns, rows of 128 words."""
    p = params(LOGN, dtype, MINUS, four=True)[0]
    return hf.kernel_plan(tg.FourStepPlan.from_params(p, device="cpu"))


@functools.cache
def rns_fourstep_plan():
    ms = list(params(LOGN, np.uint64, MINUS, 2, four=True))
    return hr.fourstep_plan(tg.RNSFourStepPlan.from_params(ms, device="cpu"))


def _schedule(*entries) -> torch.Tensor:
    return torch.tensor(entries, dtype=torch.int32)


def case_merge64(wrapper: str) -> Case:
    plan = merge_plan(LOGN)
    stats = {"fwd": hm.FORWARD, "inv": hm.INVERSE, "polymul_inv": hm.POLYMUL_INVERSE}[wrapper]
    xs = (words((2, plan.n), plan.q, 1),)
    if wrapper == "polymul_inv":
        xs += (words((2, plan.n), plan.q, 2),)
    fn, plain = getattr(hm, f"merge_u64_{wrapper}"), getattr(hm, f"merge_u64_{wrapper}_plain")
    return Case(stats, hm.FAMILY, plan, xs, None, lambda xs, p, m: fn(*xs, p),
                lambda xs, p, m: plain(*xs, p))


def case_merge32(inverse: bool) -> Case:
    plan = merge_plan(LOGN, np.uint32)
    stats = (hm32.INVERSE if inverse else hm32.FORWARD)[hm32.tpu_kernel(LOGN)]
    fn = hm32.merge_u32_inv if inverse else hm32.merge_u32_fwd
    plain = hm32.merge_u32_inv_plain if inverse else hm32.merge_u32_fwd_plain
    return Case(stats, hm32.FAMILY, plan, (words((2, plan.n), 1 << 32, 3),), None,
                lambda xs, p, m: fn(*xs, p), lambda xs, p, m: plain(*xs, p))


def case_large_col(inverse: bool) -> Case:
    lp = large_plan()
    fn = hml.merge_u64_large_colinv if inverse else hml.merge_u64_large_colfwd
    plain = hml.colinv_plain if inverse else hml.colfwd_plain
    return Case(hml.COLINV if inverse else hml.COLFWD, hml.COLUMNS, lp,
                (words((2, lp.n), 1 << 62, 4),), None, lambda xs, p, m: fn(*xs, p),
                lambda xs, p, m: plain(*xs, p))


def case_large_local(inverse: bool) -> Case:
    lp = large_plan()
    return Case(hml.COLINV_LOCAL if inverse else hml.COLFWD_LOCAL, hml.COLUMNS, lp,
                (words((2, lp.A, lp.B // 2), 1 << 62, 5),), None,
                lambda xs, p, m: hml.col_phase_local(*xs, p, 1, 2, inverse),
                lambda xs, p, m: hml.col_phase_local_plain(*xs, p, 1, 2, inverse))


def case_rowmat(inverse: bool) -> Case:
    rows = large_plan().rows
    return Case(hml.ROWMAT, hml.ROWS, rows, (words((16, rows.n), 1 << 62, 6),), None,
                lambda xs, p, m: hml.merge_u64_large_rowmat(*xs, p, inverse),
                lambda xs, p, m: hml.rowmat_plain(*xs, p, inverse))


def case_fourstep_col(is64: bool) -> Case:
    kp = fourstep_plan(np.uint64 if is64 else np.uint32)
    fn = hf.fourstep_u64_col if is64 else hf.fourstep_u32_col
    return Case(hf.COL64 if is64 else hf.COL32, hf.COLUMNS[is64], kp,
                (words((2, kp.n), 1 << (62 if is64 else 32), 7),), None,
                lambda xs, p, m: fn(*xs, p, True), lambda xs, p, m: hf.col_plain(*xs, p, True))


def case_fourstep_row(is64: bool) -> Case:
    rows = fourstep_plan(np.uint64 if is64 else np.uint32).rows
    x = words((32, rows.n), 1 << (62 if is64 else 32), 8)
    if is64:
        return Case(hf.ROW64, hml.ROWS, rows, (x,), None,
                    lambda xs, p, m: hf.fourstep_u64_row(*xs, p, False),
                    lambda xs, p, m: hml.rowmat_plain(*xs, p, False))
    return Case(hf.ROW32, hm32.FAMILY, rows, (x,), None,
                lambda xs, p, m: hf.fourstep_u32_row(*xs, p, False),
                lambda xs, p, m: hf.row32_plain(*xs, p, False))


def case_rns64(wrapper: str) -> Case:
    plan = rns_plan(LOGN)
    stats = {"fwd": hr.FORWARD, "inv": hr.INVERSE, "polymul_inv": hr.POLYMUL_INVERSE}[wrapper]
    q = min(plan.qs)  # canonical under every modulus
    xs = (words((4, plan.n), q, 9),)
    if wrapper == "polymul_inv":
        xs += (words((4, plan.n), q, 10),)
    fn, plain = getattr(hr, f"rns_u64_{wrapper}"), getattr(hr, f"rns_u64_{wrapper}_plain")
    return Case(stats, hr.K12, plan, xs, _schedule(1, 0, 0, 1),
                lambda xs, p, m: fn(*xs, p, m), lambda xs, p, m: plain(*xs, p, m))


def case_rns64_col(inverse: bool) -> Case:
    sp = hr.large_plan(rns_plan(LOGN, np.uint64, MINUS))
    fn = hr.rns_u64_large_colinv if inverse else hr.rns_u64_large_colfwd
    plain = hr.colinv_plain if inverse else hr.colfwd_plain
    return Case(hr.LARGE_COLINV if inverse else hr.LARGE_COLFWD, hr.K13, sp,
                (words((2, sp.first.n), 1 << 62, 11),), _schedule(1, 0),
                lambda xs, p, m: fn(*xs, p, m), lambda xs, p, m: plain(*xs, p, m))


def case_rns64_rowmat() -> Case:
    rows = rns_plan(9, np.uint64, MINUS)  # a block of 2^12 words: 8 rows of a ring
    return Case(hr.LARGE_ROWMAT, hr.K13_ROWS, rows, (words((16, rows.n), 1 << 62, 12),),
                _schedule(1, 0), lambda xs, p, m: hr.rns_u64_large_rowmat(*xs, p, m, 3, True),
                lambda xs, p, m: hr.rowmat_plain(*xs, p, m, 3, True))


def case_rns64_fourstep() -> Case:
    sp = rns_fourstep_plan()
    return Case(hr.FOURSTEP_COL, hr.K14, sp, (words((2, sp.first.n), 1 << 62, 13),),
                _schedule(0, 1), lambda xs, p, m: hr.rns_fourstep_u64_col(*xs, p, m, False),
                lambda xs, p, m: hr.col4_plain(*xs, p, m, False))


def case_rns32(wrapper: str, dtype) -> Case:
    plan = rns_plan(LOGN, np.uint32)
    stats = {"fwd": hr32.FORWARD, "inv": hr32.INVERSE,
             "polymul_inv": hr32.POLYMUL_INVERSE}[wrapper][hr32.tpu_kernel(LOGN)]
    q = min(plan.qs)
    xs = tuple(words((4, plan.n), q, 14 + k).to(dtype)
               for k in range(2 if wrapper == "polymul_inv" else 1))
    fn, plain = getattr(hr32, f"rns_u32_{wrapper}"), getattr(hr32, f"rns_u32_{wrapper}_plain")
    return Case(stats, hr32.FAMILY, plan, xs, _schedule(0, 1),
                lambda xs, p, m: fn(*xs, p, m, 1), lambda xs, p, m: plain(*xs, p, m, 1))


def case_kmerge(is64: bool) -> Case:
    dtype = np.uint64 if is64 else np.uint32
    kp = hk.KernelMergePlan.from_params(params(LOGN, dtype)[0], device="cpu")
    fn, family = (hk64.kmerge_u64, hk64.FAMILY) if is64 else (hk.kmerge_u32, hk.FAMILY)
    return Case((hk64 if is64 else hk).INVERSE, family, kp,
                (words((2, kp.n), 1 << (62 if is64 else 32), 16),), None,
                lambda xs, p, m: fn(*xs, p, True),
                lambda xs, p, m: hk.kmerge_plain(*xs, p, True))


CASES = {
    **{f"merge_u64_{w}": functools.partial(case_merge64, w) for w in ("fwd", "inv", "polymul_inv")},
    "merge_u32_fwd": functools.partial(case_merge32, False),
    "merge_u32_inv": functools.partial(case_merge32, True),
    "merge_u64_large_colfwd": functools.partial(case_large_col, False),
    "merge_u64_large_colinv": functools.partial(case_large_col, True),
    "merge_u64_large_colfwd_local": functools.partial(case_large_local, False),
    "merge_u64_large_colinv_local": functools.partial(case_large_local, True),
    "merge_u64_large_rowmat": functools.partial(case_rowmat, True),
    "fourstep_u64_col": functools.partial(case_fourstep_col, True),
    "fourstep_u32_col": functools.partial(case_fourstep_col, False),
    "fourstep_u64_row": functools.partial(case_fourstep_row, True),
    "fourstep_u32_row": functools.partial(case_fourstep_row, False),
    **{f"rns_u64_{w}": functools.partial(case_rns64, w) for w in ("fwd", "inv", "polymul_inv")},
    "rns_u64_large_colfwd": functools.partial(case_rns64_col, False),
    "rns_u64_large_colinv": functools.partial(case_rns64_col, True),
    "rns_u64_large_rowmat": case_rns64_rowmat,
    "rns_fourstep_u64_col": case_rns64_fourstep,
    **{f"rns_u32_{w}_{d}": functools.partial(case_rns32, w, getattr(torch, d))
       for w in ("fwd", "inv", "polymul_inv") for d in ("int64", "int32")},
    "kmerge_u32": functools.partial(case_kmerge, False),
    "kmerge_u64": functools.partial(case_kmerge, True),
}


def _bad_operands(c: Case) -> dict:
    """name -> (xs, midx): operands the wrapper must refuse."""
    x, rest = c.xs[0], c.xs[1:]
    strided = torch.cat([x, x], dim=-1)[..., ::2]  # x's shape and values, not contiguous
    bad = {"dtype": ((x.to(torch.int16), *rest), c.midx),
           "shape": ((x[..., :-1].contiguous(), *rest), c.midx),
           "contiguity": ((strided, *rest), c.midx)}
    if rest:
        bad["second operand's rows"] = ((x, rest[0][:1].contiguous()), c.midx)
    if c.midx is not None:
        bad["schedule dtype"] = (c.xs, c.midx.long())
        bad["schedule length"] = (c.xs, c.midx[:-1].contiguous())
    return bad


def _past(plan, family: kernel.Family, **fields):
    """`plan` with `fields` replaced, on the stacked plans of the RNS
    column kernels in their column plan."""
    if isinstance(plan, hr.RNSColumnPlan):
        return dataclasses.replace(plan, col=_past(plan.col, family, **fields))
    if "q" in fields and hasattr(plan, "qs"):
        fields["qs"] = (fields.pop("q"),) * len(plan.qs)
    return dataclasses.replace(plan, **fields)


@pytest.mark.parametrize("what", ["plain", "operands", "plan"])
@pytest.mark.parametrize("wrapper", sorted(CASES))
def test_wrapper_through_the_kernel_layer(wrapper, what):
    c = CASES[wrapper]()
    tracing.reset()
    if what == "plain":
        got = c.run(c.xs, c.plan, c.midx)
        counts = tracing.snapshot()["kernels"]
        assert {k: v for k, v in counts.items() if v != {"launches": 0, "plain_calls": 0}} == \
            {c.stats.name: {"launches": 0, "plain_calls": 1}}
        want = c.plain(c.xs, c.plan, c.midx)
        assert got.dtype == c.xs[0].dtype and torch.equal(got, want)
        return
    if what == "operands":
        for name, (xs, midx) in _bad_operands(c).items():
            with pytest.raises(tg.NTTDispatchError, match=re.escape(c.stats.name)):
                c.run(xs, c.plan, midx)
    else:
        fam = c.family
        refused = [_past(c.plan, fam, q=1 << fam.q_bits)]
        if fam.takes is not None:
            refused.append(_past(c.plan, fam, logn=fam.takes[0] - 1))
        for plan in refused:
            with pytest.raises(tg.NTTDispatchError,
                               match=re.escape(f"{c.stats.name} takes u{fam.word} plans")):
                c.run(c.xs, plan, c.midx)
    assert all(k.launches == 0 and k.plain_calls == 0 for k in tracing._KERNELS)
