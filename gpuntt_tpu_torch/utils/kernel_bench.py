"""Check and time the kernels of csrc/merge_u64.cu (K1-K3, K12),
csrc/merge_u32.cu, csrc/merge_u64_large.cu (K7, K7', K8, K13),
csrc/fourstep.cu (K9, K11-col, K14) and csrc/kmerge.cu (K15, K17) on one
CUDA card.

    python3 gpuntt_tpu_torch/utils/kernel_bench.py            # all of them
    python3 gpuntt_tpu_torch/utils/kernel_bench.py kmerge     # K15, K17 only
    python3 gpuntt_tpu_torch/utils/kernel_bench.py variants   # kmerge.cu's variants
    python3 gpuntt_tpu_torch/utils/kernel_bench.py probe      # the modmul-peak probe

Imports `gpuntt_tpu_torch` from the Python path, not relative to this
file, so one copy of the script times two trees on one card, one after the other:

    PYTHONPATH=<other tree> python3 gpuntt_tpu_torch/utils/kernel_bench.py

It builds the libraries (printing what `-Xptxas -v` says of each
kernel), holds every wrapper against its plain version on the card at
the value edges (exact equality), then times each kernel at the cells of
PERF.md section 6 with CUDA events (utils/timing.time_cuda: 3 warm-ups,
the median of 10 windows of 10 calls) and the end-to-end entries at u32
2^20 x 16, u64 2^16 x 128, 2^24 x 1 and 2^27 x 1 and the 4-step u64 2^24
x 1.  The fused inverses multiply two different spectra, so every b word
is read from memory.  `kmerge` builds, checks and times csrc/kmerge.cu
alone (check_kmerge, kmerge_timings).  `variants` compiles copies of
kmerge.cu with the design alternatives of KMERGE_VARIANTS substituted
for the shipped constants (only the shipped ones are in the source),
holds each to the plain versions and times them in two turns.  `probe`
builds csrc/probe.cu, holds its chain to the plain version at the edges,
then reads measure_modmul_peak ten times a word size while a thread
samples the card's SM clock and power draw (`probe_rates`).  The last
line is one JSON object of {name: [ms, spread]} ({name: [min, max]
products a second] for `probe`).  Exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import gpuntt_tpu_torch as g
from gpuntt_tpu_torch.arith.host import is_prime_u64
from gpuntt_tpu_torch.ops import _build
from gpuntt_tpu_torch.ops import hopper_fourstep as hf
from gpuntt_tpu_torch.ops import hopper_kmerge as hk
from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
from gpuntt_tpu_torch.ops.limb import from_numpy_u64
from gpuntt_tpu_torch.utils.timing import time_cuda

PLUS, MINUS = g.ReductionPolynomial.X_N_plus, g.ReductionPolynomial.X_N_minus


def largest_ntt_prime(bits: int, logn: int) -> int:
    """The largest prime q < 2^bits with 2^(logn + 1) | q - 1: the widest
    modulus a word size's kernels take at logn (bits 62 for u64, 30 for
    u32, where their lazy butterflies keep 4q below the word)."""
    step = 2 << logn
    k = ((1 << bits) - 2) // step
    while k > 0 and not is_prime_u64(k * step + 1):
        k -= 1
    if k == 0:
        raise ValueError(f"no NTT prime below 2^{bits} for logn {logn}")
    return k * step + 1


def params(logn: int, poly, dtype, q: int | None = None):
    if q is None:
        return g.NTTParameters(logn, poly, dtype)
    om, psi = g.ntt_root_pair(q, logn)
    mod = g.Modulus64(q) if dtype == np.uint64 else g.Modulus32(q)
    return g.NTTParameters(logn, poly, dtype, factors=g.NTTFactors(mod, om, psi))


def words(rng, shape, bits: int, dev) -> torch.Tensor:
    """Any `bits`-bit words as int64 lanes (u64: the same 64 bits)."""
    x = rng.integers(0, 1 << bits, size=shape, dtype=np.uint64, endpoint=False)
    return from_numpy_u64(x, dev)


def same(got, want, what: str) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel != plain version")
    print(f"ok   {what}")


def ptxas_lines(name: str) -> None:
    """Registers, shared memory and spills of each kernel of a build."""
    log = _build.build_info.get(name, {}).get("log", "")
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'|Function properties for (\w+)", line)
        if m:
            fn = m.group(1) or m.group(2)
        elif "registers" in line or "spill" in line:
            print(f"ptxas {name} {fn}: {line.split('info    :')[-1].strip()}")


def odd_word(x: torch.Tensor) -> torch.Tensor:
    """A copy of x in a view that starts at an odd word (8 bytes past a
    16-byte boundary), as flat[1:1 + x.numel()] of a fresh tensor does."""
    flat = torch.zeros(x.numel() + 2, dtype=x.dtype, device=x.device)
    start = 1 if flat.data_ptr() % 16 == 0 else 0
    v = flat[start:start + x.numel()].view(x.shape)
    v.copy_(x)
    return v


def check_merge(dev, rng) -> None:
    """K1-K3 (merge_u64_fwd / _inv / _polymul_inv) at logn 11-17, every
    (log A, log B) split, both polynomials, at the 60-bit pool prime and
    the largest NTT prime below 2^62 (4q just below 2^64), on any u64
    word; K12 (rns_u64_*) on a ladder of that prime and a 61-bit one,
    with a schedule entry a ring and one for two rings; and both on
    odd-word views (F4: 8-byte accesses where 16-byte ones would be
    misaligned)."""
    for logn in range(11, 18):
        q62, q61 = largest_ntt_prime(62, 17), largest_ntt_prime(61, 17)
        for poly in (MINUS, PLUS):
            x = words(rng, (3, 1 << logn), 64, dev)
            for q in (None, q62):
                plan = g.MergePlan.from_params(params(logn, poly, np.uint64, q), device=dev)
                what = f"logn {logn} {poly.name} q={plan.q}"
                fx = hm.merge_u64_fwd(x, plan)
                same(fx, hm.merge_u64_fwd_plain(x, plan), f"K1 {what}")
                same(hm.merge_u64_inv(x, plan), hm.merge_u64_inv_plain(x, plan), f"K2 {what}")
                fb = fx.flip(0).contiguous()
                same(hm.merge_u64_polymul_inv(fx, fb, plan),
                     hm.merge_u64_polymul_inv_plain(fx, fb, plan), f"K3 {what}")
                xo, fo = odd_word(x), odd_word(fb)
                same(hm.merge_u64_fwd(xo, plan), fx, f"K1 odd-word view {what}")
                same(hm.merge_u64_inv(xo, plan), hm.merge_u64_inv_plain(x, plan),
                     f"K2 odd-word view {what}")
                same(hm.merge_u64_polymul_inv(fx, fo, plan),
                     hm.merge_u64_polymul_inv_plain(fx, fb, plan), f"K3 odd-word view {what}")
            ladder = g.RNSMergePlan.from_params(
                [params(logn, poly, np.uint64, q) for q in (q62, q61)], device=dev)
            for midx, shift in (([1, 0, 1], 0), ([1, 0], 1)):
                m = torch.tensor(midx, dtype=torch.int32, device=dev)
                xr = words(rng, (len(midx) << shift, 1 << logn), 64, dev)
                what = f"logn {logn} {poly.name} shift {shift}"
                fx = hr.rns_u64_fwd(xr, ladder, m, shift)
                same(fx, hr.rns_u64_fwd_plain(xr, ladder, m, shift), f"K12 forward {what}")
                same(hr.rns_u64_inv(xr, ladder, m, shift), hr.rns_u64_inv_plain(xr, ladder, m, shift),
                     f"K12 inverse {what}")
                fb = hr.rns_u64_fwd_plain(xr.flip(0).contiguous(), ladder, m, shift)
                same(hr.rns_u64_polymul_inv(fx, odd_word(fb), ladder, m, shift),
                     hr.rns_u64_polymul_inv_plain(fx, fb, ladder, m, shift),
                     f"K12 fused inverse (b an odd-word view) {what}")
                same(hr.rns_u64_fwd(odd_word(xr), ladder, m, shift), fx,
                     f"K12 forward odd-word view {what}")


def check_k8(dev, rng) -> None:
    """K8 (merge_u64_large_rowmat) at logB 1-9, both directions, both
    polynomials, the 61-bit pool prime and the largest 62-bit NTT prime;
    and its Stacked twin (rns_u64_large_rowmat) on a ladder of two."""
    q62 = largest_ntt_prime(62, 9)
    for logb in range(1, 10):
        for poly in (MINUS, PLUS):
            for q in (None, q62):
                plan = g.MergePlan.from_params(params(logb, poly, np.uint64, q), device=dev)
                x = words(rng, (4099 << (9 - logb), 1 << logb), 64, dev)
                for inverse in (False, True):
                    want = hml.rowmat_plain(x, plan, inverse)
                    same(hml.merge_u64_large_rowmat(x, plan, inverse), want,
                         f"K8 logB {logb} {poly.name} q={plan.q} inverse={inverse}")
                    same(hml.merge_u64_large_rowmat(odd_word(x), plan, inverse), want,
                         f"K8 odd-word view logB {logb} {poly.name} q={plan.q} "
                         f"inverse={inverse}")
    for logb in (3, 9):
        ms = [params(logb, MINUS, np.uint64, q) for q in (q62, largest_ntt_prime(61, 9))]
        plan = g.RNSMergePlan.from_params(ms, device=dev)
        shift = 12 - logb
        midx = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
        x = words(rng, (3 << shift, 1 << logb), 64, dev)
        for inverse in (False, True):
            same(hr.rns_u64_large_rowmat(x, plan, midx, shift, inverse),
                 hr.rowmat_plain(x, plan, midx, shift, inverse),
                 f"K13-row logB {logb} inverse={inverse}")


def _large(q: int, logn: int, poly, log_a: int, dev, tile: int | None = None):
    om, psi = g.ntt_root_pair(q, logn)
    root = psi if poly == PLUS else om
    return hml.LargePlan.from_spec(q, logn, root, pow(root, q - 2, q), poly == PLUS,
                                   pow(1 << logn, q - 2, q), a_col=1 << log_a, tile=tile,
                                   device=dev)


def _fourstep(q: int, logn: int, poly, log1: int, is64: bool, dev):
    om, psi = g.ntt_root_pair(q, logn)
    root = psi if poly == PLUS else om
    return hf.FourStepKernelPlan.from_spec(q, logn, 1 << log1, 1 << (logn - log1), root,
                                           pow(root, q - 2, q), pow(1 << logn, q - 2, q),
                                           is64, device=dev)


def check_cols(dev, rng) -> None:
    """The column kernels at every logA / log n1 1-9, both directions,
    both polynomials, at the largest NTT prime below the lazy bound (2^62
    for u64, 2^30 for u32) and a smaller one: K7 (2^14-word rings, so
    that A = 128-512 run their full-tile instances), K7' on both shards
    of sp = 2, K13-col on a ladder of those two (rows of 512), K9 and
    K11-col (2^14-word rings), K14 on the u64 ladder."""
    q62, q61 = largest_ntt_prime(62, 18), largest_ntt_prime(61, 18)
    q30, q29 = largest_ntt_prime(30, 14), largest_ntt_prime(29, 14)
    for log_a in range(1, 10):
        for poly in (MINUS, PLUS):
            x = words(rng, (3, 1 << 14), 64, dev)
            for q in (q62, q61):
                lp = _large(q, 14, poly, log_a, dev, tile=1 << (13 - log_a))
                what = f"logA {log_a} {poly.name} q={q}"
                same(hml.merge_u64_large_colfwd(x, lp), hml.colfwd_plain(x, lp), f"K7 {what}")
                same(hml.merge_u64_large_colinv(x, lp), hml.colinv_plain(x, lp),
                     f"K7 inverse {what}")
                x3 = x.view(3, lp.A, lp.B)
                for shard in (0, 1):
                    xs = x3[:, :, shard * lp.B // 2:(shard + 1) * lp.B // 2].contiguous()
                    for inverse in (False, True):
                        same(hml.col_phase_local(xs, lp, shard, 2, inverse),
                             hml.col_phase_local_plain(xs, lp, shard, 2, inverse),
                             f"K7' shard {shard} of 2 inverse={inverse} {what}")
            sp = hr.RNSColumnPlan.from_members(
                [_large(q, log_a + 9, poly, log_a, dev) for q in (q62, q61)])
            midx = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
            x = words(rng, (3, 1 << (log_a + 9)), 64, dev)
            same(hr.rns_u64_large_colfwd(x, sp, midx), hr.colfwd_plain(x, sp, midx),
                 f"K13-col logA {log_a} {poly.name}")
            same(hr.rns_u64_large_colinv(x, sp, midx), hr.colinv_plain(x, sp, midx),
                 f"K13-col inverse logA {log_a} {poly.name}")
    for log1 in range(1, 10):
        for poly in (MINUS, PLUS):
            for is64, qs in ((True, (q62, q61)), (False, (q30, q29))):
                x = words(rng, (3, 1 << 14), 64 if is64 else 32, dev)
                name, fn = ("K9", hf.fourstep_u64_col) if is64 else ("K11-col",
                                                                      hf.fourstep_u32_col)
                for q in qs:
                    kp = _fourstep(q, 14, poly, log1, is64, dev)
                    for inverse in (False, True):
                        same(fn(x, kp, inverse), hf.col_plain(x, kp, inverse),
                             f"{name} log n1 {log1} {poly.name} q={q} inverse={inverse}")
            sp = hr.RNSColumnPlan.from_members([_fourstep(q, 14, poly, log1, True, dev)
                                                for q in (q62, q61)])
            midx = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
            x = words(rng, (3, 1 << 14), 64, dev)
            for inverse in (False, True):
                same(hr.rns_fourstep_u64_col(x, sp, midx, inverse),
                     hr.col4_plain(x, sp, midx, inverse),
                     f"K14 log n1 {log1} {poly.name} inverse={inverse}")


def check_u32(dev, rng) -> None:
    """merge_u32.cu at every logn 7-25 (forward and inverse) and the fused
    RNS polymul inverse, at the largest NTT prime below 2^30 of each logn."""
    for logn in range(7, 26):
        q = largest_ntt_prime(30, logn)
        poly = PLUS if logn % 2 else MINUS
        plan = g.MergePlan.from_params(params(logn, poly, np.uint32, q), device=dev)
        batch = max(1, (1 << 21) >> logn)
        x = words(rng, (batch, 1 << logn), 32, dev)
        fx = hm32.merge_u32_fwd(x, plan)
        same(fx, hm32.merge_u32_fwd_plain(x, plan), f"u32 logn {logn} q={q} forward")
        same(hm32.merge_u32_inv(x, plan), hm32.merge_u32_inv_plain(x, plan),
             f"u32 logn {logn} q={q} inverse")
        if logn >= 8:
            ms = [params(logn, poly, np.uint32, p)
                  for p in (q, largest_ntt_prime(29, logn))]
            rplan = g.RNSMergePlan.from_params(ms, device=dev)
            midx = torch.tensor([1, 0], dtype=torch.int32, device=dev)
            a = words(rng, (2, 1 << logn), 32, dev)
            b = words(rng, (2, 1 << logn), 32, dev)
            same(hr32.rns_u32_polymul_inv(a, b, rplan, midx),
                 hr32.rns_u32_polymul_inv_plain(a, b, rplan, midx),
                 f"u32 RNS logn {logn} fused polymul inverse")


def check_kmerge(dev, rng) -> None:
    """K15 (kmerge_u64) and K17 (kmerge_u32) at every logn 7-17 (the
    one-block form, one and two column runs), both polynomials, forward
    and inverse, on any input word and on an odd-word view of it: u64 at
    the 60-bit pool prime and the largest NTT prime below 2^62 (the lazy
    instance, 4q just below 2^64) and the largest below 2^63 (the
    canonical instance), u32 at the pool prime and the largest below
    2^30."""
    for logn in range(7, 18):
        for poly in (MINUS, PLUS):
            for dtype, fn, qs in (
                    (np.uint64, hk64.kmerge_u64,
                     (None, largest_ntt_prime(62, logn), largest_ntt_prime(63, logn))),
                    (np.uint32, hk.kmerge_u32, (None, largest_ntt_prime(30, logn)))):
                x = words(rng, (3, 1 << logn), 64 if dtype == np.uint64 else 32, dev)
                for q in qs:
                    kp = hk.KernelMergePlan.from_params(params(logn, poly, dtype, q), device=dev)
                    for inverse in (False, True):
                        what = (f"{fn.__name__} logn {logn} {poly.name} q={kp.q} "
                                f"inverse={inverse}")
                        want = hk.kmerge_plain(x, kp, inverse)
                        same(fn(x, kp, inverse), want, what)
                        same(fn(odd_word(x), kp, inverse), want, f"{what} odd-word view")


# kmerge_timings' cells: (word, logn, batch, bits), bits None for the pool
# prime, else the largest NTT prime below 2^bits: the headline cells
# (2^16 x 128), both sides of the one-block limit, 2^20 x 16, and K15's
# canonical instance at a 63-bit prime
KMERGE_CELLS = [(64, 16, 128, None), (64, 16, 128, 63), (64, 13, 128, None),
                (64, 14, 128, None), (64, 20, 16, None), (32, 16, 128, None),
                (32, 14, 128, None), (32, 15, 128, None), (32, 20, 16, None)]


def _kmerge_cell(dev, rng, word: int, logn: int, batch: int, bits):
    """(plan, canonical input, name) of a KMERGE_CELLS cell, X^N + 1."""
    q = largest_ntt_prime(bits, logn) if bits else None
    kp = hk.KernelMergePlan.from_params(
        params(logn, PLUS, np.uint64 if word == 64 else np.uint32, q), device=dev)
    x = words(rng, (batch, 1 << logn), word, dev) % kp.q
    policy = "canonical" if kp.q >= 1 << 62 else "lazy"
    return kp, x, f"u{word} 2^{logn}x{batch}" + (f" q={kp.q} ({policy})" if bits else "")


def kmerge_timings(dev, rng, t) -> None:
    """K15 and K17, both directions, at KMERGE_CELLS."""
    for word, logn, batch, bits in KMERGE_CELLS:
        kp, x, cell = _kmerge_cell(dev, rng, word, logn, batch, bits)
        fn, k = (hk64.kmerge_u64, "K15") if word == 64 else (hk.kmerge_u32, "K17")
        t(f"{k} fwd {cell}", lambda: fn(x, kp))
        t(f"{k} inv {cell}", lambda: fn(x, kp, True))


# kmerge.cu's design variants (PERF.md section 6): (shipped text, variant
# text, times it occurs) substitutions into the source, and the W layout
# the variant's entries take: "kernel", the plan's interleaved W (one
# pointer); "pair", W and its companion as two tables (two pointers)
_PAIR = [
    ("  const uint64_t* w;\n  const uint64_t* row;",
     "  const uint64_t* w;\n  const uint64_t* ws;\n  const uint64_t* row;", 1),
    ("P::wtw(t.w, ", "P::tw(t.w, t.ws, ", 4),
    ("const uint64_t* cols, const uint64_t* w,", "const uint64_t* cols, const uint64_t* w, "
     "const uint64_t* ws,", 4),
    ("{col, cols, w, row, rows}", "{col, cols, w, ws, row, rows}", 4),
]
KMERGE_VARIANTS = {
    "shipped": ([], "kernel"),
    "W as two tables": (_PAIR, "pair"),
    "cols C=16 at every run": (
        [("  return kLogColTile - L < kLogRow ? kLogColTile - L : kLogRow;", "  return 4;", 1)],
        "kernel"),
    "cols tile 2^12 (u64 4 blocks)": (
        [("constexpr int kLogColTile = 13;", "constexpr int kLogColTile = 12;", 1),
         ("constexpr int kColBlocks = sizeof(T) == 8 ? 3 : 4;", "constexpr int kColBlocks = 4;",
          1)], "kernel"),
    "rows R=16": ([("constexpr int kLogRows = 5;", "constexpr int kLogRows = 4;", 1)], "kernel"),
    "rows R=64 (3 blocks)": (
        [("constexpr int kLogRows = 5;", "constexpr int kLogRows = 6;", 1),
         ("constexpr int kRowBlocks = 4;", "constexpr int kRowBlocks = 3;", 1)], "kernel"),
    "one block up to 2^13": ([("constexpr int kLogTile = 14;", "constexpr int kLogTile = 13;",
                               1)], "kernel"),
    "one block up to 2^15 u32": (
        [("constexpr int kLogTile = 14;", "constexpr int kLogTile = 15;", 1),
         ("  if (logn <= kLogTile) return run_whole<P, true>",
          "  if (logn <= kLogTile - (sizeof(typename P::T) == 8)) return run_whole<P, true>", 1),
         ("  if (logn <= kLogTile) return run_whole<P, false>",
          "  if (logn <= kLogTile - (sizeof(typename P::T) == 8)) return run_whole<P, false>",
          1)], "kernel"),
}


def _variant_libs(names) -> dict:
    """Each variant of `names` compiled from csrc/kmerge.cu (nvcc, all at
    once, with _build's flags) and loaded: {name: (CDLL, ptxas log)}."""
    root = tempfile.mkdtemp(prefix="kmerge_variants_")
    with open(os.path.join(_build._CSRC, "kmerge.cu")) as f:
        shipped = f.read()
    jobs = {}
    for i, name in enumerate(names):
        src = shipped
        for old, new, count in KMERGE_VARIANTS[name][0]:
            if src.count(old) != count:
                raise ValueError(f"variant {name!r}: {old!r} is not in kmerge.cu {count} times")
            src = src.replace(old, new)
        d = os.path.join(root, str(i))
        os.makedirs(d)
        for h in os.listdir(_build._CSRC):
            if h.endswith(".cuh"):
                with open(os.path.join(_build._CSRC, h)) as f, open(os.path.join(d, h), "w") as o:
                    o.write(f.read())
        with open(os.path.join(d, "kmerge.cu"), "w") as o:
            o.write(src)
        so = os.path.join(d, "libkmerge.so")
        jobs[name] = (so, subprocess.Popen([_build._nvcc(), *_build._FLAGS, "-o", so,
                                            os.path.join(d, "kmerge.cu")],
                                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"variant {name!r}: nvcc failed:\n{err}")
        lib = ctypes.CDLL(so)
        for entry, argtypes in _build._ENTRIES["kmerge"].items():
            if KMERGE_VARIANTS[name][1] == "pair":  # the companion's pointer after W's
                argtypes = argtypes[:8] + [ctypes.c_void_p] + argtypes[8:]
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, out + err)
    return libs


def _variant_call(lib, w_mode: str, x, kp, inverse: bool, pairs: dict):
    """One call of a variant's entry, as hopper_kmerge.launch makes it;
    `pairs` caches the "pair" layout's contiguous tables."""
    col, cols, wk, row, rows = kp.tables(inverse)
    ws = []
    if w_mode == "pair":
        key = (id(kp), inverse)
        if key not in pairs:
            pairs[key] = (kp, *(t.contiguous() for t in kp.w(inverse)))
        wk, ws = pairs[key][1], [pairs[key][2]]
    y = torch.empty_like(x)
    consts = [kp.q, (1 << kp.word) // kp.q] + ([kp.n_inv, kp.n_inv_s] if inverse else [])
    entry = getattr(lib, f"kmerge_u{kp.word}_{'inverse' if inverse else 'forward'}")
    rc = entry(x.device.index, x.data_ptr(), y.data_ptr(), x.shape[0], kp.logn,
               *(v.data_ptr() for v in (col, cols, wk, *ws, row, rows)), *consts, int(kp.xnp),
               torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"kmerge variant launch failed: cudaError {rc}")
    return y


def variants(dev, rng, t) -> None:
    """Every KMERGE_VARIANTS entry: built, held to the plain versions at
    logn 12-17 (u64 at the pool prime and a 63-bit one, u32), then timed
    at KMERGE_CELLS in two turns (the variants in order, then reversed)."""
    t0 = time.perf_counter()
    libs = _variant_libs(list(KMERGE_VARIANTS))
    print(f"variant builds {time.perf_counter() - t0:.1f} s")
    pairs: dict = {}
    for name, (lib, log) in libs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.split('info    :')[-1].strip()}")
        w_mode = KMERGE_VARIANTS[name][1]
        for logn in range(12, 18):
            for dtype, q in ((np.uint64, None), (np.uint64, largest_ntt_prime(63, logn)),
                             (np.uint32, None)):
                kp = hk.KernelMergePlan.from_params(params(logn, PLUS, dtype, q), device=dev)
                x = words(rng, (3, 1 << logn), 64 if dtype == np.uint64 else 32, dev)
                for inverse in (False, True):
                    same(_variant_call(lib, w_mode, x, kp, inverse, pairs),
                         hk.kmerge_plain(x, kp, inverse),
                         f"variant {name} u{kp.word} logn {logn} q={kp.q} inverse={inverse}")
    cells = [_kmerge_cell(dev, rng, *c) for c in KMERGE_CELLS]
    for turn, order in enumerate((list(libs), list(libs)[::-1])):
        for name in order:
            lib, w_mode = libs[name][0], KMERGE_VARIANTS[name][1]
            for kp, x, cell in cells:
                for inverse in (False, True):
                    t(f"{name} | {'inv' if inverse else 'fwd'} {cell} | turn {turn}",
                      lambda: _variant_call(lib, w_mode, x, kp, inverse, pairs))


PROBE_QS = {True: 576460756061519873, False: 469762049}  # the pool primes


def probe_rates(dev, rng, repeats: int = 10) -> dict:
    """The probe's chain (utils/profiling.shoup_chain) against its plain
    version at both words, at the pool prime and the largest NTT prime
    below 2^62 / 2^30, w = 1, q - 1 and a random w; then `repeats`
    readings of measure_modmul_peak at each word's defaults, with the SM
    clock and power draw that nvidia-smi reads every 0.25 s meanwhile."""
    from gpuntt_tpu_torch.utils import profiling as pr

    for is64 in (True, False):
        for q in (PROBE_QS[is64], largest_ntt_prime(62 if is64 else 30, 17)):
            x = from_numpy_u64(np.concatenate([np.array([0, 1, q - 1], dtype=np.uint64),
                                               rng.integers(0, q, 100003, dtype=np.uint64)]),
                               dev)
            for w in (1, q - 1, int(rng.integers(2, q - 1))):
                same(pr.shoup_chain(x, w, q, 7, is64), pr.shoup_chain_plain(x, w, q, 7, is64),
                     f"shoup_chain_u{64 if is64 else 32} q={q} w={w} depth 7")
    out = {}
    for is64 in (True, False):
        samples, stop = [], threading.Event()

        def sample():
            while not stop.is_set():
                samples.append(subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=60).stdout.strip())
                stop.wait(0.25)

        pr.measure_modmul_peak(PROBE_QS[is64], is64, device=dev)  # warm
        th = threading.Thread(target=sample)
        th.start()
        try:
            rates = [pr.measure_modmul_peak(PROBE_QS[is64], is64, device=dev)
                     for _ in range(repeats)]
        finally:
            stop.set()
            th.join()
        name = f"probe u{64 if is64 else 32}"
        out[name] = (min(rates), max(rates))
        print(f"{name}: {repeats} readings at depth {pr._DEPTH[is64]} on "
              f"{pr._ELEMS['cuda']} words, {min(rates):.6e}-{max(rates):.6e} products/s; "
              f"clocks.sm, power.draw meanwhile: {samples}")
    return out


def ladder(logn: int, count: int, poly, dtype, bits: int, dev):
    ms = [params(logn, poly, dtype, q) for q in g.find_ntt_primes(bits, logn, count)]
    return g.RNSMergePlan.from_params(ms, device=dev)


def timer(out: dict):
    """t(name, fn): time fn on the card into out[name], and print it."""
    def t(name, fn):
        ms, spread = time_cuda(fn)
        out[name] = (ms, spread)
        print(f"time {name}: {ms:.5f} ms (spread {spread:.3f})")
    return t


def timings(dev, rng) -> dict:
    out = {}
    t = timer(out)

    # K1-K3 at u64 2^16 x 128 and on 2^24's rows (256 x 2^16), K12 at RNS
    # 2^16 x 64 L8; the u64 2^16 x 128 entries
    plan16 = g.MergePlan.from_params(g.NTTParameters(16, PLUS, np.uint64), device=dev)
    for batch in (128, 256):
        x = words(rng, (batch, 1 << 16), 64, dev)
        fx = hm.merge_u64_fwd(x, plan16)
        fb = fx.flip(0).contiguous()
        cell = f"u64 2^16x{batch}"
        t(f"K1 fwd {cell}", lambda: hm.merge_u64_fwd(x, plan16))
        t(f"K2 inv {cell}", lambda: hm.merge_u64_inv(fx, plan16))
        t(f"K3 fused inv {cell}", lambda: hm.merge_u64_polymul_inv(fx, fb, plan16))
        if batch == 128:
            t("ntt_lanes u64 2^16x128", lambda: g.ntt_lanes(x, plan16))
            t("intt_lanes u64 2^16x128", lambda: g.intt_lanes(fx, plan16))
    l8 = ladder(16, 8, MINUS, np.uint64, 59, dev)
    m8 = torch.arange(8, dtype=torch.int32, device=dev).repeat(8)
    x = words(rng, (64, 1 << 16), 64, dev) % min(l8.qs)
    fx = hr.rns_u64_fwd(x, l8, m8)
    fb = fx.flip(0).contiguous()
    t("K12 fwd RNS u64 2^16x64 L8", lambda: hr.rns_u64_fwd(x, l8, m8))
    t("K12 inv RNS u64 2^16x64 L8", lambda: hr.rns_u64_inv(fx, l8, m8))
    t("K12 fused inv RNS u64 2^16x64 L8", lambda: hr.rns_u64_polymul_inv(fx, fb, l8, m8))
    del x, fx, fb
    # the column kernels at their cells: K7 at u64 2^24 x 1 (A = 256) and
    # 2^27 (A = 512, the ring's columns), K7' at the dist 4-step's 2^24 x 1
    # (sp 1), K13-col at RNS 2^18 x 12 L3, K9 and K11-col at 4-step 2^24 x 1,
    # K14 at RNS 4-step 2^20 x 8 L8; the u64 2^24 entries
    from gpuntt_tpu_torch.parallel.fourstep_dist import DistFourStepPlan

    plan24 = g.MergePlan.from_params(g.NTTParameters(24, PLUS, np.uint64), device=dev)
    lp24 = hml.large_plan(plan24)
    x24 = words(rng, (1, 1 << 24), 64, dev)
    fx24 = g.ntt_lanes(x24, plan24)
    t("K7 fwd u64 2^24x1 (A 256)", lambda: hml.merge_u64_large_colfwd(x24, lp24))
    t("K7 inv u64 2^24x1 (A 256)", lambda: hml.merge_u64_large_colinv(fx24, lp24))
    t("ntt_lanes u64 2^24x1", lambda: g.ntt_lanes(x24, plan24))
    t("intt_lanes u64 2^24x1", lambda: g.intt_lanes(fx24, plan24))
    p4 = g.NTTParameters4Step(24, MINUS, np.uint64)
    colmat = DistFourStepPlan.from_params(p4, device=dev).colmat
    xl = x24.view(1, colmat.A, colmat.B) % p4.modulus.value
    t("K7' fwd dist 4-step u64 2^24x1 sp 1", lambda: hml.col_phase_local(xl, colmat, 0, 1, False))
    t("K7' inv dist 4-step u64 2^24x1 sp 1", lambda: hml.col_phase_local(xl, colmat, 0, 1, True))
    plan4 = g.FourStepPlan.from_params(p4, device=dev)
    kp4 = hf.kernel_plan(plan4)
    t("K9 fwd 4-step u64 2^24x1", lambda: hf.fourstep_u64_col(x24, kp4, False))
    t("K9 inv 4-step u64 2^24x1", lambda: hf.fourstep_u64_col(x24, kp4, True))
    t("fourstep_ntt_lanes u64 2^24x1", lambda: g.fourstep_ntt_lanes(xl.view(1, -1), plan4))
    t("fourstep_intt_lanes u64 2^24x1", lambda: g.fourstep_intt_lanes(xl.view(1, -1), plan4))
    del fx24, xl
    p4 = g.NTTParameters4Step(24, MINUS, np.uint32)
    kp4 = hf.kernel_plan(g.FourStepPlan.from_params(p4, device=dev))
    x = x24 % p4.modulus.value
    t("K11-col fwd 4-step u32 2^24x1", lambda: hf.fourstep_u32_col(x, kp4, False))
    t("K11-col inv 4-step u32 2^24x1", lambda: hf.fourstep_u32_col(x, kp4, True))
    del x, x24
    l3 = ladder(18, 3, MINUS, np.uint64, 59, dev)
    sp = hr.large_plan(l3)
    m3 = torch.tensor(np.arange(12) % 3, dtype=torch.int32, device=dev)
    x = words(rng, (12, 1 << 18), 64, dev)
    t("K13-col fwd RNS u64 2^18x12 L3", lambda: hr.rns_u64_large_colfwd(x, sp, m3))
    t("K13-col inv RNS u64 2^18x12 L3", lambda: hr.rns_u64_large_colinv(x, sp, m3))
    ms = [g.NTTParameters4Step(20, MINUS, np.uint64, factors=g.NTTFactors(
        g.Modulus64(q), *g.ntt_root_pair(q, 20))) for q in g.find_ntt_primes(59, 20, 8)]
    sp = hr.fourstep_plan(g.RNSFourStepPlan.from_params(ms, device=dev))
    m8 = torch.arange(8, dtype=torch.int32, device=dev)
    x = words(rng, (8, 1 << 20), 64, dev)
    t("K14 fwd RNS 4-step u64 2^20x8 L8", lambda: hr.rns_fourstep_u64_col(x, sp, m8, False))
    t("K14 inv RNS 4-step u64 2^20x8 L8", lambda: hr.rns_fourstep_u64_col(x, sp, m8, True))
    del x
    # K8 at 2^27 (512 x 512 rows of 512, the nested rows), K10, K13-row
    p27 = g.NTTParameters(27, PLUS, np.uint64)
    plan27 = g.MergePlan.from_params(p27, device=dev)
    lp27 = hml.large_plan(plan27)
    x27 = words(rng, (1, 1 << 27), 64, dev)
    r27 = x27.view(-1, lp27.nested.B)
    t("K8 fwd u64 rows 262144x512 (2^27)",
      lambda: hml.merge_u64_large_rowmat(r27, lp27.nested.rows, False))
    t("K8 inv u64 rows 262144x512 (2^27)",
      lambda: hml.merge_u64_large_rowmat(r27, lp27.nested.rows, True))
    t("K7 fwd u64 2^27x1 (A 512, the ring's columns)",
      lambda: hml.merge_u64_large_colfwd(x27, lp27))
    t("K7 inv u64 2^27x1 (A 512, the ring's columns)",
      lambda: hml.merge_u64_large_colinv(x27, lp27))
    t("ntt_lanes u64 2^27x1", lambda: g.ntt_lanes(x27, plan27))
    fx27 = g.ntt_lanes(x27, plan27)
    t("intt_lanes u64 2^27x1", lambda: g.intt_lanes(fx27, plan27))
    del x27, r27, fx27
    p9 = g.MergePlan.from_params(params(9, MINUS, np.uint64), device=dev)
    r = words(rng, (16384, 512), 64, dev)
    t("K10 u64 rows 16384x512 (4-step 2^16x128)",
      lambda: hml.merge_u64_large_rowmat(r, p9, False))
    l8 = ladder(9, 8, MINUS, np.uint64, 59, dev)
    midx = torch.arange(8, dtype=torch.int32, device=dev).repeat(8)
    r = words(rng, (8192, 512), 64, dev)
    t("K13-row u64 rows 8192x512 L8 (RNS 4-step 2^16x64)",
      lambda: hr.rns_u64_large_rowmat(r, l8, midx, 7, False))
    # the u32 family
    for logn, batch, k in ((16, 128, "K4"), (17, 4, "K5"), (20, 16, "K6"), (24, 2, "K6")):
        plan = g.MergePlan.from_params(g.NTTParameters(logn, PLUS, np.uint32), device=dev)
        x = words(rng, (batch, 1 << logn), 32, dev)
        fx = hm32.merge_u32_fwd(x, plan)
        t(f"{k} fwd u32 2^{logn}x{batch}", lambda: hm32.merge_u32_fwd(x, plan))
        t(f"{k} inv u32 2^{logn}x{batch}", lambda: hm32.merge_u32_inv(fx, plan))
        if logn == 20:
            t("ntt_lanes u32 2^20x16", lambda: g.ntt_lanes(x, plan))
            t("intt_lanes u32 2^20x16", lambda: g.intt_lanes(fx, plan))
    plan = g.MergePlan.from_params(params(9, MINUS, np.uint32, 469762049), device=dev)
    x = words(rng, (16384, 512), 32, dev)
    t("K11-row fwd u32 rows 16384x512", lambda: hm32.merge_u32_fwd(x, plan))
    for logn, batch, k in ((16, 128, "K16"), (20, 16, "K6 per modulus")):
        plan = ladder(logn, 8, PLUS, np.uint32, 30, dev)
        midx = torch.arange(8, dtype=torch.int32, device=dev).repeat(batch // 8)
        x = words(rng, (batch, 1 << logn), 32, dev) % 469762049
        fx = hr32.rns_u32_fwd(x, plan, midx)
        fb = fx.flip(0).contiguous()
        t(f"{k} fwd RNS u32 2^{logn}x{batch} L8", lambda: hr32.rns_u32_fwd(x, plan, midx))
        t(f"{k} inv RNS u32 2^{logn}x{batch} L8", lambda: hr32.rns_u32_inv(fx, plan, midx))
        t(f"{k} fused inv RNS u32 2^{logn}x{batch} L8",
          lambda: hr32.rns_u32_polymul_inv(fx, fb, plan, midx))
    kmerge_timings(dev, rng, t)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print("package", g.__file__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip())
    rng = np.random.default_rng(0)
    mode = sys.argv[1] if len(sys.argv) > 1 else "all"
    out: dict = {}
    if mode == "variants":
        variants(dev, rng, timer(out))
        print(json.dumps(out))
        return 0
    if mode == "probe":
        _build.library("probe")
        ptxas_lines("probe")
        print(json.dumps(probe_rates(dev, rng)))
        return 0
    t0 = time.perf_counter()
    libs = ("kmerge",) if mode == "kmerge" else tuple(_build._ENTRIES)
    if mode == "kmerge":
        _build.library("kmerge")
    else:
        _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s")
    for name in libs:
        ptxas_lines(name)
    if mode != "kmerge":
        check_merge(dev, rng)
        check_k8(dev, rng)
        check_cols(dev, rng)
        check_u32(dev, rng)
    check_kmerge(dev, rng)
    torch.cuda.synchronize()
    if mode == "kmerge":
        kmerge_timings(dev, rng, timer(out))
    else:
        out = timings(dev, rng)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
