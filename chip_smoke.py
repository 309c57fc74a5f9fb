#!/usr/bin/env python3
"""Drive the port's merge, 4-step, RNS, distributed and factored-merge paths, its
examples, its entry and its modmul-peak probe on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Builds the kernels of gpuntt_tpu_torch/csrc/ (one nvcc per source, all
at once) and runs, on the card:

1. the card's name and power limit, torch and CUDA versions, build time;
2. the u64 main path at its full width — the forward merge NTT, its
   inverse and the fused polymul of a (128, 2^16) u64 batch, X^N + 1,
   the 61-bit pool prime — through ntt_lanes / intt_lanes /
   polymul_lanes, with every kernel's launch count read around that
   run; then each kernel against its plain PyTorch version on the same
   card, all 128 rows, and two rows against the golden NTTCPU;
3. u64 logn 12, X^N - 1, batch 4 against schoolbook multiplication;
4. a 62-bit and a 46-bit modulus at logn 14 against NTTCPU;
5. PolynomialMultiplier (the nn.Module) on the u64 main-path shape;
6. the u32 path at the two widths of the JAX bench line, X^N + 1, the
   pool prime 469762049 — (128, 2^16), served by K4's counterpart, and
   (16, 2^20), by K6's — the same way: ntt, intt and polymul through
   the public *_lanes entries with the launch counts read around each
   run, each kernel against its plain version on every row, the round
   trip, two rows against NTTCPU, and PolynomialMultiplier;
7. u32 2^17 x 4 (K5's range) and 2^25 x 1 (the top of the u32 pool):
   kernels against plain versions, ntt / intt against NTTCPU, the round
   trip;
8. u32 logn 8, X^N - 1, batch 4 against schoolbook, and a 30-bit q at
   logn 14 against NTTCPU;
9. the u64 big-ring path, X^N + 1, the 61-bit pool prime, at 2^24 x 1
   (the JAX package's big-ring cell) and 2^20 x 16 (the bytes of the u32
   2^20 x 16 cell): ntt, intt and polymul through the public *_lanes
   entries with the launch counts of K1-K3 and K7-K8 read around each
   call, K7's counterpart against its plain version, every output
   against the plain composition on the card and rows against the
   native oracle (NTTCPU) on the host; the plan's build time and bytes;
10. 2^27 x 1 (K8's counterpart on the nested rows) and 2^28 x 1 (the top
   of the pool): forward and inverse against the plain composition, K8
   against its plain version, the round trip, and at 2^28 the forward
   against the native oracle;
11. u64 logn 18, X^N - 1, batch 4: polymul against NTTCPU on two rows,
   and a 62-bit and a 46-bit q at logn 20 against NTTCPU;
12. the 4-step path, X^N - 1, the pool prime of NTTParameters4Step, u64
   and u32 at 2^24 x 1 (the JAX package's fourstep24 cell: 256 x 65536,
   rows on K1/K2 or the u32 family) and 2^16 x 128 (128 x 512, rows on
   K10 or K11's row twin): fourstep_ntt_lanes, fourstep_intt_lanes and
   the two _full entries through the public functions, with the launch
   counts read around each call; every output against the plain
   composition on the card, the round trip, rows against NTT4StepCPU,
   each kernel against its plain version; the kernel plan's build time
   and bytes; then u64 2^16 x 4, X^N + 1, against NTT4StepCPU;
13. CUDA-event times of each kernel and of its plain version, at the
   shape its path gave it, and of the big-ring and 4-step transforms
   end to end;
14-17. the u64 RNS path (K12, K13, K14; `rns_phase`), with K12 at the
   u64 HE cell's call, 2^15 x 240 on portbench's 15-prime ladder (a
   whole ring on a cluster of eight blocks): every row against the plain
   versions, the same outputs at the split of two launches a transform
   (log A 7), and both splits' CUDA-event times;
18-21. the u32 RNS path on the stacked u32 kernels (`rns32_phase`): u32
   2^16 x 128 on a ladder of 8 30-bit primes, X^N + 1, cyclic — ntt_rns,
   intt_rns, rns_polymul and RNSPolynomialMultiplier through the public
   entries with the launch counts read around them, every row against
   the plain versions, two rows against NTTCPU; the ordered schedules at
   logn 8 and 12 against the same entries on the host; K6's range at
   2^20 x 16 (ladder 8) and 2^24 x 2 (167772161, 469762049); the int32-lane
   (4-byte word) instances, their launch counts read around the entries:
   K6's at 2^20 x 16, and K16's at the u32 HE cell's call, 2^15 x 480 on
   portbench's 30-prime ladder of 30 bits, against the plain versions,
   the int64 lanes narrowed and, two rows, NTTCPU, one kernel a
   transform in the device trace, and the same outputs at the split of
   two launches a transform (log A 2); there the product is the fused
   launch (rns_u32_polymul, one kernel a product), equal bit for bit to
   the two forwards and the fused inverse; the kernels' (each instance's,
   the int32 bounds on 4-byte words), the entries', the three launches'
   and the old split's CUDA-event times;
22-25. the distributed path (`dist_phase`) at world size 1 on NCCL (a
   HashStore, no network): the dist 4-step at u64 and u32 2^24 x 1
   (256 x 65536; u64 on K7' and K1/K2) against the single-chip
   fourstep_ntt_full and the round trip; K7' on every shard of sp = 4
   and 8 at u64 2^24 against its plain version and the sp = 1 columns
   ("virtual ranks": no collective spans ranks on one card); the dist
   merge at u64 2^20 x 1 against ntt_lanes, and every rank's tail plan
   of sp = 8 (2^17, K1/K2) and sp = 4 (2^18, the twisted big-ring plan)
   against its plain version; DistRNSPolynomialMultiplier at 2^20,
   ladder 4, batch 4 against rns_polymul_lanes and
   DistPolynomialMultiplier at 2^16 x 4 against polymul_lanes, with the
   launch counts read around each; K7''s and dist_fourstep_ntt's times;
26-29. the factored merge kernels of csrc/kmerge.cu (`kmerge_phase`):
   K15's counterpart at u64 2^16 x 128, X^N + 1, the 61-bit pool prime,
   through ntt_lanes, intt_lanes and polymul_lanes with use_pallas="vpu"
   (the launch counts read around each call: K15 only), every row against
   the plain versions and the default route (K1, K3), two rows against
   NTTCPU; its check cells (logn 7 against schoolbook, 12 X^N - 1, a
   62-bit and a past-62-bit q at 12, 14 and 15 on both sides of the
   one-block limit, 2^20 x 16 and 2^24 x 1 against the default route,
   signed input and PerCoefficient); K17's kmerge_u32 at u32 2^16 x 128
   and 2^20 x 16, q = 469762049, every row against the plain version and
   ntt_lanes (K4, K6), and at logn 7, 8 X^N - 1, a 30-bit q at 14, 15
   X^N - 1 (both sides of the one-block limit) and 2^25 x 1; the four
   entries' and their plain versions' times beside K1/K2 and K4;
30. the examples (`examples_phase`): each device example's main in this
   process at its cell of PERF.md §4 (merge ntt / intt and 4-step ntt /
   intt u64 2^16 x 128, RNS ntt 2^16 x 64, RNS polymul 2^12 ladder 3,
   the dist polymul 2^16 x 4 at world size 1), then the two host
   examples: each prints `All Correct.`, with its route's launch counts
   (K1, K2, K9 + K10, K12, K12 fused, K7');
31. the entry (`entry_phase`): the CUDA-graph capture of entry()'s step
   (u64 2^12 x 4) and of polymul_lanes at u64 2^16 x 128, replay ==
   eager == NTTCPU, and the CUDA-event times of eager and replayed calls;
32. the modmul-peak probe (`probe_phase`, csrc/probe.cu, which replaces
   no TPU kernel and so is not in the kernel table): its chain against
   its plain version, then measure_modmul_peak's u64 and u32 rates on a
   line of their own beside the card's name and power limit.

Every comparison is exact equality (integer arithmetic: tolerance 0).
Any failure raises, and the script exits non-zero without a result line;
so it does when no CUDA device is visible.  The line before the last is
the JSON kernel table, with each kernel's bound: the larger of the time
to move its bytes (each input read once, each output written once, at
3.35 TB/s) and the time of its integer multiplies at 67 T/s (the
float32 rate; the card's 32-bit integer rate is not above it; a u64
Shoup product counts 16 32-bit multiplies).  The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 128
LOGN = 16
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"ok   {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def bound_of(by: int, ops: int) -> tuple[float, str]:
    """Least time to move `by` bytes and do `ops` 32-bit multiplies."""
    t_by, t_ops = by / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (t_by, "bytes") if t_by >= t_ops else (t_ops, "operations")


def bound_ms(batch: int, logn: int, operands: int, mul_per_bf: int,
             word: int = 8) -> tuple[float, str]:
    """Least time for a transform of (batch, 2^logn) lanes of `word`-byte
    words (int64 lanes: 8) that reads `operands` tensors and writes one:
    bytes against multiplies."""
    return bound_of((operands + 1) * batch * (word << logn),
                    batch * (1 << (logn - 1)) * logn * mul_per_bf)


def recorders(err, times, bounds):
    """The RNS phases' recording helpers: `same` holds a kernel's output
    against its plain version and keeps the largest difference in `err`;
    `timed` times a kernel and its plain version in turns (plain, kernel,
    kernel, plain) into `times`, with its bound into `bounds`; `e2e`
    times an entry end to end."""
    import torch

    from gpuntt_tpu_torch.utils.timing import time_cuda

    def same(name, got, want, what):
        e = int((got - want).abs().max().item())
        err[name] = max(err.get(name, 0), e)
        check(torch.equal(got, want), f"{what} == plain version (max |diff| {e})")

    def timed(name, kernel, plain, bound, cell, repeats=5):
        runs = [time_cuda(plain, repeats=repeats, inner=2), time_cuda(kernel),
                time_cuda(kernel), time_cuda(plain, repeats=repeats, inner=2)]
        k_ms, p_ms = (runs[1][0] + runs[2][0]) / 2, (runs[0][0] + runs[3][0]) / 2
        times[name], bounds[name] = (k_ms, p_ms), bound
        print(f"time {name} {cell}: kernel {k_ms:.5f} ms (spread "
              f"{max(runs[1][1], runs[2][1]):.3f}), plain {p_ms:.3f} ms (spread "
              f"{max(runs[0][1], runs[3][1]):.3f}), bound {bound[0]:.5f} ms ({bound[1]}), "
              f"{bound[0] / k_ms:.1%} of it")
        return k_ms

    def e2e(what, fn):
        ms, spread = time_cuda(fn)
        print(f"time {what}: {ms:.5f} ms (spread {spread:.3f})")
        return ms

    return same, timed, e2e


def device_kernels(fn) -> list:
    """The names of the kernels, copies and sets that one call of fn puts
    on the card, read from a torch.profiler trace."""
    import tempfile

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def old_split(entry: str, plan, midx, *xs):
    """The RNS entry `entry` at logn 15 with the split it took before whole
    rings went on chip, a column launch and a row launch a transform,
    called directly on the current stream: merge_u64.cu's (log A 7) for a
    u64 ladder, merge_u32.cu's on int32 lanes (log A 2) for a u32 one."""
    import ctypes

    import torch

    from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
    from gpuntt_tpu_torch.ops import kernel

    inverse = not entry.endswith("_forward")
    if plan.is64:
        lib, name, log_a = "merge_u64", entry, 7
        tables = ((plan.inv_tables, plan.inv_shoup) if inverse
                  else (plan.fwd_tables, plan.fwd_shoup))
    else:
        lib, name, log_a = "merge_u32", entry + "_i32", 2
        tables = (hm32.packed_tables(plan)[int(inverse)],)
    y = torch.empty_like(xs[0])
    rc = getattr(kernel.library(lib), name)(
        xs[0].device.index, *(x.data_ptr() for x in xs), y.data_ptr(), xs[0].shape[0],
        plan.logn, log_a, midx.data_ptr(), midx.numel(), 0, *(t.data_ptr() for t in tables),
        plan.consts.data_ptr(), int(plan.xnp),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise AssertionError(f"{name} at log A {log_a}: cudaError_t {rc}")
    return y


def rns_phase(dev, rng, reset, launches, err, times, bounds) -> None:
    """14-17: the u64 RNS path (K12, K13, K14), through the public entries."""
    import torch

    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.ops import dispatch as td
    from gpuntt_tpu_torch.ops import hopper_fourstep as hf
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops import hopper_merge_large as hml
    from gpuntt_tpu_torch.ops import hopper_rns as hr
    from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64

    MINUS = g.ReductionPolynomial.X_N_minus
    PLUS = g.ReductionPolynomial.X_N_plus
    T = g.transpose_lanes
    FWD, INV, PINV, CF, CI, RM, C4 = (k.name for k in hr.KERNELS)

    def members(logn, mc, poly=MINUS, four=False):
        params = g.NTTParameters4Step if four else g.NTTParameters
        out = []
        for q in g.find_ntt_primes(59, logn, mc):
            omega, psi = g.ntt_root_pair(q, logn)
            out.append(params(logn, poly, np.uint64,
                              factors=g.NTTFactors(g.Modulus64(q), omega, psi)))
        return out

    def residues(qs, mod_idx, n):
        return np.stack([rng.integers(0, qs[m], n, dtype=np.uint64) for m in mod_idx])

    def counted() -> dict:
        torch.cuda.synchronize()
        ks = (*hr.KERNELS, *hm.KERNELS, *hml.KERNELS, *hf.KERNELS)
        if any(k.plain_calls for k in ks):
            raise AssertionError(f"plain versions ran: {[(k.name, k.plain_calls) for k in ks]}")
        return {k.name: k.launches for k in ks if k.launches}

    same, timed, e2e = recorders(err, times, bounds)

    # -- 14. the headline: rns_polymul at u64 2^16 x 64, ladder 8, X^N - 1
    ms8 = members(16, 8)
    t0 = time.perf_counter()
    plan = g.RNSMergePlan.from_params(ms8, device=dev)
    torch.cuda.synchronize()
    print(f"RNS u64 2^16 ladder 8 plan build {time.perf_counter() - t0:.3f} s, "
          f"{plan.device_bytes()} bytes of stacked tables on the card")
    n, cyc = plan.n, np.arange(64) % 8
    a_np, b_np = residues(plan.qs, cyc, n), residues(plan.qs, cyc, n)
    # stack 0 (rows 0-7) holds one integer polynomial pair, for the CRT check:
    # a with 8 terms, b dense, coefficients below 2^62
    a_terms = {int(i): int(v) for i, v in zip(rng.choice(n, 8, replace=False),
                                             rng.integers(0, 1 << 62, 8, dtype=np.uint64))}
    b_int = [int(v) for v in rng.integers(0, 1 << 62, n, dtype=np.uint64)]
    for m, q in enumerate(plan.qs):
        a_np[m] = 0
        for i, v in a_terms.items():
            a_np[m, i] = v % q
        b_np[m] = np.array([v % q for v in b_int], dtype=np.uint64)
    a, b = from_numpy_u64(a_np, dev), from_numpy_u64(b_np, dev)
    model = g.RNSPolynomialMultiplier(ms8, device=dev)

    reset()
    fa_np = g.ntt_rns(a_np, plan)
    back_np = g.intt_rns(fa_np, plan)
    prod_np = g.rns_polymul(a_np, b_np, plan)
    mout = model(a.view(8, 8, n), b.view(8, 8, n))
    run = counted()
    check(run == {FWD: 5, INV: 1, PINV: 2},
          f"RNS 2^16x64 L8 ntt_rns, intt_rns, rns_polymul and the model launched K12 "
          f"only, no plain version ({run})")
    launches.update({FWD: run[FWD], INV: run[INV], PINV: run[PINV]})

    midx = torch.tensor(cyc, dtype=torch.int32, device=dev)
    fa = from_numpy_u64(fa_np, dev)
    fa_plain = hr.rns_u64_fwd_plain(a, plan, midx)
    fb_plain = hr.rns_u64_fwd_plain(b, plan, midx)
    same(FWD, fa, fa_plain, "RNS 2^16x64 L8 ntt_rns, all rows,")
    same(INV, from_numpy_u64(back_np, dev), hr.rns_u64_inv_plain(fa, plan, midx),
         "RNS 2^16x64 L8 intt_rns, all rows,")
    check(np.array_equal(back_np, a_np), "RNS 2^16x64 L8 intt_rns(ntt_rns(a)) == a")
    prod = from_numpy_u64(prod_np, dev)
    same(PINV, prod, hr.rns_u64_polymul_inv_plain(fa_plain, fb_plain, plan, midx),
         "RNS 2^16x64 L8 rns_polymul, all rows,")
    check(torch.equal(mout.reshape(64, n), prod), "RNSPolynomialMultiplier == rns_polymul")
    for r in (0, 13, 63):
        gen = g.NTTCPU(ms8[r % 8])
        check(np.array_equal(fa_np[r], gen.ntt(a_np[r])),
              f"RNS ntt_rns row {r} == NTTCPU of member {r % 8}")
        check(np.array_equal(prod_np[r], gen.intt(gen.mult(gen.ntt(a_np[r]),
                                                           gen.ntt(b_np[r])))),
              f"RNS rns_polymul row {r} == NTTCPU of member {r % 8}")
    t0 = time.perf_counter()
    big_q = 1
    for q in plan.qs:
        big_q *= q
    want = [0] * n
    for i, v in a_terms.items():
        for j, w in enumerate(b_int):
            want[(i + j) % n] += v * w
    check(g.crt_reconstruct(prod_np[:8], plan.qs) == [w % big_q for w in want],
          f"RNS rns_polymul stack 0, CRT-lifted, == the schoolbook product mod Q "
          f"({time.perf_counter() - t0:.1f} s on the host)")

    # -- 15. the schedules: ladder 3 at logn 12 and 14 against the plain versions
    for logn in (12, 14):
        for poly in (MINUS, PLUS):
            ms3 = members(logn, 3, poly)
            plan3 = g.RNSMergePlan.from_params(ms3, device=dev)
            cpu3 = g.RNSMergePlan.from_params(ms3, device="cpu")
            x = residues((min(plan3.qs),) * 3, [0] * 6, plan3.n)
            cell = f"RNS 2^{logn}x6 L3 {poly.name}"
            calls = [(name, order, {}) for name in ("ntt_modulus_ordered", "intt_modulus_ordered")
                     for order in ([2, 0, 1], [5, -1, 0])]
            calls += [(name, [2, 0, 2, 5], {"batch_size": 4})
                      for name in ("ntt_poly_ordered", "intt_poly_ordered")]
            reset()
            outs = [getattr(g, name)(x, plan3, order, **kw) for name, order, kw in calls]
            run = counted()
            check(run == {FWD: 3, INV: 3}, f"{cell} ordered entries launched K12 ({run})")
            for (name, order, kw), got in zip(calls, outs):
                check(np.array_equal(got, getattr(g, name)(x, cpu3, order, **kw)),
                      f"{cell} {name} {order} {kw} == plain versions")
            check(np.array_equal(outs[1], g.ntt_modulus_ordered(x, plan3, [2, 2, 0])),
                  f"{cell} order [5, -1, 0] reads as [2, 2, 0]")

    # -- 16. K12 at 2^17 x 12 and K13 at 2^18 x 12, ladder 3 (the JAX cells large-17/18)
    large = {}
    for logn in (17, 18):
        ms3 = members(logn, 3)
        t0 = time.perf_counter()
        plan3 = g.RNSMergePlan.from_params(ms3, device=dev)
        sp = hr.large_plan(plan3) if logn == 18 else None
        torch.cuda.synchronize()
        size = (sp.device_bytes() if sp else plan3.device_bytes())
        print(f"RNS u64 2^{logn} ladder 3 plan build {time.perf_counter() - t0:.3f} s, "
              f"{size} bytes of {'K13' if sp else 'K12'} tables on the card")
        cyc3 = np.arange(12) % 3
        x = from_numpy_u64(residues(plan3.qs, cyc3, plan3.n), dev)
        y = from_numpy_u64(residues(plan3.qs, cyc3, plan3.n), dev)
        m3 = torch.tensor(cyc3, dtype=torch.int32, device=dev)
        cell = f"RNS 2^{logn}x12 L3"
        reset()
        fx = td.ntt_rns_lanes(x, plan3, cyc3)
        bx = td.intt_rns_lanes(fx, plan3, cyc3)
        pxy = td.rns_polymul_lanes(x, y, plan3, cyc3)
        run = counted()
        want_run = {FWD: 3, INV: 1, PINV: 1}
        if sp:
            want_run.update({CF: 3, CI: 2})
            launches.update({CF: run[CF], CI: run[CI]})
            check(plan3.fwd_tables is None and all(m.fwd_table is None for m in plan3.members),
                  f"{cell} built no N-entry table")
        check(run == want_run, f"{cell} ntt, intt and polymul launched {run}")
        if sp:
            fx_plain = hr.rns_u64_large_plain(x, sp, m3)
            same(CF, fx, fx_plain, f"{cell} ntt_rns_lanes, all rows,")
            same(CI, bx, hr.rns_u64_large_plain(fx, sp, m3, inverse=True),
                 f"{cell} intt_rns_lanes")
            same(PINV, pxy, hr.rns_u64_large_polymul_inv_plain(
                fx_plain, hr.rns_u64_large_plain(y, sp, m3), sp, m3), f"{cell} polymul")
        else:
            fx_plain = hr.rns_u64_fwd_plain(x, plan3, m3)
            same(FWD, fx, fx_plain, f"{cell} ntt_rns_lanes, all rows,")
            same(INV, bx, hr.rns_u64_inv_plain(fx, plan3, m3), f"{cell} intt_rns_lanes")
            same(PINV, pxy, hr.rns_u64_polymul_inv_plain(
                fx_plain, hr.rns_u64_fwd_plain(y, plan3, m3), plan3, m3), f"{cell} polymul")
        check(torch.equal(bx, x), f"{cell} intt(ntt(x)) == x")
        for r in (0, 11):
            gen = g.NTTCPU(ms3[r % 3])
            check(np.array_equal(to_numpy_u64(fx[r]), gen.ntt(to_numpy_u64(x[r]))),
                  f"{cell} row {r} == NTTCPU of member {r % 3}")
        large[logn] = (plan3, sp, x, y, fx, m3, cyc3)

    # -- 17. the RNS 4-step (K14): 2^16 x 64 (128 x 512) and 2^20 x 8 (32 x 32768), ladder 8
    four = {}
    for logn, batch in ((16, 64), (20, 8)):
        ms4 = members(logn, 8, four=True)
        t0 = time.perf_counter()
        plan4 = g.RNSFourStepPlan.from_params(ms4, device=dev)
        sp4 = hr.fourstep_plan(plan4)
        torch.cuda.synchronize()
        kp = sp4.first
        print(f"RNS 4-step u64 2^{logn} ladder 8 plan build {time.perf_counter() - t0:.3f} s, "
              f"{sp4.device_bytes()} bytes of K14 tables on the card (n1={kp.n1} n2={kp.n2})")
        cyc8 = np.arange(batch) % 8
        x_np = residues(plan4.qs, cyc8, plan4.n)
        x = from_numpy_u64(x_np, dev)
        m8 = torch.tensor(cyc8, dtype=torch.int32, device=dev)
        cell = f"RNS 4-step 2^{logn}x{batch} L8"
        rows = {RM: 1} if kp.n2 <= hf.ROW_MAT_MAX else None
        outs, total = {}, {}
        for entry, fn, inverse in (("ntt_lanes", g.rns_fourstep_ntt_lanes, False),
                                   ("intt_lanes", g.rns_fourstep_intt_lanes, True),
                                   ("ntt_full", g.rns_fourstep_ntt_full, False),
                                   ("intt_full", g.rns_fourstep_intt_full, True)):
            reset()
            outs[entry] = fn(x, plan4, cyc8)
            run = counted()
            want_run = {C4: 1, **(rows or {INV if inverse else FWD: 1})}
            check(run == want_run, f"{cell} {entry} launched {run}")
            for k, v in run.items():
                total[k] = total.get(k, 0) + v
        if rows:
            launches[RM] = total[RM]
        else:
            launches[C4] = total[C4]
        n1, n2 = kp.n1, kp.n2
        pairs = {"ntt_lanes": hr.rns_fourstep_plain(x, sp4, m8),
                 "intt_lanes": hr.rns_fourstep_plain(x, sp4, m8, True),
                 "ntt_full": T(hr.rns_fourstep_plain(T(x, n1, n2), sp4, m8), n1, n2),
                 "intt_full": T(hr.rns_fourstep_plain(T(x, n2, n1), sp4, m8, True), n1, n2)}
        for entry, want in pairs.items():
            same(C4, outs[entry], want, f"{cell} {entry}, all {batch} rows,")
        check(torch.equal(g.rns_fourstep_intt_full(outs["ntt_full"], plan4, cyc8), x),
              f"{cell} intt_full(ntt_full(x)) == x")
        for r in (0, batch - 1):
            gen = g.NTT4StepCPU(ms4[r % 8])
            check(np.array_equal(to_numpy_u64(outs["ntt_full"][r]), gen.ntt(x_np[r]))
                  and np.array_equal(to_numpy_u64(outs["intt_full"][r]), gen.intt(x_np[r])),
                  f"{cell} ntt_full, intt_full row {r} == NTT4StepCPU of member {r % 8}")
        check(all("w" not in m._lazy for m in plan4.members), f"{cell} built no W table")
        for inverse in (False, True):
            y = hr.rns_fourstep_u64_col(x, sp4, m8, inverse)
            same(C4, y, hr.col4_plain(x, sp4, m8, inverse), f"{cell} {C4} inverse={inverse}")
            if rows:
                r = y.view(-1, n2)
                same(RM, hr.rns_u64_large_rowmat(r, sp4.rows, m8, n1.bit_length() - 1, inverse),
                     hr.rowmat_plain(r, sp4.rows, m8, n1.bit_length() - 1, inverse),
                     f"{cell} {RM} inverse={inverse} on {r.shape[0]} rows")
        four[logn] = (plan4, sp4, x, m8, cyc8, batch)
        del outs, pairs

    # -- the u64 HE cell's call: 240 rows of 2^15 (8 ciphertext pairs) under
    # portbench's he_std128_n15 ladder, 15 primes of 59 bits, X^N + 1,
    # cyclic, on the whole-ring kernel (a ring on a cluster of eight
    # blocks): the same outputs at the split of two launches a transform
    # (log A 7).  The device trace's one kernel a transform is a card test
    # (test_u64_launches_and_passes_per_transform_on_card): a profiler
    # session here left the u32 section's session below without kernels.
    cfg = json.loads((ROOT / "portbench" / "configs" / "he_std128_n15.json").read_text())
    he = [g.NTTParameters(cfg["logn"], PLUS, np.uint64, factors=g.NTTFactors(
        g.Modulus64(q), *g.ntt_root_pair(q, cfg["logn"]))) for q in cfg["primes"]]
    plan15 = g.RNSMergePlan.from_params(he, device=dev)
    cyc15 = np.arange(240) % len(he)
    a15 = from_numpy_u64(residues(plan15.qs, cyc15, plan15.n), dev)
    b15 = from_numpy_u64(residues(plan15.qs, cyc15, plan15.n), dev)
    midx15 = torch.tensor(cyc15, dtype=torch.int32, device=dev)
    cell15 = f"RNS u64 2^{cfg['logn']}x240 L15"
    reset()
    p15 = td.rns_polymul_lanes(a15, b15, plan15, cyc15)
    run = counted()
    check(run == {FWD: 2, PINV: 1}, f"{cell15} rns_polymul_lanes launched K12's product ({run})")
    f15, fb15 = hr.rns_u64_fwd(a15, plan15, midx15), hr.rns_u64_fwd(b15, plan15, midx15)
    same(FWD, f15, hr.rns_u64_fwd_plain(a15, plan15, midx15), f"{cell15} {FWD}, all rows,")
    same(INV, hr.rns_u64_inv(f15, plan15, midx15), hr.rns_u64_inv_plain(f15, plan15, midx15),
         f"{cell15} {INV}, all rows,")
    same(PINV, p15, hr.rns_u64_polymul_inv_plain(f15, fb15, plan15, midx15),
         f"{cell15} rns_polymul_lanes, all rows,")
    steps15 = ((FWD, "rns_u64_forward", (a15,), lambda: hr.rns_u64_fwd(a15, plan15, midx15)),
               (INV, "rns_u64_inverse", (f15,), lambda: hr.rns_u64_inv(f15, plan15, midx15)),
               (PINV, "rns_u64_polymul_inverse", (f15, fb15),
                lambda: hr.rns_u64_polymul_inv(f15, fb15, plan15, midx15)))
    for name, entry, xs, fn in steps15:
        check(torch.equal(old_split(entry, plan15, midx15, *xs), fn()),
              f"{name} at {cell15} == itself at log A 7 (two launches)")

    # -- times: each RNS kernel at its cell (plain, kernel, kernel, plain), end to end
    print(f"bound {cell15} per transform: {bound_ms(240, 15, 1, 16)}, fused inverse: "
          f"{bound_ms(240, 15, 2, 16)}")
    for name, entry, xs, fn in steps15:
        e2e(f"{name} {cell15}", fn)
        e2e(f"{name} at log A 7 (two launches) {cell15}",
            lambda entry=entry, xs=xs: old_split(entry, plan15, midx15, *xs))
    e2e(f"rns_polymul_lanes {cell15} end to end",
        lambda: td.rns_polymul_lanes(a15, b15, plan15, cyc15))
    del a15, b15, f15, fb15, p15
    cell = "RNS u64 2^16x64 L8"
    k12 = timed(FWD, lambda: hr.rns_u64_fwd(a, plan, midx),
                lambda: hr.rns_u64_fwd_plain(a, plan, midx), bound_ms(64, 16, 1, 16), cell)
    timed(INV, lambda: hr.rns_u64_inv(fa, plan, midx),
          lambda: hr.rns_u64_inv_plain(fa, plan, midx), bound_ms(64, 16, 1, 16), cell)
    timed(PINV, lambda: hr.rns_u64_polymul_inv(fa, fa_plain, plan, midx),
          lambda: hr.rns_u64_polymul_inv_plain(fa, fa_plain, plan, midx),
          bound_ms(64, 16, 2, 16), cell)
    one = g.MergePlan.from_params(ms8[0], device=dev)
    k1 = e2e("K1 merge_u64_forward (one modulus, member 0) u64 2^16x64",
             lambda: hm.merge_u64_fwd(a, one))
    print(f"K12 / K1 at u64 2^16x64: {k12 / k1:.3f}")
    for what, fn in (("ntt_rns_lanes", lambda: td.ntt_rns_lanes(a, plan, cyc)),
                     ("intt_rns_lanes", lambda: td.intt_rns_lanes(fa, plan, cyc)),
                     ("rns_polymul_lanes", lambda: td.rns_polymul_lanes(a, b, plan, cyc)),
                     ("RNSPolynomialMultiplier", lambda: model(a.view(8, 8, n), b.view(8, 8, n))),
                     ("ntt_lanes (one modulus, yardstick)", lambda: g.ntt_lanes(a, one))):
        e2e(f"{what} {cell} end to end", fn)
    for logn in (17, 18):
        plan3, sp, x, y, fx, m3, cyc3 = large[logn]
        cell = f"RNS u64 2^{logn}x12 L3"
        if sp:
            nw = 12 << logn
            for name, inverse, src in ((CF, False, x), (CI, True, fx)):
                fn = hr.rns_u64_large_colinv if inverse else hr.rns_u64_large_colfwd
                plain = hr.colinv_plain if inverse else hr.colfwd_plain
                timed(name, lambda fn=fn, src=src: fn(src, sp, m3),
                      lambda plain=plain, src=src: plain(src, sp, m3),
                      bound_of(2 * 8 * nw, 16 * (nw // 2 * 7 + (3 if inverse else 2) * nw)),
                      cell)
        else:
            e2e(f"{FWD} {cell}", lambda: hr.rns_u64_fwd(x, plan3, m3))
            e2e(f"{INV} {cell}", lambda: hr.rns_u64_inv(fx, plan3, m3))
            print(f"bound {cell} per K12 launch: {bound_ms(12, logn, 1, 16)}")
        for what, fn in (("ntt_rns_lanes", lambda: td.ntt_rns_lanes(x, plan3, cyc3)),
                         ("intt_rns_lanes", lambda: td.intt_rns_lanes(fx, plan3, cyc3)),
                         ("rns_polymul_lanes", lambda: td.rns_polymul_lanes(x, y, plan3, cyc3))):
            e2e(f"{what} {cell} end to end", fn)
    plan4, sp4, x, m8, cyc8, batch = four[16]
    r = hr.col4_plain(x, sp4, m8, False).view(-1, sp4.first.n2)
    shift = sp4.first.n1.bit_length() - 1
    timed(RM, lambda: hr.rns_u64_large_rowmat(r, sp4.rows, m8, shift, False),
          lambda: hr.rowmat_plain(r, sp4.rows, m8, shift, False),
          bound_of(2 * 8 * r.numel(), 16 * (r.numel() // 2) * 9),
          f"RNS 4-step 2^16x64 L8 rows {r.shape[0]}x{r.shape[1]}")
    plan4, sp4, x, m8, cyc8, batch = four[20]
    nw, log1 = batch << 20, sp4.first.n1.bit_length() - 1
    timed(C4, lambda: hr.rns_fourstep_u64_col(x, sp4, m8, False),
          lambda: hr.col4_plain(x, sp4, m8, False),
          bound_of(2 * 8 * nw, 16 * (nw // 2 * log1 + 2 * nw)), "RNS 4-step 2^20x8 L8")
    for logn, (plan4, sp4, x, m8, cyc8, batch) in sorted(four.items()):
        cell = f"RNS 4-step u64 2^{logn}x{batch} L8"
        print(f"bound {cell} per transform: {bound_ms(batch, logn, 1, 16)}")
        for what, fn in (("rns_fourstep_ntt_lanes", g.rns_fourstep_ntt_lanes),
                         ("rns_fourstep_intt_lanes", g.rns_fourstep_intt_lanes)):
            e2e(f"{what} {cell} end to end", lambda fn=fn: fn(x, plan4, cyc8))


def rns32_phase(dev, rng, reset, launches, err, times, bounds) -> None:
    """18-21: the u32 RNS path (the stacked u32 kernels of hopper_rns32.py,
    in K16's range and in K6's), through the public entries."""
    import torch

    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.ops import dispatch as td
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
    from gpuntt_tpu_torch.ops import hopper_rns as hr
    from gpuntt_tpu_torch.ops import hopper_rns32 as hr32

    PLUS = g.ReductionPolynomial.X_N_plus
    MINUS = g.ReductionPolynomial.X_N_minus

    def members(logn, qs, poly=PLUS):
        out = []
        for q in qs:
            omega, psi = g.ntt_root_pair(q, logn)
            out.append(g.NTTParameters(logn, poly, np.uint32,
                                       factors=g.NTTFactors(g.Modulus32(q), omega, psi)))
        return out

    def residues(qs, mod_idx, n):
        return np.stack([rng.integers(0, qs[m], n, dtype=np.uint64)
                         for m in mod_idx]).astype(np.uint32)

    def lanes(v):
        return torch.from_numpy(np.asarray(v).astype(np.int64)).to(dev)

    def u32(t):
        return t.cpu().numpy().astype(np.uint32)

    def counted() -> dict:
        """{kernel: launches} of the u32 RNS kernels since reset(); raises
        if a plain version ran, or another kernel than these."""
        torch.cuda.synchronize()
        others = (*hm.KERNELS, *hm32.KERNELS, *hr.KERNELS)
        if any(k.plain_calls for k in (*hr32.KERNELS, *others)):
            raise AssertionError("plain versions ran: " + str(
                [(k.name, k.plain_calls) for k in (*hr32.KERNELS, *others) if k.plain_calls]))
        if any(k.launches for k in others):
            raise AssertionError(f"other kernels ran: {[k.name for k in others if k.launches]}")
        return {k.name: k.launches for k in hr32.KERNELS if k.launches}

    same, timed, e2e = recorders(err, times, bounds)

    F16, I16, P16 = (d["K16"].name for d in (hr32.FORWARD, hr32.INVERSE, hr32.POLYMUL_INVERSE))
    PF = hr32.POLYMUL.name  # the fused product, one launch at logn 14-15
    F6, I6, P6 = (d["K6"].name for d in (hr32.FORWARD, hr32.INVERSE, hr32.POLYMUL_INVERSE))

    # -- 18. the headline: u32 2^16 x 128, X^N + 1, ladder 8 of 30-bit primes, cyclic
    ms8 = members(16, g.find_ntt_primes(30, 16, 8))
    t0 = time.perf_counter()
    plan = g.RNSMergePlan.from_params(ms8, device=dev)
    torch.cuda.synchronize()
    print(f"RNS u32 2^16 ladder 8 plan build {time.perf_counter() - t0:.3f} s, "
          f"{plan.device_bytes()} bytes of stacked tables on the card")
    n, cyc = plan.n, np.arange(128) % 8
    a_np, b_np = residues(plan.qs, cyc, n), residues(plan.qs, cyc, n)
    a, b = lanes(a_np), lanes(b_np)
    model = g.RNSPolynomialMultiplier(ms8, device=dev)
    cell = "RNS u32 2^16x128 L8"

    reset()
    fa_np = g.ntt_rns(a_np, plan)
    back_np = g.intt_rns(fa_np, plan)
    prod_np = g.rns_polymul(a_np, b_np, plan)
    mout = model(a.view(16, 8, n), b.view(16, 8, n))
    run = counted()
    check(run == {F16: 5, I16: 1, P16: 2},
          f"{cell} ntt_rns, intt_rns, rns_polymul and the model launched the stacked u32 "
          f"kernels only, no engine, no plain version ({run})")
    launches.update(run)

    midx = torch.tensor(cyc, dtype=torch.int32, device=dev)
    fa = lanes(fa_np)
    fa_plain = hr32.rns_u32_fwd_plain(a, plan, midx)
    fb_plain = hr32.rns_u32_fwd_plain(b, plan, midx)
    same(F16, fa, fa_plain, f"{cell} ntt_rns, all rows,")
    same(I16, lanes(back_np), hr32.rns_u32_inv_plain(fa, plan, midx),
         f"{cell} intt_rns, all rows,")
    check(np.array_equal(back_np, a_np), f"{cell} intt_rns(ntt_rns(a)) == a")
    prod = lanes(prod_np)
    same(P16, prod, hr32.rns_u32_polymul_inv_plain(fa_plain, fb_plain, plan, midx),
         f"{cell} rns_polymul, all rows,")
    check(torch.equal(mout.reshape(128, n), prod), f"{cell} RNSPolynomialMultiplier == rns_polymul")
    for r in (0, 127):
        gen = g.NTTCPU(ms8[r % 8])
        check(np.array_equal(fa_np[r], gen.ntt(a_np[r])),
              f"{cell} ntt_rns row {r} == NTTCPU of member {r % 8}")
        check(np.array_equal(prod_np[r], gen.intt(gen.mult(gen.ntt(a_np[r]), gen.ntt(b_np[r])))),
              f"{cell} rns_polymul row {r} == NTTCPU of member {r % 8}")

    # -- 19. the schedules: ladder 3 at logn 8 (64 rings, 32 a tile of one
    # modulus) and 12, both polynomials, against the same entries on the host
    for logn in (8, 12):
        for poly in (MINUS, PLUS):
            ms3 = members(logn, g.find_ntt_primes(30, logn, 3), poly)
            plan3 = g.RNSMergePlan.from_params(ms3, device=dev)
            cpu3 = g.RNSMergePlan.from_params(ms3, device="cpu")
            x = residues((min(plan3.qs),), [0] * 64, plan3.n)
            cell3 = f"RNS u32 2^{logn}x64 L3 {poly.name}"
            calls = [(name, order, {}) for name in ("ntt_modulus_ordered", "intt_modulus_ordered")
                     for order in ([2, 0, 1], [5, -1, 0])]
            calls += [(name, [2, 0, 2, 63, 5], {"batch_size": 5})
                      for name in ("ntt_poly_ordered", "intt_poly_ordered")]
            reset()
            outs = [getattr(g, name)(x, plan3, order, **kw) for name, order, kw in calls]
            k = hr32.tpu_kernel(logn)
            run = counted()
            check(run == {hr32.FORWARD[k].name: 3, hr32.INVERSE[k].name: 3},
                  f"{cell3} ordered entries launched the stacked u32 kernels ({run})")
            for (name, order, kw), got in zip(calls, outs):
                check(np.array_equal(got, getattr(g, name)(x, cpu3, order, **kw)),
                      f"{cell3} {name} {order} {kw} == plain versions")

    # -- 20. K6's range: 2^20 x 16 on a ladder of 8, and 2^24 x 2 on [167772161, 469762049]
    wide = {}
    for logn, qs, batch in ((20, g.find_ntt_primes(30, 20, 8), 16),
                            (24, [167772161, 469762049], 2)):
        ms = members(logn, qs)
        t0 = time.perf_counter()
        planw = g.RNSMergePlan.from_params(ms, device=dev)
        torch.cuda.synchronize()
        mc = len(qs)
        print(f"RNS u32 2^{logn} ladder {mc} plan build {time.perf_counter() - t0:.3f} s, "
              f"{planw.device_bytes()} bytes of stacked tables on the card")
        cycw = np.arange(batch) % mc
        x_np, y_np = residues(planw.qs, cycw, planw.n), residues(planw.qs, cycw, planw.n)
        x, y = lanes(x_np), lanes(y_np)
        mw = torch.tensor(cycw, dtype=torch.int32, device=dev)
        cellw = f"RNS u32 2^{logn}x{batch} L{mc}"
        reset()
        fx = td.ntt_rns_lanes(x, planw, cycw)
        bx = td.intt_rns_lanes(fx, planw, cycw)
        pxy = td.rns_polymul_lanes(x, y, planw, cycw)
        run = counted()
        check(run == {F6: 3, I6: 1, P6: 1}, f"{cellw} ntt, intt and polymul launched {run}")
        if logn == 20:
            launches.update(run)
        fx_plain = hr32.rns_u32_fwd_plain(x, planw, mw)
        same(F6, fx, fx_plain, f"{cellw} ntt_rns_lanes, all rows,")
        same(I6, bx, hr32.rns_u32_inv_plain(fx, planw, mw), f"{cellw} intt_rns_lanes")
        same(P6, pxy, hr32.rns_u32_polymul_inv_plain(
            fx_plain, hr32.rns_u32_fwd_plain(y, planw, mw), planw, mw), f"{cellw} polymul")
        check(torch.equal(bx, x), f"{cellw} intt(ntt(x)) == x")
        for r in (0, batch - 1) if logn == 20 else (batch - 1,):  # ~11 s a row at 2^24
            t0 = time.perf_counter()
            gen = g.NTTCPU(ms[r % mc])
            check(np.array_equal(u32(fx[r]), gen.ntt(x_np[r])),
                  f"{cellw} row {r} == NTTCPU of member {r % mc} "
                  f"({time.perf_counter() - t0:.1f} s on the host)")
        if logn == 20:  # the int32-lane instance of K6 on the same rows
            xw, yw = x.int(), y.int()
            reset()
            fxw = td.ntt_rns_lanes(xw, planw, cycw)
            bxw = td.intt_rns_lanes(fxw, planw, cycw)
            pxyw = td.rns_polymul_lanes(xw, yw, planw, cycw)
            run = counted()
            check(run == {F6: 3, I6: 1, P6: 1} and fxw.dtype == pxyw.dtype == torch.int32,
                  f"{cellw} int32 lanes: ntt, intt and polymul launched {run}")
            launches.update({f"{k}_i32": v for k, v in run.items()})
            fxw_plain = hr32.rns_u32_fwd_plain(xw, planw, mw)
            same(f"{F6}_i32", fxw, fxw_plain, f"{cellw} int32 ntt_rns_lanes, all rows,")
            same(f"{I6}_i32", bxw, hr32.rns_u32_inv_plain(fxw, planw, mw),
                 f"{cellw} int32 intt_rns_lanes")
            same(f"{P6}_i32", pxyw, hr32.rns_u32_polymul_inv_plain(
                fxw_plain, hr32.rns_u32_fwd_plain(yw, planw, mw), planw, mw),
                f"{cellw} int32 polymul")
            check(torch.equal(fxw, fx.int()) and torch.equal(pxyw, pxy.int()),
                  f"{cellw} int32 lanes == int64 lanes narrowed")
            wide["i32"] = (xw, fxw)
            del bxw, pxyw, fxw_plain
        wide[logn] = (planw, x, y, fx, mw, cycw)
        del bx, pxy, fx_plain

    # -- 20, on int32 lanes at the u32 HE cell's call: 480 rows of 2^15
    # (8 ciphertext pairs) under portbench's he_std128_n15_u32 ladder, 30
    # primes of 30 bits, X^N + 1, cyclic
    cfg = json.loads((ROOT / "portbench" / "configs" / "he_std128_n15_u32.json").read_text())
    ms30 = members(cfg["logn"], cfg["primes"])
    plan30 = g.RNSMergePlan.from_params(ms30, device=dev)
    n30, cyc30 = plan30.n, np.arange(480) % 30
    a30_np, b30_np = residues(plan30.qs, cyc30, n30), residues(plan30.qs, cyc30, n30)
    a30, b30 = lanes(a30_np).int(), lanes(b30_np).int()
    midx30 = torch.tensor(cyc30, dtype=torch.int32, device=dev)
    cell30 = f"RNS u32 2^{cfg['logn']}x480 L30 int32"
    reset()
    p30 = td.rns_polymul_lanes(a30, b30, plan30, cyc30)
    f30 = td.ntt_rns_lanes(a30, plan30, cyc30)
    b30_back = td.intt_rns_lanes(f30, plan30, cyc30)
    run = counted()
    check(run == {F16: 1, I16: 1, PF: 1} and p30.dtype == f30.dtype == torch.int32,
          f"{cell30} rns_polymul_lanes (the fused product, one launch), ntt_rns_lanes and "
          f"intt_rns_lanes launched the int32 instance, int32 out ({run})")
    launches.update({f"{k}_i32": run.get(k, 0) for k in (F16, I16, P16, PF)})
    fa30_plain = hr32.rns_u32_fwd_plain(a30, plan30, midx30)
    fb30_plain = hr32.rns_u32_fwd_plain(b30, plan30, midx30)
    same(f"{F16}_i32", f30, fa30_plain, f"{cell30} ntt_rns_lanes, all rows,")
    same(f"{I16}_i32", b30_back, hr32.rns_u32_inv_plain(f30, plan30, midx30),
         f"{cell30} intt_rns_lanes, all rows,")
    check(torch.equal(b30_back, a30), f"{cell30} intt(ntt(a)) == a")
    want30 = hr32.rns_u32_polymul_inv_plain(fa30_plain, fb30_plain, plan30, midx30)
    same(f"{PF}_i32", p30, want30, f"{cell30} rns_polymul_lanes (fused), all rows,")
    three30 = hr32.rns_u32_polymul_inv(hr32.rns_u32_fwd(a30, plan30, midx30),
                                       hr32.rns_u32_fwd(b30, plan30, midx30), plan30, midx30)
    same(f"{P16}_i32", three30, want30, f"{cell30} two forwards and the fused inverse")
    check(torch.equal(p30, three30), f"{cell30} fused product == the three launches, bit for bit")
    reset()
    p30_64 = td.rns_polymul_lanes(a30.long(), b30.long(), plan30, cyc30)
    run = counted()
    check(run == {PF: 1} and p30_64.dtype == torch.int64 and torch.equal(p30_64.int(), p30),
          f"{cell30} product on int64 lanes: the fused launch, == the int32 lanes' ({run})")
    launches[PF] = run[PF]
    same(PF, p30_64, want30.long(), f"{cell30} int64 lanes, fused product, all rows,")
    # one kernel a transform (a whole ring on a cluster of two blocks) and one
    # a product (a row pair on a cluster of four), and the same outputs at
    # the split of two launches a transform (log A 2)
    prepared30 = hr32.prepare(plan30, midx30)
    for name, kind, fn in (
            (F16, "cluster_ring", lambda: hr32.rns_u32_fwd(a30, plan30, midx30)),
            (I16, "cluster_ring", lambda: hr32.rns_u32_inv(f30, plan30, midx30)),
            (P16, "cluster_ring", lambda: hr32.rns_u32_polymul_inv(f30, f30, plan30, midx30)),
            (PF, "cluster_product", lambda: hr32.rns_u32_polymul(a30, b30, prepared30))):
        ops = device_kernels(fn)
        check(len(ops) == 1 and kind in ops[0], f"{name}_i32 at {cell30}: one kernel ({ops})")
    check(torch.equal(old_split("rns_u32_forward", plan30, midx30, a30), f30) and
          torch.equal(old_split("rns_u32_polymul_inverse", plan30, midx30, f30, f30),
                      hr32.rns_u32_polymul_inv(f30, f30, plan30, midx30)),
          f"{cell30} forward and fused inverse == theirs at log A 2 (two launches)")
    for r in (0, 479):
        gen = g.NTTCPU(ms30[r % 30])
        check(np.array_equal(u32(p30[r]), gen.intt(gen.mult(gen.ntt(a30_np[r]),
                                                            gen.ntt(b30_np[r])))),
              f"{cell30} product row {r} == NTTCPU of member {r % 30}")
    del fa30_plain, fb30_plain, b30_back, p30_64, three30, want30

    # -- 21. times: each kernel at its cell (plain, kernel, kernel, plain), end to end
    timed(F16, lambda: hr32.rns_u32_fwd(a, plan, midx),
          lambda: hr32.rns_u32_fwd_plain(a, plan, midx), bound_ms(128, 16, 1, 3), cell)
    timed(I16, lambda: hr32.rns_u32_inv(fa, plan, midx),
          lambda: hr32.rns_u32_inv_plain(fa, plan, midx), bound_ms(128, 16, 1, 3), cell)
    timed(P16, lambda: hr32.rns_u32_polymul_inv(fa, fa_plain, plan, midx),
          lambda: hr32.rns_u32_polymul_inv_plain(fa, fa_plain, plan, midx),
          bound_ms(128, 16, 2, 3), cell)
    one = g.MergePlan.from_params(ms8[0], device=dev)
    k4 = e2e(f"{hm32.FORWARD['K4'].name} (one modulus, member 0) u32 2^16x128",
             lambda: hm32.merge_u32_fwd(a, one))
    print(f"{F16} / {hm32.FORWARD['K4'].name} at u32 2^16x128: {times[F16][0] / k4:.3f}")
    for what, fn in (("ntt_rns_lanes", lambda: td.ntt_rns_lanes(a, plan, cyc)),
                     ("intt_rns_lanes", lambda: td.intt_rns_lanes(fa, plan, cyc)),
                     ("rns_polymul_lanes", lambda: td.rns_polymul_lanes(a, b, plan, cyc)),
                     ("RNSPolynomialMultiplier",
                      lambda: model(a.view(16, 8, n), b.view(16, 8, n))),
                     ("ntt_lanes (one modulus, yardstick)", lambda: g.ntt_lanes(a, one))):
        e2e(f"{what} {cell} end to end", fn)
    planw, x, y, fx, mw, cycw = wide[20]
    cellw = "RNS u32 2^20x16 L8"
    timed(F6, lambda: hr32.rns_u32_fwd(x, planw, mw),
          lambda: hr32.rns_u32_fwd_plain(x, planw, mw), bound_ms(16, 20, 1, 3), cellw)
    timed(I6, lambda: hr32.rns_u32_inv(fx, planw, mw),
          lambda: hr32.rns_u32_inv_plain(fx, planw, mw), bound_ms(16, 20, 1, 3), cellw)
    timed(P6, lambda: hr32.rns_u32_polymul_inv(fx, fx, planw, mw),
          lambda: hr32.rns_u32_polymul_inv_plain(fx, fx, planw, mw), bound_ms(16, 20, 2, 3),
          cellw)
    for what, fn in (("ntt_rns_lanes", lambda: td.ntt_rns_lanes(x, planw, cycw)),
                     ("intt_rns_lanes", lambda: td.intt_rns_lanes(fx, planw, cycw)),
                     ("rns_polymul_lanes", lambda: td.rns_polymul_lanes(x, y, planw, cycw))):
        e2e(f"{what} {cellw} end to end", fn)
    xw, fxw = wide["i32"]
    timed(f"{F6}_i32", lambda: hr32.rns_u32_fwd(xw, planw, mw),
          lambda: hr32.rns_u32_fwd_plain(xw, planw, mw), bound_ms(16, 20, 1, 3, 4),
          cellw + " int32")
    timed(f"{I6}_i32", lambda: hr32.rns_u32_inv(fxw, planw, mw),
          lambda: hr32.rns_u32_inv_plain(fxw, planw, mw), bound_ms(16, 20, 1, 3, 4),
          cellw + " int32")
    timed(f"{P6}_i32", lambda: hr32.rns_u32_polymul_inv(fxw, fxw, planw, mw),
          lambda: hr32.rns_u32_polymul_inv_plain(fxw, fxw, planw, mw),
          bound_ms(16, 20, 2, 3, 4), cellw + " int32")
    # the int32 instance of K16 at the u32 HE cell's call, and the int64
    # instance on the same rows widened (a caller holding 8-byte words)
    timed(f"{F16}_i32", lambda: hr32.rns_u32_fwd(a30, plan30, midx30),
          lambda: hr32.rns_u32_fwd_plain(a30, plan30, midx30), bound_ms(480, 15, 1, 3, 4),
          cell30)
    timed(f"{I16}_i32", lambda: hr32.rns_u32_inv(f30, plan30, midx30),
          lambda: hr32.rns_u32_inv_plain(f30, plan30, midx30), bound_ms(480, 15, 1, 3, 4),
          cell30)
    timed(f"{P16}_i32", lambda: hr32.rns_u32_polymul_inv(f30, f30, plan30, midx30),
          lambda: hr32.rns_u32_polymul_inv_plain(f30, f30, plan30, midx30),
          bound_ms(480, 15, 2, 3, 4), cell30)

    def product_plain(a, b):
        return hr32.rns_u32_polymul_inv_plain(hr32.rns_u32_fwd_plain(a, plan30, midx30),
                                              hr32.rns_u32_fwd_plain(b, plan30, midx30),
                                              plan30, midx30)

    # the fused product (reads a and b, writes the product: 189 MB on int32
    # lanes) and the three launches it replaces, at the u32 HE cell's call
    timed(f"{PF}_i32", lambda: hr32.rns_u32_polymul(a30, b30, prepared30),
          lambda: product_plain(a30, b30), bound_ms(480, 15, 2, 9, 4), cell30, repeats=2)
    e2e(f"{F16}_i32 twice and {P16}_i32 (three launches, 441 MB) {cell30}",
        lambda: hr32.rns_u32_polymul_inv(hr32.rns_u32_fwd(a30, plan30, midx30),
                                          hr32.rns_u32_fwd(b30, plan30, midx30), plan30, midx30))
    for what, fn in (
            (f"{F16}_i32 at log A 2 (two launches)",
             lambda: old_split("rns_u32_forward", plan30, midx30, a30)),
            (f"{I16}_i32 at log A 2 (two launches)",
             lambda: old_split("rns_u32_inverse", plan30, midx30, f30)),
            (f"{P16}_i32 at log A 2 (two launches)",
             lambda: old_split("rns_u32_polymul_inverse", plan30, midx30, f30, f30))):
        e2e(f"{what} {cell30}", fn)
    a30_64, b30_64, f30_64 = a30.long(), b30.long(), f30.long()
    timed(PF, lambda: hr32.rns_u32_polymul(a30_64, b30_64, prepared30),
          lambda: product_plain(a30_64, b30_64), bound_ms(480, 15, 2, 9), cell30 + " int64",
          repeats=2)
    for what, fn in (
            (f"{F16} on int64 lanes", lambda: hr32.rns_u32_fwd(a30_64, plan30, midx30)),
            (f"{P16} on int64 lanes",
             lambda: hr32.rns_u32_polymul_inv(f30_64, f30_64, plan30, midx30)),
            ("rns_polymul_lanes", lambda: td.rns_polymul_lanes(a30, b30, plan30, cyc30))):
        e2e(f"{what} {cell30} end to end", fn)


# the kmerge phase's (logn, batch) cells: K15's main path, its big check
# cells, K17's two widths and the top of the u32 pool
KMERGE_FULL = dict(main=(16, 128), k15=((14, 8), (15, 8), (20, 16), (24, 1)),
                   k17=((16, 128), (20, 16)), k17_top=(25, 1))


def kmerge_phase(dev, rng, reset, launches, err, times, bounds, sizes=KMERGE_FULL) -> None:
    """26-29: the factored merge kernels of csrc/kmerge.cu, K15's
    counterpart on the use_pallas="vpu" route and K17's (kmerge_u32).
    `sizes` are the larger cells; a CPU device (the kernels' plain
    versions counted in place of their launches, no timing) rehearses the
    phase at small ones."""
    import torch

    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.ops import hopper_kmerge as hk
    from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
    from gpuntt_tpu_torch.ops import hopper_merge_large as hml
    from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64

    PLUS = g.ReductionPolynomial.X_N_plus
    MINUS = g.ReductionPolynomial.X_N_minus
    # (q, psi of order 2^13): q = 2^62 - 1.1e9, and a q past 2^62
    WIDE62 = (4611684918915809281, 4166544109213919754)
    OVER62 = (4611686018427494401, 795177494079348431)
    F15, I15 = hk64.FORWARD.name, hk64.INVERSE.name
    F17, I17 = hk.FORWARD.name, hk.INVERSE.name
    cuda = dev.type == "cuda"
    same, timed, e2e = recorders(err, times, bounds)
    t0 = time.perf_counter()

    def counted() -> dict:
        """{kernel: launches} of the merge kernels since reset() (on a CPU
        rehearsal, plain-version calls); raises if a plain version ran on
        the card."""
        ks = (*hk64.KERNELS, *hk.KERNELS, *hm.KERNELS, *hm32.KERNELS, *hml.KERNELS)
        if cuda:
            torch.cuda.synchronize()
            if any(k.plain_calls for k in ks):
                raise AssertionError(f"plain versions ran: {[k.name for k in ks if k.plain_calls]}")
        return {k.name: n for k in ks if (n := k.launches if cuda else k.plain_calls)}

    def params(logn, poly, dtype=np.uint64, wide=None):
        if wide is None:
            return g.NTTParameters(logn, poly, dtype)
        q, psi = wide
        psi = pow(psi, 1 << (12 - logn), q)
        return g.NTTParameters(logn, poly, dtype, factors=g.NTTFactors(
            g.Modulus64(q), psi * psi % q, psi))

    def residues(p, batch):
        return rng.integers(0, p.modulus.value, size=(batch, p.n), dtype=np.uint64)

    def lanes32(v):
        return torch.from_numpy(np.asarray(v).astype(np.int64)).to(dev)

    def product_want(p, gen, x_np, y_np):
        """The polymul of rows x, y on the "vpu" route: schoolbook's at logn
        7, NTTCPU's above; past 2^62 the inverse of the reference's Barrett
        product mod q (out of its 62-bit domain, it is not the product)."""
        if p.logn == 7:
            return np.stack([g.schoolbook_poly_multiplication(u, v, p.modulus, p.poly_reduction)
                             for u, v in zip(x_np, y_np)])
        fx, fy = gen.ntt(x_np), gen.ntt(y_np)
        if p.modulus.value < 1 << 62:
            return gen.intt(gen.mult(fx, fy))
        cpu = g.MergePlan.from_params(p, device="cpu")
        return gen.intt(g.pointwise_mult(fx, fy, cpu) % np.uint64(p.modulus.value))

    # -- 26. K15 on the main-path width: u64 2^16 x 128, X^N + 1, the pool
    # prime, through the public entries with use_pallas="vpu"
    lm, bm = logn, batch = sizes["main"]
    p = params(logn, PLUS)
    plan = g.MergePlan.from_params(p, device=dev)
    a_np, b_np = residues(p, batch), residues(p, batch)
    a, b = from_numpy_u64(a_np, dev), from_numpy_u64(b_np, dev)
    cell = f"u64 2^{logn}x{batch} vpu"
    t1 = time.perf_counter()
    kp = hk.kernel_plan(plan)
    for inverse in (False, True):
        kp.w(inverse)
    print(f"K15 plan u64 2^{logn} X^N+1: {time.perf_counter() - t1:.3f} s, "
          f"{kp.device_bytes()} bytes on {dev}")
    reset()
    fa = g.ntt_lanes(a, plan, use_pallas="vpu")
    run_f = counted()
    reset()
    back = g.intt_lanes(fa, plan, use_pallas="vpu")
    run_i = counted()
    reset()
    prod = g.polymul_lanes(a, b, plan, use_pallas="vpu")
    run_p = counted()
    check(run_f == {F15: 1} and run_i == {I15: 1} and run_p == {F15: 2, I15: 1},
          f"{cell} ntt_lanes, intt_lanes, polymul_lanes launched K15's counterpart only, "
          f"no K1-K3, no plain version ({run_f}, {run_i}, {run_p})")
    launches[F15], launches[I15] = run_f[F15] + run_p[F15], run_i[I15] + run_p[I15]
    fa_plain, fb_plain = hk.kmerge_plain(a, kp), hk.kmerge_plain(b, kp)
    same(F15, fa, fa_plain, f"{cell} ntt_lanes, all rows,")
    same(I15, back, hk.kmerge_plain(fa, kp, inverse=True), f"{cell} intt_lanes, all rows,")
    check(torch.equal(prod, hk.kmerge_plain(g.pointwise_mult_lanes(fa_plain, fb_plain, plan),
                                            kp, inverse=True)),
          f"{cell} polymul_lanes == the plain versions' pipeline, all rows")
    check(torch.equal(back, a), f"{cell} intt(ntt(a)) == a, all rows")
    check(torch.equal(fa, g.ntt_lanes(a, plan)) and torch.equal(prod, g.polymul_lanes(a, b, plan)),
          f"{cell} ntt_lanes and polymul_lanes == the default route (K1, K3), all rows")
    gen = g.NTTCPU(p)
    for r in (0, batch - 1):
        check(np.array_equal(to_numpy_u64(fa[r]), gen.ntt(a_np[r])), f"{cell} row {r} == NTTCPU")
        check(np.array_equal(to_numpy_u64(prod[r]), product_want(p, gen, a_np[r], b_np[r])),
              f"{cell} polymul row {r} == NTTCPU")

    # -- 27. K15's check cells: schoolbook at logn 7, X^N - 1 at 12, a 62-bit
    # and a past-62-bit q, both sides of the one-block limit (14, 15), the
    # big rings against the default route; signed input and PerCoefficient
    for logn, batch, poly, wide, label in (
            (7, 4, MINUS, None, ""), (12, 4, MINUS, None, ""), (12, 4, PLUS, WIDE62, " WIDE62"),
            (12, 4, PLUS, OVER62, " OVER62"),
            *((logn, batch, PLUS, None, "") for logn, batch in sizes["k15"])):
        p = params(logn, poly, wide=wide)
        planc = g.MergePlan.from_params(p, device=dev)
        x_np, y_np = residues(p, batch), residues(p, batch)
        x, y = from_numpy_u64(x_np, dev), from_numpy_u64(y_np, dev)
        name = f"K15 u64 2^{logn}x{batch} {poly.name}{label}"
        reset()
        fx = g.ntt_lanes(x, planc, use_pallas="vpu")
        bx = g.intt_lanes(fx, planc, use_pallas="vpu")
        pxy = g.polymul_lanes(x, y, planc, use_pallas="vpu")
        run = counted()
        check(run == {F15: 3, I15: 2}, f"{name} vpu entries launched {run}")
        kpc = hk.kernel_plan(planc)
        print(f"{name}: K15 plan {kpc.device_bytes()} bytes on {dev} (both W tables)")
        same(F15, fx, hk.kmerge_plain(x, kpc), f"{name} ntt_lanes")
        same(I15, bx, hk.kmerge_plain(fx, kpc, inverse=True), f"{name} intt_lanes")
        check(torch.equal(bx, x), f"{name} intt(ntt(x)) == x")
        check(torch.equal(fx, g.ntt_lanes(x, planc)), f"{name} ntt_lanes == the default route")
        if p.modulus.value < 1 << 62:
            check(torch.equal(pxy, g.polymul_lanes(x, y, planc)),
                  f"{name} polymul_lanes == the default route")
        genc = g.NTTCPU(p)
        for r in (range(batch) if logn <= 12 else (batch - 1,) if logn <= 20 else ()):
            check(np.array_equal(to_numpy_u64(fx[r]), genc.ntt(x_np[r])),
                  f"{name} row {r} == NTTCPU")
            check(np.array_equal(to_numpy_u64(pxy[r]),
                                 product_want(p, genc, x_np[r:r + 1], y_np[r:r + 1])[0]),
                  f"{name} polymul row {r} == {'schoolbook' if logn == 7 else 'NTTCPU'}")
        del fx, bx, pxy, x, y
    p = params(12, PLUS)
    planc = g.MergePlan.from_params(p, device=dev)
    q = p.modulus.value
    s = torch.from_numpy(rng.integers(-(q // 2), q // 2, size=(4, p.n), dtype=np.int64)).to(dev)
    reset()
    fs = g.ntt_lanes(s, planc, use_pallas="vpu", signed_input=True)
    st = s.abs().t().contiguous()
    ft = g.ntt_lanes(st, planc, use_pallas="vpu", layout=g.NTTLayout.PerCoefficient)
    run = counted()
    check(run == {F15: 2}, f"K15 u64 2^12 signed input and PerCoefficient launched {run}")
    check(torch.equal(fs, g.ntt_lanes(s, planc, signed_input=True))
          and torch.equal(g.intt_lanes(fs, planc, use_pallas="vpu", signed_output=True), s),
          "K15 u64 2^12 signed_input / signed_output == the default route, round trip")
    check(torch.equal(ft, g.ntt_lanes(st, planc, layout=g.NTTLayout.PerCoefficient)),
          "K15 u64 2^12 PerCoefficient == the default route")

    # -- 28. K17 (kmerge_u32) at the JAX bench line's u32 widths, X^N + 1,
    # q = 469762049, then its check cells (both sides of the one-block
    # limit, 14 and 15, among them)
    k17 = {}
    (l16, b16), (l20, b20) = sizes["k17"]
    for logn, batch, poly, bits in ((l16, b16, PLUS, None), (l20, b20, PLUS, None),
                                    (7, 4, PLUS, None), (8, 4, MINUS, None),
                                    (14, 4, PLUS, 30), (15, 4, MINUS, None),
                                    (*sizes["k17_top"], PLUS, None)):
        if bits is None:
            p32 = params(logn, poly, np.uint32)
        else:
            q30 = g.find_ntt_primes(bits, logn, 1)[0]
            p32 = g.NTTParameters(logn, poly, np.uint32, factors=g.NTTFactors(
                g.Modulus32(q30), *g.ntt_root_pair(q30, logn)))
        plan32 = g.MergePlan.from_params(p32, device=dev)
        kp32 = hk.kernel_plan(plan32)
        x_np = residues(p32, batch).astype(np.uint32)
        x = lanes32(x_np)
        name = f"K17 u32 2^{logn}x{batch} {poly.name}" + (f" {bits}-bit q" if bits else "")
        reset()
        fx = hk.kmerge_u32(x, kp32)
        bx = hk.kmerge_u32(fx, kp32, inverse=True)
        run = counted()
        check(run == {F17: 1, I17: 1}, f"{name} kmerge_u32 launched {run}")
        if (logn, batch) == (l16, b16):
            launches.update(run)
        same(F17, fx, hk.kmerge_plain(x, kp32), f"{name} forward, all rows,")
        same(I17, bx, hk.kmerge_plain(fx, kp32, inverse=True), f"{name} inverse, all rows,")
        check(torch.equal(bx, x), f"{name} inverse(forward(x)) == x")
        check(torch.equal(fx, g.ntt_lanes(x, plan32)),
              f"{name} == ntt_lanes ({'the engine' if logn < 8 else 'K4-K6'}), all rows")
        gen32 = g.NTTCPU(p32)
        for r in (0, batch - 1) if logn < 24 else ():
            check(np.array_equal(fx[r].cpu().numpy().astype(np.uint32), gen32.ntt(x_np[r])),
                  f"{name} row {r} == NTTCPU")
        if logn <= 8:
            y_np = residues(p32, batch).astype(np.uint32)
            fy = hk.kmerge_u32(lanes32(y_np), kp32)
            pxy = hk.kmerge_u32(g.pointwise_mult_lanes(fx, fy, plan32), kp32, inverse=True)
            check(np.array_equal(pxy.cpu().numpy().astype(np.uint32),
                                 product_want(p32, gen32, x_np, y_np)),
                  f"{name} inverse(forward(x) o forward(y)) == "
                  f"{'schoolbook' if logn == 7 else 'NTTCPU'}, all rows")
        if (logn, batch) in sizes["k17"]:
            k17[logn] = (plan32, kp32, x, fx)
    print(f"kmerge phase {time.perf_counter() - t0:.1f} s before timing")
    if not cuda:
        return

    # -- 29. times: each entry and its plain version (plain, kernel, kernel,
    # plain), beside K1/K2 and K4 on the same tensors
    timed(F15, lambda: hk64.kmerge_u64(a, kp), lambda: hk.kmerge_plain(a, kp),
          bound_ms(bm, lm, 1, 16), cell)
    timed(I15, lambda: hk64.kmerge_u64(fa, kp, inverse=True),
          lambda: hk.kmerge_plain(fa, kp, inverse=True), bound_ms(bm, lm, 1, 16), cell)
    k1 = e2e(f"{hm.FORWARD.name} (K1) {cell}", lambda: hm.merge_u64_fwd(a, plan))
    k2 = e2e(f"{hm.INVERSE.name} (K2) {cell}", lambda: hm.merge_u64_inv(fa, plan))
    print(f"{F15} / K1 {times[F15][0] / k1:.3f}, {I15} / K2 {times[I15][0] / k2:.3f}")
    for what, fn in (("ntt_lanes", lambda: g.ntt_lanes(a, plan, use_pallas="vpu")),
                     ("intt_lanes", lambda: g.intt_lanes(fa, plan, use_pallas="vpu")),
                     ("polymul_lanes", lambda: g.polymul_lanes(a, b, plan, use_pallas="vpu"))):
        e2e(f"{what} {cell} end to end", fn)
    plan32, kp32, x, fx = k17[l16]
    cell32 = f"u32 2^{l16}x{b16} kmerge_u32"
    timed(F17, lambda: hk.kmerge_u32(x, kp32), lambda: hk.kmerge_plain(x, kp32),
          bound_ms(b16, l16, 1, 3), cell32)
    timed(I17, lambda: hk.kmerge_u32(fx, kp32, inverse=True),
          lambda: hk.kmerge_plain(fx, kp32, inverse=True), bound_ms(b16, l16, 1, 3), cell32)
    k4 = e2e(f"{hm32.FORWARD['K4'].name} (K4) u32 2^{l16}x{b16}",
             lambda: hm32.merge_u32_fwd(x, plan32))
    k4i = e2e(f"{hm32.INVERSE['K4'].name} (K4) u32 2^{l16}x{b16}",
              lambda: hm32.merge_u32_inv(fx, plan32))
    print(f"{F17} / K4 {times[F17][0] / k4:.3f}, {I17} / K4 {times[I17][0] / k4i:.3f}")
    plan32, kp32, x, fx = k17[l20]
    for what, fn in (("kmerge_u32 forward", lambda: hk.kmerge_u32(x, kp32)),
                     ("kmerge_u32 inverse", lambda: hk.kmerge_u32(fx, kp32, inverse=True)),
                     ("merge_u32_forward (K6)", lambda: hm32.merge_u32_fwd(x, plan32))):
        e2e(f"{what} u32 2^{l20}x{b20}", fn)


DIST_FULL = dict(four=24, merge=20, rns=20, poly=16, merge_tails=(8, 4))


def dist_phase(dev, rng, reset, launches, err, times, bounds, sizes=DIST_FULL) -> None:
    """22-25: the distributed path (parallel/) at world size 1 on NCCL, and
    the kernels of a wider mesh one shard at a time ("virtual ranks":
    collectives cannot span ranks on one card).  `sizes` are the rings; a
    CPU device (gloo, the kernels' plain versions, no timing) rehearses
    the phase at small ones."""
    import torch
    import torch.distributed as dist

    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.models.polymul import (DistPolynomialMultiplier,
                                                 DistRNSPolynomialMultiplier)
    from gpuntt_tpu_torch.ops import dispatch as td
    from gpuntt_tpu_torch.ops import hopper_fourstep as hf
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
    from gpuntt_tpu_torch.ops import hopper_merge_large as hml
    from gpuntt_tpu_torch.ops import hopper_rns as hr
    from gpuntt_tpu_torch.ops.limb import from_numpy_u64
    from gpuntt_tpu_torch.parallel import mesh as M
    from gpuntt_tpu_torch.parallel.fourstep_dist import (DistFourStepPlan, dist_fourstep_intt,
                                                         dist_fourstep_ntt)
    from gpuntt_tpu_torch.parallel.merge_dist import (dist_merge_intt, dist_merge_ntt,
                                                      merge_dist_tails)

    MINUS, PLUS = g.ReductionPolynomial.X_N_minus, g.ReductionPolynomial.X_N_plus
    cuda = dev.type == "cuda"
    CFL, CIL = hml.COLFWD_LOCAL.name, hml.COLINV_LOCAL.name
    K1, K2 = hm.FORWARD.name, hm.INVERSE.name
    same, timed, e2e = recorders(err, times, bounds)

    def counted() -> dict:
        """{kernel: launches} since reset() (on a CPU rehearsal, plain-version
        calls); raises if a plain version ran on the card."""
        ks = (*hm.KERNELS, *hm32.KERNELS, *hml.KERNELS, *hml.LOCAL_KERNELS, *hf.KERNELS,
              *hr.KERNELS)
        if cuda:
            torch.cuda.synchronize()
            if any(k.plain_calls for k in ks):
                raise AssertionError(f"plain versions ran: {[(k.name, k.plain_calls) for k in ks]}")
        return {k.name: n for k in ks if (n := k.launches if cuda else k.plain_calls)}

    t0 = time.perf_counter()
    dist.init_process_group("nccl" if cuda else "gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    mesh = M.make_mesh(1, 1, device=dev)
    print(f"dist: world size {dist.get_world_size()}, backend {dist.get_backend()}, mesh "
          f"{tuple(mesh.shape)} {mesh.mesh_dim_names}")

    # -- 22. the dist 4-step at 2^24 x 1, u64 (K7' + rows on K1/K2) and u32
    four = {}
    for dtype in (np.uint64, np.uint32):
        is64 = dtype == np.uint64
        p = g.NTTParameters4Step(sizes["four"], MINUS, dtype)
        cell = f"dist 4-step u{64 if is64 else 32} 2^{p.logn}x1 (sp 1)"
        t1 = time.perf_counter()
        dplan = DistFourStepPlan.from_params(p, device=dev)
        print(f"{cell} plan build {time.perf_counter() - t1:.3f} s (n1={p.n1} n2={p.n2}, "
              f"colmat {dplan.colmat is not None})")
        x_np = rng.integers(0, p.modulus.value, size=(1, p.n), dtype=np.uint64)
        x = from_numpy_u64(x_np, dev) if is64 else torch.from_numpy(x_np.view(np.int64)).to(dev)
        xl = M.shard(x.view(1, p.n1, p.n2), mesh, M.BLOCKS)
        reset()
        spec = dist_fourstep_ntt(xl, dplan, mesh)
        back = dist_fourstep_intt(spec, dplan, mesh)
        run = counted()
        want = {}  # each sub-plan's kernels, forward and inverse once
        for sub in (dplan.col, dplan.row):
            if is64 and sub is dplan.col:
                pair = (CFL, CIL)
            elif hm.covers(sub) or hm32.covers(sub):
                kf = hm.FORWARD if is64 else hm32.FORWARD[hm32.tpu_kernel(sub.logn)]
                ki = hm.INVERSE if is64 else hm32.INVERSE[hm32.tpu_kernel(sub.logn)]
                pair = (kf.name, ki.name)
            else:
                continue  # the engine
            for name in pair:
                want[name] = want.get(name, 0) + 1
        check(run == want, f"{cell} dist_fourstep_ntt, _intt launched {run}")
        if is64:
            launches.update({CFL: run[CFL], CIL: run[CIL]})
        single = g.FourStepPlan.from_params(p, device=dev)
        check(torch.equal(spec.reshape(1, p.n), g.fourstep_ntt_full(x, single)),
              f"{cell} forward == single-chip fourstep_ntt_full")
        check(torch.equal(back, xl), f"{cell} inverse(forward(x)) == x")
        four[is64] = (dplan, xl, spec, p)
        del back

    # -- 23. K7' one shard at a time: sp = 4 and 8 at u64 2^24 against its plain
    # version and the same columns of the sp = 1 launch
    dplan, xl, spec, p = four[True]
    lp = dplan.colmat
    whole = {False: hml.col_phase_local(xl, lp, 0, 1, False)}
    whole[True] = hml.col_phase_local(whole[False], lp, 0, 1, True)
    for inverse in (False, True):
        src = whole[False] if inverse else xl
        same(CIL if inverse else CFL, whole[inverse],
             hml.col_phase_local_plain(src, lp, 0, 1, inverse), f"K7' sp 1 inverse={inverse}")
        for sp in (4, 8):
            bl = lp.B // sp
            for sh in range(sp):
                cols = slice(sh * bl, (sh + 1) * bl)
                xs = src[:, :, cols].contiguous()
                got = hml.col_phase_local(xs, lp, sh, sp, inverse)
                want = hml.col_phase_local_plain(xs, lp, sh, sp, inverse)
                e = int((got - want).abs().max().item())
                err[CIL if inverse else CFL] = max(err.get(CIL if inverse else CFL, 0), e)
                if not (torch.equal(got, want) and torch.equal(got, whole[inverse][:, :, cols])):
                    raise AssertionError(f"K7' sp {sp} shard {sh} inverse={inverse} differs")
            print(f"ok   K7' sp {sp}, all {sp} shards, inverse={inverse} == plain version and "
                  f"the sp 1 columns")

    # -- 24. the dist merge at u64 2^20 x 1 (sp 1: the tail is the whole twisted
    # ring, from_eval on the big-ring plan), and the tails of sp = 8 and 4
    pm = g.NTTParameters(sizes["merge"], PLUS, np.uint64)
    plan = g.MergePlan.from_params(pm, device=dev)
    xm = from_numpy_u64(rng.integers(0, pm.modulus.value, size=(1, pm.n), dtype=np.uint64), dev)
    cell = f"dist merge u64 2^{pm.logn}x1 (sp 1)"
    reset()
    fm = dist_merge_ntt(xm, plan, mesh)
    bm = dist_merge_intt(fm, plan, mesh)
    run = counted()
    check(set(run) <= {K1, K2, hml.COLFWD.name, hml.COLINV.name, hml.ROWMAT.name} and run,
          f"{cell} dist_merge_ntt, _intt launched {run}")
    check(torch.equal(fm, g.ntt_lanes(xm, plan)), f"{cell} forward == single-chip ntt_lanes")
    check(torch.equal(bm, xm), f"{cell} inverse(forward(x)) == x")
    for sp in sizes["merge_tails"]:
        for r in range(sp):
            tail = merge_dist_tails(plan, sp, r)
            xt = from_numpy_u64(rng.integers(0, pm.modulus.value, size=(1, tail.n),
                                             dtype=np.uint64), dev)
            ft, it = g.ntt_lanes(xt, tail), g.intt_lanes(xt, tail)
            if tail.bigring:
                lpt = hml.large_plan(tail)
                want = (hml.merge_u64_large_plain(xt, lpt),
                        hml.merge_u64_large_plain(xt, lpt, inverse=True))
            elif hm.covers(tail):
                want = hm.merge_u64_fwd_plain(xt, tail), hm.merge_u64_inv_plain(xt, tail)
            else:
                want = g.ntt_lanes(xt, tail, use_pallas=False), g.intt_lanes(xt, tail, use_pallas=False)
            if not (torch.equal(ft, want[0]) and torch.equal(it, want[1])):
                raise AssertionError(f"merge tail sp {sp} rank {r} differs from its plain version")
        print(f"ok   dist merge 2^{pm.logn} tails of sp {sp} (2^{tail.logn}, "
              f"{'big-ring plan' if tail.bigring else 'K1/K2' if hm.covers(tail) else 'engine'}"
              f"), every rank, forward and "
              f"inverse == plain versions")

    # -- 25. the models: DistRNSPolynomialMultiplier at 2^20, ladder 4, batch 4, and
    # DistPolynomialMultiplier at 2^16 x 4, against the single-chip polymuls
    logn = sizes["rns"]
    qs = g.find_ntt_primes(59, logn, 4)
    fours, merges = [], []
    for q in qs:
        f = g.NTTFactors(g.Modulus64(q), *g.ntt_root_pair(q, logn))
        fours.append(g.NTTParameters4Step(logn, MINUS, np.uint64, factors=f))
        merges.append(g.NTTParameters(logn, MINUS, np.uint64, factors=f))
    mod_idx = np.arange(4) % 4
    a_np, b_np = (np.stack([rng.integers(0, q, size=1 << logn, dtype=np.uint64) for q in qs])
                  for _ in range(2))
    a, b = from_numpy_u64(a_np, dev), from_numpy_u64(b_np, dev)
    p0 = fours[0]
    rmodel = DistRNSPolynomialMultiplier(fours, mesh, device=dev)
    cell = f"DistRNSPolynomialMultiplier 2^{logn}x4 ladder 4 (sp 1)"
    reset()
    out = rmodel.step_lanes(a.view(4, p0.n1, p0.n2), b.view(4, p0.n1, p0.n2), mod_idx)
    run = counted()
    rows_k12 = hr.covers(rmodel.dplan.row)  # K12 takes the rows at 2^12-2^17
    check(run == ({hr.FORWARD.name: 2, hr.INVERSE.name: 1} if rows_k12 else {}),
          f"{cell} launched {run}")
    want = td.rns_polymul_lanes(a, b, g.RNSMergePlan.from_params(merges, device=dev), mod_idx)
    check(torch.equal(out.reshape(4, -1), want), f"{cell} == single-chip rns_polymul_lanes")

    f = g.NTTFactors(g.Modulus64(qs[0]), *g.ntt_root_pair(qs[0], sizes["poly"]))
    pp = g.NTTParameters4Step(sizes["poly"], MINUS, np.uint64, factors=f)
    model = DistPolynomialMultiplier(pp, mesh, pipeline_chunks=2, device=dev)
    a_np, b_np = (rng.integers(0, qs[0], size=(4, pp.n), dtype=np.uint64) for _ in range(2))
    a, b = from_numpy_u64(a_np, dev), from_numpy_u64(b_np, dev)
    cell = f"DistPolynomialMultiplier 2^{pp.logn}x4 (sp 1, pipeline_chunks 2)"
    reset()
    out = model.step_lanes(a.view(4, pp.n1, pp.n2), b.view(4, pp.n1, pp.n2))
    run = counted()
    check(run.get(CFL, 0) == 4 and run.get(CIL, 0) == 2, f"{cell} launched {run}")
    single = g.MergePlan.from_params(g.NTTParameters(pp.logn, MINUS, np.uint64, factors=f),
                                     device=dev)
    check(torch.equal(out.reshape(4, -1), g.polymul_lanes(a, b, single)),
          f"{cell} == single-chip polymul_lanes")
    print(f"dist phase {time.perf_counter() - t0:.1f} s before timing")

    if cuda:  # -- times: K7' at its cell, and dist_fourstep_ntt at 2^24 x 1
        print(card_line())
        dplan, xl, spec, p = four[True]
        n = p.n

        def k7_local_bound(inverse):
            return bound_of(2 * 8 * n, 16 * (n // 2 * (p.n1.bit_length() - 1)
                                             + (3 if inverse else 2) * n))

        cell = f"dist 4-step u64 2^{p.logn}x1 sp 1"
        timed(CFL, lambda: hml.col_phase_local(xl, dplan.colmat, 0, 1, False),
              lambda: hml.col_phase_local_plain(xl, dplan.colmat, 0, 1, False),
              k7_local_bound(False), cell)
        timed(CIL, lambda: hml.col_phase_local(xl, dplan.colmat, 0, 1, True),
              lambda: hml.col_phase_local_plain(xl, dplan.colmat, 0, 1, True),
              k7_local_bound(True), cell)
        shard = xl[:, :, :p.n2 // 4].contiguous()
        e2e(f"K7' one shard of sp 4, {cell.replace('sp 1', '')}",
            lambda: hml.col_phase_local(shard, dplan.colmat, 1, 4, False))
        print(f"bound K7' one shard of sp 4: {k7_local_bound(False)[0] / 4:.5f} ms")
        single = g.FourStepPlan.from_params(p, device=dev)
        for what, fn in (("dist_fourstep_ntt", lambda: dist_fourstep_ntt(xl, dplan, mesh)),
                         ("dist_fourstep_intt", lambda: dist_fourstep_intt(spec, dplan, mesh)),
                         ("fourstep_ntt_full (single chip)",
                          lambda: g.fourstep_ntt_full(xl.view(1, n), single))):
            e2e(f"{what} {cell} end to end", fn)
    dist.destroy_process_group()


# the examples phase's cells (LOGN, BATCH) for each device example: PERF.md §4's
# cells; a CPU device rehearses the phase at small ones
EXAMPLES_FULL = dict(example_merge_ntt=(16, 128), example_merge_intt=(16, 128),
                     example_4step_ntt=(16, 128), example_4step_intt=(16, 128),
                     example_rns_ntt=(16, 64), example_rns_polymul=(12, 3),
                     example_distributed_polymul=(16, 4))


def launch_counter(cuda: bool):
    """(reset, ran): zero every counter; {kernel name: launches} since the
    reset (on a CPU rehearsal, plain-version calls), raising if a plain
    version ran on the card.  Every kernel wrapper's counters, the
    probe's included."""
    import torch

    from gpuntt_tpu_torch.common import tracing
    from gpuntt_tpu_torch.ops import hopper_fourstep as hf
    from gpuntt_tpu_torch.ops import hopper_kmerge as hk
    from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
    from gpuntt_tpu_torch.ops import hopper_merge_large as hml
    from gpuntt_tpu_torch.ops import hopper_rns as hr
    from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
    from gpuntt_tpu_torch.utils import profiling as pr

    stats = [*hm.KERNELS, *hm32.KERNELS, *hml.KERNELS, *hml.LOCAL_KERNELS, *hf.KERNELS,
             *hr.KERNELS, *hr32.KERNELS, *hk64.KERNELS, *hk.KERNELS, *pr.KERNELS]

    def ran() -> dict:
        if cuda:
            torch.cuda.synchronize()
            if any(k.plain_calls for k in stats):
                raise AssertionError(
                    f"plain versions ran: {[(k.name, k.plain_calls) for k in stats]}")
        return {k.name: n for k in stats if (n := k.launches if cuda else k.plain_calls)}

    return tracing.reset, ran


def examples_phase(dev, cells=EXAMPLES_FULL) -> None:
    """30. every device example's main in this process at its cell, then the
    two host examples at their defaults: each must print `All Correct.` and
    return 0, and launch the kernels its route names (K1, K2, K9 + K10,
    K12, K12 fused; the dist example's route is printed and must include
    K7').  A CPU device rehearses the phase at small cells (the dist
    example's gloo ranks then count in their own processes)."""
    import contextlib
    import importlib
    import io

    from gpuntt_tpu_torch.ops import hopper_fourstep as hf
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops import hopper_merge_large as hml
    from gpuntt_tpu_torch.ops import hopper_rns as hr

    cuda = dev.type == "cuda"
    reset, ran = launch_counter(cuda)
    K7L = {hml.COLFWD_LOCAL.name, hml.COLINV_LOCAL.name}
    want = dict(example_merge_ntt={hm.FORWARD.name: 3},
                example_merge_intt={hm.INVERSE.name: 3},
                example_4step_ntt={hf.COL64.name: 1, hf.ROW64.name: 1},
                example_4step_intt={hf.COL64.name: 1, hf.ROW64.name: 1},
                example_rns_ntt={hr.FORWARD.name: 2, hr.INVERSE.name: 2},
                example_rns_polymul={hr.FORWARD.name: 2, hr.POLYMUL_INVERSE.name: 1})
    t_phase = time.perf_counter()
    runs = [(name, [str(logn), str(batch), f"--device={dev}"]) for name, (logn, batch)
            in cells.items()]
    runs += [("example_cpu_merge_ntt", []), ("example_cpu_4step_ntt", [])]
    for name, argv in runs:
        mod = importlib.import_module(f"gpuntt_tpu_torch.examples.{name}")
        buf = io.StringIO()
        reset()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(argv)
        secs = time.perf_counter() - t0
        run = ran()
        out = buf.getvalue()
        cell = f"{name} {' '.join(argv)}".strip()
        check(rc == 0 and "All Correct." in out.splitlines(),
              f"{cell}: rc {rc}, {out.strip().splitlines()[-1]!r} ({secs:.2f} s)")
        if name in want and (cuda or name != "example_distributed_polymul"):
            check(run == want[name], f"{cell} launched {run}")
        elif name == "example_distributed_polymul" and cuda:
            check(K7L <= set(run), f"{cell} launched {run} (K7' among them)")
        if name == "example_rns_polymul":
            qs, a_int, b_int = mod.operands(*cells[name])
            t0 = time.perf_counter()
            mod.schoolbook(a_int, b_int, int(np.prod(np.array(qs, dtype=object))))
            print(f"{name}: its golden big-integer schoolbook alone "
                  f"{time.perf_counter() - t0:.2f} s of the {secs:.2f} s")
    print(f"examples phase {time.perf_counter() - t_phase:.1f} s")


def entry_phase(dev, big=(16, 128)) -> None:
    """31. the CUDA-graph capture of the entry's step (u64 2^12 x 4, X^N + 1:
    K1 twice, K3) and of polymul_lanes at the headline u64 2^16 x 128 (the
    same kernels): replay == eager == NTTCPU, every row; then CUDA-event
    times of eager and replayed calls (3 warm-ups, the median of 10 windows
    of 10): eager minus replay is the host's share of one call."""
    import torch

    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch import entry as E
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64
    from gpuntt_tpu_torch.utils.timing import time_cuda

    reset, ran = launch_counter(True)
    t_phase = time.perf_counter()
    fn, args = E.entry(dev)
    p = g.NTTParameters(big[0], g.ReductionPolynomial.X_N_plus, np.uint64)
    plan = g.MergePlan.from_params(p, device=dev)
    rng = np.random.default_rng(SEED)
    a_np, b_np = (rng.integers(0, p.modulus.value, size=(big[1], p.n), dtype=np.uint64)
                  for _ in range(2))
    gen = g.NTTCPU(p)
    cells = ((f"entry() step u64 2^{E.LOGN}x{E.BATCH}", fn, args, E.golden()),
             (f"polymul_lanes u64 2^{big[0]}x{big[1]}", lambda u, v: g.polymul_lanes(u, v, plan),
              (from_numpy_u64(a_np, dev), from_numpy_u64(b_np, dev)),
              gen.intt(gen.mult(gen.ntt(a_np), gen.ntt(b_np)))))
    for cell, f, fargs, golden in cells:
        reset()
        eager, replay, graph = E.graph_check(f, fargs)
        run = ran()  # the eager call, the side-stream warm-up, the captured call
        check(run == {hm.FORWARD.name: 6, hm.POLYMUL_INVERSE.name: 3},
              f"{cell}: eager, warm-up and capture launched {run}")
        check(torch.equal(replay, eager), f"{cell}: CUDA-graph replay == eager output")
        check(np.array_equal(to_numpy_u64(replay), golden), f"{cell}: replay == NTTCPU, all rows")
        e_ms, e_sp = time_cuda(lambda: f(*fargs))
        r_ms, r_sp = time_cuda(graph.replay)
        print(f"time {cell}: eager {e_ms:.5f} ms (spread {e_sp:.3f}), graph replay "
              f"{r_ms:.5f} ms (spread {r_sp:.3f}), eager - replay {e_ms - r_ms:.5f} ms")
        del graph, replay
    print(f"entry phase {time.perf_counter() - t_phase:.1f} s")


PROBE_DEPTH = 5


def probe_phase(dev) -> None:
    """32. the modmul-peak probe (csrc/probe.cu, which replaces no TPU kernel):
    shoup_chain against its plain version on the card, both words, at the
    pool prime and the largest NTT prime below 2^62 / 2^30, edge words
    included; then measure_modmul_peak of each word at its defaults, on a
    line of its own beside the card's name and power limit."""
    import torch

    from gpuntt_tpu_torch.common import tracing
    from gpuntt_tpu_torch.ops.limb import from_numpy_u64
    from gpuntt_tpu_torch.utils import profiling as pr
    from gpuntt_tpu_torch.utils.kernel_bench import largest_ntt_prime

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    pools = {True: 576460756061519873, False: 469762049}
    for is64 in (True, False):
        for q in (pools[is64], largest_ntt_prime(62 if is64 else 30, 17)):
            x_np = np.concatenate([np.array([0, 1, 2, q - 2, q - 1], dtype=np.uint64),
                                   rng.integers(0, q, size=(1 << 20) + 3, dtype=np.uint64)])
            x = from_numpy_u64(x_np, dev)
            for w in (1, q - 1, int(rng.integers(2, q - 1))):
                tracing.reset()
                got = pr.shoup_chain(x, w, q, PROBE_DEPTH, is64)
                want = pr.shoup_chain_plain(x, w, q, PROBE_DEPTH, is64)
                stats = pr.CHAIN64 if is64 else pr.CHAIN32
                e = int((got - want).abs().max().item())
                check(torch.equal(got, want) and (stats.launches == 1) == cuda,
                      f"{stats.name} q={q} w={w} depth {PROBE_DEPTH} on {x.numel()} words "
                      f"== plain version (max |diff| {e}), launches {stats.launches}")
    if cuda:
        rates = {}
        for is64 in (True, False):
            rates[is64] = pr.measure_modmul_peak(pools[is64], is64, device=dev)
        print(f"probe measure_modmul_peak (depth {pr._DEPTH[True]} / {pr._DEPTH[False]} on "
              f"{pr._ELEMS['cuda']} words): u64 {rates[True]:.6e} products/s, u32 "
              f"{rates[False]:.6e} products/s, on {card_line()}")
    print(f"probe phase {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1

    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.common import tracing
    from gpuntt_tpu_torch.ops import _build
    from gpuntt_tpu_torch.ops import barrett as bo
    from gpuntt_tpu_torch.ops import hopper_fourstep as hf
    from gpuntt_tpu_torch.ops import hopper_kmerge as hk
    from gpuntt_tpu_torch.ops import hopper_kmerge64 as hk64
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
    from gpuntt_tpu_torch.ops import hopper_merge_large as hml
    from gpuntt_tpu_torch.ops import hopper_rns as hr
    from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
    from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64
    from gpuntt_tpu_torch.ops.merge_ntt import from_lanes
    from gpuntt_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    t_start = time.perf_counter()

    reset = tracing.reset

    def counted() -> dict:
        """{kernel: launches} of the u64 kernels that ran since reset();
        raises if a plain version ran."""
        torch.cuda.synchronize()
        ks = (*hm.KERNELS, *hml.KERNELS)
        if any(k.plain_calls for k in ks):
            raise AssertionError(f"plain versions ran: {[(k.name, k.plain_calls) for k in ks]}")
        return {k.name: k.launches for k in ks if k.launches}

    # -- 1. card and build
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"kernel build+load {time.perf_counter() - t0:.2f} s " + " ".join(
        f"(nvcc {n} {i['seconds']:.2f} s)" for n, i in _build.build_info.items()))
    for info in _build.build_info.values():
        for line in info["log"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("ptxas", line.strip())

    launches, err, times, bounds = {}, {}, {}, {}

    # -- 2. the u64 main path at full width
    p = g.NTTParameters(LOGN, g.ReductionPolynomial.X_N_plus, np.uint64)
    q = p.modulus.value
    plan = g.MergePlan.from_params(p, device=dev)
    a_np = rng.integers(0, q, size=(BATCH, p.n), dtype=np.uint64)
    b_np = rng.integers(0, q, size=(BATCH, p.n), dtype=np.uint64)
    a, b = from_numpy_u64(a_np, dev), from_numpy_u64(b_np, dev)

    reset()
    fa = g.ntt_lanes(a, plan)
    back = g.intt_lanes(fa, plan)
    prod = g.polymul_lanes(a, b, plan)
    torch.cuda.synchronize()
    launches.update({k.name: k.launches for k in hm.KERNELS})
    for k in hm.KERNELS:
        check(k.launches > 0 and k.plain_calls == 0,
              f"u64 main path launched {k.name} {k.launches}x, plain version "
              f"{k.plain_calls}x")

    fa_plain = hm.merge_u64_fwd_plain(a, plan)
    fb_plain = hm.merge_u64_fwd_plain(b, plan)
    pairs = {
        hm.FORWARD.name: (fa, fa_plain),
        hm.INVERSE.name: (back, hm.merge_u64_inv_plain(fa, plan)),
        hm.POLYMUL_INVERSE.name: (
            prod, hm.merge_u64_polymul_inv_plain(fa_plain, fb_plain, plan)),
    }
    for name, (got, want) in pairs.items():
        err[name] = int((got - want).abs().max().item())
        check(torch.equal(got, want),
              f"{name} == plain version, all {BATCH} rows (max |diff| {err[name]})")
    check(torch.equal(back, a), "u64 intt(ntt(a)) == a, all rows")

    gen = g.NTTCPU(p)
    for r in (0, BATCH - 1):
        check(np.array_equal(to_numpy_u64(fa[r]), gen.ntt(a_np[r])),
              f"u64 ntt row {r} == NTTCPU")
        want = gen.intt(gen.mult(gen.ntt(a_np[r]), gen.ntt(b_np[r])))
        check(np.array_equal(to_numpy_u64(prod[r]), want), f"u64 polymul row {r} == NTTCPU")

    # -- 3. small cell against schoolbook
    ps = g.NTTParameters(12, g.ReductionPolynomial.X_N_minus, np.uint64)
    xs = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64)
    ys = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64)
    reset()
    got = g.polymul(xs, ys, g.MergePlan.from_params(ps, device=dev))
    check(hm.POLYMUL_INVERSE.launches == 1, "u64 logn 12 polymul ran the kernels")
    for r in range(4):
        check(np.array_equal(got[r], g.schoolbook_poly_multiplication(
            xs[r], ys[r], ps.modulus, ps.poly_reduction)),
            f"u64 logn 12 X^N-1 polymul row {r} == schoolbook")

    # -- 4. wide and narrow moduli
    for bits, poly in ((62, g.ReductionPolynomial.X_N_plus),
                       (46, g.ReductionPolynomial.X_N_minus)):
        qw = g.find_ntt_primes(bits, 14, 1)[0]
        omega, psi = g.ntt_root_pair(qw, 14)
        pw = g.NTTParameters(14, poly, np.uint64,
                             factors=g.NTTFactors(g.Modulus64(qw), omega, psi))
        planw = g.MergePlan.from_params(pw, device=dev)
        xw = rng.integers(0, qw, size=(4, pw.n), dtype=np.uint64)
        yw = rng.integers(0, qw, size=(4, pw.n), dtype=np.uint64)
        genw = g.NTTCPU(pw)
        reset()
        fw = g.ntt(xw, planw)
        check(np.array_equal(fw, genw.ntt(xw)), f"{bits}-bit q={qw} ntt == NTTCPU")
        check(np.array_equal(g.intt(fw, planw), xw), f"{bits}-bit intt(ntt) == x")
        check(np.array_equal(g.polymul(xw, yw, planw),
                             genw.intt(genw.mult(genw.ntt(xw), genw.ntt(yw)))),
              f"{bits}-bit polymul == NTTCPU")
        check(all(k.launches > 0 for k in hm.KERNELS), f"{bits}-bit q ran the kernels")

    # -- 5. the nn.Module
    model = g.PolynomialMultiplier(p, device=dev)
    check(torch.equal(model(a, b), prod), "u64 PolynomialMultiplier == polymul_lanes")

    # -- 6. the u32 path at the bench line's two widths
    u32_cells = {}
    for logn32, batch32 in ((16, 128), (20, 16)):
        k = hm32.tpu_kernel(logn32)
        fwd_k, inv_k = hm32.FORWARD[k], hm32.INVERSE[k]
        p32 = g.NTTParameters(logn32, g.ReductionPolynomial.X_N_plus, np.uint32)
        q32 = p32.modulus.value
        plan32 = g.MergePlan.from_params(p32, device=dev)
        x_np = rng.integers(0, q32, size=(batch32, p32.n), dtype=np.uint64).astype(np.uint32)
        y_np = rng.integers(0, q32, size=(batch32, p32.n), dtype=np.uint64).astype(np.uint32)
        x = torch.from_numpy(x_np.astype(np.int64)).to(dev)
        y = torch.from_numpy(y_np.astype(np.int64)).to(dev)
        cell = f"u32 2^{logn32}x{batch32}"

        reset()
        fx = g.ntt_lanes(x, plan32)
        bx = g.intt_lanes(fx, plan32)
        pxy = g.polymul_lanes(x, y, plan32)
        torch.cuda.synchronize()
        launches.update({fwd_k.name: fwd_k.launches, inv_k.name: inv_k.launches})
        others = [s for s in hm32.KERNELS if s not in (fwd_k, inv_k)]
        check(fwd_k.launches == 3 and inv_k.launches == 2
              and sum(s.launches + s.plain_calls for s in (fwd_k, inv_k, *others)) == 5,
              f"{cell} launched {fwd_k.name} {fwd_k.launches}x and {inv_k.name} "
              f"{inv_k.launches}x, nothing else, no plain version")

        fx_plain = hm32.merge_u32_fwd_plain(x, plan32)
        fy_plain = hm32.merge_u32_fwd_plain(y, plan32)
        pxy_plain = hm32.merge_u32_inv_plain(
            bo.barrett_mul32(fx_plain, fy_plain, q32, plan32.bit, plan32.mu), plan32)
        for name, got, want in ((fwd_k.name, fx, fx_plain),
                                (inv_k.name, bx, hm32.merge_u32_inv_plain(fx, plan32))):
            err[name] = int((got - want).abs().max().item())
            check(torch.equal(got, want),
                  f"{name} == plain version, all {batch32} rows (max |diff| {err[name]})")
        check(torch.equal(pxy, pxy_plain), f"{cell} polymul == plain pipeline, all rows")
        check(torch.equal(bx, x), f"{cell} intt(ntt(x)) == x, all rows")
        gen32 = g.NTTCPU(p32)
        for r in (0, batch32 - 1):
            check(np.array_equal(fx[r].cpu().numpy().astype(np.uint32), gen32.ntt(x_np[r])),
                  f"{cell} ntt row {r} == NTTCPU")
            want = gen32.intt(gen32.mult(gen32.ntt(x_np[r]), gen32.ntt(y_np[r])))
            check(np.array_equal(pxy[r].cpu().numpy().astype(np.uint32), want),
                  f"{cell} polymul row {r} == NTTCPU")
        model32 = g.PolynomialMultiplier(p32, device=dev)
        check(torch.equal(model32(x, y), pxy), f"{cell} PolynomialMultiplier == polymul_lanes")
        u32_cells[k] = (plan32, x, fx, batch32, logn32)

    # -- 7. u32 2^17 x 4 (K5) and 2^25 x 1 (top of the pool)
    for logn32, batch32 in ((17, 4), (25, 1)):
        k = hm32.tpu_kernel(logn32)
        fwd_k, inv_k = hm32.FORWARD[k], hm32.INVERSE[k]
        p32 = g.NTTParameters(logn32, g.ReductionPolynomial.X_N_plus, np.uint32)
        plan32 = g.MergePlan.from_params(p32, device=dev)
        x_np = rng.integers(0, p32.modulus.value, size=(batch32, p32.n),
                            dtype=np.uint64).astype(np.uint32)
        x = torch.from_numpy(x_np.astype(np.int64)).to(dev)
        cell = f"u32 2^{logn32}x{batch32}"
        reset()
        fx = g.ntt_lanes(x, plan32)
        ix = g.intt_lanes(x, plan32)
        torch.cuda.synchronize()
        check(fwd_k.launches == 1 and inv_k.launches == 1
              and sum(s.plain_calls for s in hm32.KERNELS) == 0,
              f"{cell} launched {fwd_k.name} and {inv_k.name}, no plain version")
        if k == "K5":
            launches.update({fwd_k.name: fwd_k.launches, inv_k.name: inv_k.launches})
            u32_cells[k] = (plan32, x, fx, batch32, logn32)
        for name, got, want in ((fwd_k.name, fx, hm32.merge_u32_fwd_plain(x, plan32)),
                                (inv_k.name, ix, hm32.merge_u32_inv_plain(x, plan32))):
            e = int((got - want).abs().max().item())
            err.setdefault(name, e)
            check(torch.equal(got, want), f"{cell} {name} == plain version (max |diff| {e})")
        gen32 = g.NTTCPU(p32)
        check(np.array_equal(fx.cpu().numpy().astype(np.uint32), gen32.ntt(x_np)),
              f"{cell} ntt == NTTCPU, all rows")
        check(np.array_equal(ix.cpu().numpy().astype(np.uint32), gen32.intt(x_np)),
              f"{cell} intt == NTTCPU, all rows")
        check(torch.equal(g.intt_lanes(fx, plan32), x), f"{cell} intt(ntt(x)) == x")
        del fx, ix, x

    # -- 8. u32 small cell against schoolbook, and a 30-bit q
    ps = g.NTTParameters(8, g.ReductionPolynomial.X_N_minus, np.uint32)
    xs = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64).astype(np.uint32)
    ys = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64).astype(np.uint32)
    reset()
    got = g.polymul(xs, ys, g.MergePlan.from_params(ps, device=dev))
    check(hm32.FORWARD["K4"].launches == 2 and hm32.INVERSE["K4"].launches == 1,
          "u32 logn 8 polymul ran the kernels")
    for r in range(4):
        check(np.array_equal(got[r], g.schoolbook_poly_multiplication(
            xs[r], ys[r], ps.modulus, ps.poly_reduction)),
            f"u32 logn 8 X^N-1 polymul row {r} == schoolbook")
    qw = g.find_ntt_primes(30, 14, 1)[0]
    omega, psi = g.ntt_root_pair(qw, 14)
    pw = g.NTTParameters(14, g.ReductionPolynomial.X_N_plus, np.uint32,
                         factors=g.NTTFactors(g.Modulus32(qw), omega, psi))
    planw = g.MergePlan.from_params(pw, device=dev)
    xw = rng.integers(0, qw, size=(4, pw.n), dtype=np.uint64).astype(np.uint32)
    yw = rng.integers(0, qw, size=(4, pw.n), dtype=np.uint64).astype(np.uint32)
    genw = g.NTTCPU(pw)
    reset()
    fw = g.ntt(xw, planw)
    check(np.array_equal(fw, genw.ntt(xw)), f"u32 30-bit q={qw} ntt == NTTCPU")
    check(np.array_equal(g.intt(fw, planw), xw), "u32 30-bit intt(ntt) == x")
    check(np.array_equal(g.polymul(xw, yw, planw),
                         genw.intt(genw.mult(genw.ntt(xw), genw.ntt(yw)))),
          "u32 30-bit polymul == NTTCPU")
    check(hm32.FORWARD["K4"].launches == 3 and hm32.INVERSE["K4"].launches == 2,
          "u32 30-bit q ran the kernels")

    # -- 9. the u64 big-ring path at full width, through the public entries
    PLUS = g.ReductionPolynomial.X_N_plus
    K1, K2, K3 = (k.name for k in hm.KERNELS)
    CF, CI, RM = (k.name for k in hml.KERNELS)
    big = {}
    for logn_b, batch_b in ((24, 1), (20, 16)):
        pb = g.NTTParameters(logn_b, PLUS, np.uint64)
        planb = g.MergePlan.from_params(pb, device=dev)
        cell = f"u64 2^{logn_b}x{batch_b}"
        check(planb.fwd_table is None, f"{cell} plan holds no N-entry table")
        t0 = time.perf_counter()
        lp = hml.large_plan(planb)
        torch.cuda.synchronize()
        print(f"{cell} plan build {time.perf_counter() - t0:.3f} s, "
              f"{lp.device_bytes()} bytes on the card (A={lp.A} B={lp.B} T={lp.tile})")
        xb_np = rng.integers(0, pb.modulus.value, size=(batch_b, pb.n), dtype=np.uint64)
        yb_np = rng.integers(0, pb.modulus.value, size=(batch_b, pb.n), dtype=np.uint64)
        xb, yb = from_numpy_u64(xb_np, dev), from_numpy_u64(yb_np, dev)

        reset()
        fxb = g.ntt_lanes(xb, planb)
        c_ntt = counted()
        check(c_ntt == {K1: 1, CF: 1}, f"{cell} ntt_lanes launched K7 fwd and K1 once")
        reset()
        bxb = g.intt_lanes(fxb, planb)
        c_intt = counted()
        check(c_intt == {K2: 1, CI: 1}, f"{cell} intt_lanes launched K2 and K7 inv once")
        reset()
        pxy = g.polymul_lanes(xb, yb, planb)
        c_mul = counted()
        check(c_mul == {K1: 2, CF: 2, K3: 1, CI: 1},
              f"{cell} polymul_lanes launched K7 fwd and K1 twice, K3 and K7 inv once")
        if logn_b == 24:  # K7's cell: its launches on this main path
            for name in (CF, CI):
                launches[name] = sum(c.get(name, 0) for c in (c_ntt, c_intt, c_mul))

        fx_plain = hml.merge_u64_large_plain(xb, lp)
        check(torch.equal(fxb, fx_plain), f"{cell} ntt == plain composition, all rows")
        check(torch.equal(bxb, hml.merge_u64_large_plain(fxb, lp, inverse=True)),
              f"{cell} intt == plain composition")
        check(torch.equal(bxb, xb), f"{cell} intt(ntt(x)) == x, all rows")
        check(torch.equal(pxy, hml.merge_u64_large_polymul_inv_plain(
            fx_plain, hml.merge_u64_large_plain(yb, lp), lp)),
            f"{cell} polymul == plain composition, all rows")
        for stats, fn, plain, src in (
                (hml.COLFWD, hml.merge_u64_large_colfwd, hml.colfwd_plain, xb),
                (hml.COLINV, hml.merge_u64_large_colinv, hml.colinv_plain, fxb)):
            got, want = fn(src, lp), plain(src, lp)
            e = int((got - want).abs().max().item())
            err.setdefault(stats.name, e)
            check(torch.equal(got, want), f"{cell} {stats.name} == plain version (max |diff| {e})")
        genb = g.NTTCPU(pb)
        for r in sorted({0, batch_b - 1}):
            check(np.array_equal(to_numpy_u64(fxb[r]), genb.ntt(xb_np[r])),
                  f"{cell} ntt row {r} == native oracle")
            check(np.array_equal(to_numpy_u64(bxb[r]), xb_np[r]), f"{cell} intt row {r}")
            want = genb.intt(genb.mult(genb.ntt(xb_np[r]), genb.ntt(yb_np[r])))
            check(np.array_equal(to_numpy_u64(pxy[r]), want),
                  f"{cell} polymul row {r} == native oracle")
        big[logn_b] = (planb, lp, xb, yb, fxb, batch_b)
        del bxb, pxy, fx_plain

    # -- 10. 2^27 (K8 on the nested rows) and 2^28 (the top of the pool)
    for logn_b in (27, 28):
        pb = g.NTTParameters(logn_b, PLUS, np.uint64)
        planb = g.MergePlan.from_params(pb, device=dev)
        cell = f"u64 2^{logn_b}x1"
        t0 = time.perf_counter()
        lp = hml.large_plan(planb)
        torch.cuda.synchronize()
        print(f"{cell} plan build {time.perf_counter() - t0:.3f} s, "
              f"{lp.device_bytes()} bytes on the card (A={lp.A} B={lp.B}, nested "
              f"A={lp.nested.A} B={lp.nested.B}, rows {lp.nested.row_kernel})")
        xb_np = rng.integers(0, pb.modulus.value, size=(1, pb.n), dtype=np.uint64)
        xb = from_numpy_u64(xb_np, dev)
        rows = RM if logn_b == 27 else K1
        reset()
        fxb = g.ntt_lanes(xb, planb)
        c_ntt = counted()
        check(c_ntt == {CF: 2, rows: 1}, f"{cell} ntt_lanes launched K7 fwd twice, "
              f"{rows} once")
        reset()
        bxb = g.intt_lanes(fxb, planb)
        c_intt = counted()
        check(c_intt == {CI: 2, RM if logn_b == 27 else K2: 1},
              f"{cell} intt_lanes launched K7 inv twice, the row inverse once")
        if logn_b == 27:  # K8's cell: its launches on this main path
            launches[RM] = c_ntt[RM] + c_intt[RM]
        check(torch.equal(bxb, xb), f"{cell} intt(ntt(x)) == x")
        del bxb
        check(torch.equal(fxb, hml.merge_u64_large_plain(xb, lp)),
              f"{cell} ntt == plain composition")
        check(torch.equal(g.intt_lanes(fxb, planb),
                          hml.merge_u64_large_plain(fxb, lp, inverse=True)),
              f"{cell} intt == plain composition")
        if logn_b == 27:
            r = xb.view(-1, lp.nested.B)
            for inverse in (False, True):
                got = hml.merge_u64_large_rowmat(r, lp.nested.rows, inverse)
                want = hml.rowmat_plain(r, lp.nested.rows, inverse)
                e = int((got - want).abs().max().item())
                err[RM] = max(err.get(RM, 0), e)
                check(torch.equal(got, want), f"{cell} {RM} inverse={inverse} == plain "
                      f"version on {r.shape[0]} rows (max |diff| {e})")
            big[27] = (planb, lp, xb, None, fxb, 1)
        else:
            t0 = time.perf_counter()
            check(np.array_equal(to_numpy_u64(fxb[0]), g.NTTCPU(pb).ntt(xb_np[0])),
                  f"{cell} ntt == native oracle ({time.perf_counter() - t0:.1f} s on the host)")
            big[28] = (planb, lp, xb, None, fxb, 1)
        del xb_np

    # -- 11. u64 logn 18 X^N - 1, and wide and narrow q at logn 20
    ps = g.NTTParameters(18, g.ReductionPolynomial.X_N_minus, np.uint64)
    xs = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64)
    ys = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64)
    reset()
    got = g.polymul(xs, ys, g.MergePlan.from_params(ps, device=dev))
    check(counted() == {K1: 2, CF: 2, K3: 1, CI: 1}, "u64 logn 18 polymul ran the kernels")
    gens = g.NTTCPU(ps)
    for r in (0, 3):
        check(np.array_equal(got[r], gens.intt(gens.mult(gens.ntt(xs[r]), gens.ntt(ys[r])))),
              f"u64 logn 18 X^N-1 polymul row {r} == NTTCPU")
    for bits, poly in ((62, PLUS), (46, g.ReductionPolynomial.X_N_minus)):
        qw = g.find_ntt_primes(bits, 20, 1)[0]
        omega, psi = g.ntt_root_pair(qw, 20)
        pw = g.NTTParameters(20, poly, np.uint64,
                             factors=g.NTTFactors(g.Modulus64(qw), omega, psi))
        planw = g.MergePlan.from_params(pw, device=dev)
        xw = rng.integers(0, qw, size=(2, pw.n), dtype=np.uint64)
        yw = rng.integers(0, qw, size=(2, pw.n), dtype=np.uint64)
        genw = g.NTTCPU(pw)
        reset()
        fw = g.ntt(xw, planw)
        check(np.array_equal(fw, genw.ntt(xw)), f"logn 20 {bits}-bit q={qw} ntt == NTTCPU")
        check(np.array_equal(g.intt(fw, planw), xw), f"logn 20 {bits}-bit intt(ntt) == x")
        check(np.array_equal(g.polymul(xw, yw, planw),
                             genw.intt(genw.mult(genw.ntt(xw), genw.ntt(yw)))),
              f"logn 20 {bits}-bit polymul == NTTCPU")
        check(set(counted()) == {K1, K2, K3, CF, CI}, f"logn 20 {bits}-bit q ran the kernels")

    # -- 12. the 4-step path: u64 and u32, 2^24 x 1 and 2^16 x 128, X^N - 1
    MINUS = g.ReductionPolynomial.X_N_minus
    T = g.transpose_lanes

    def counted4() -> dict:
        """{kernel: launches} of every kernel since reset(); raises if a
        plain version ran."""
        torch.cuda.synchronize()
        ks = (*hf.KERNELS, *hm.KERNELS, *hm32.KERNELS, *hml.KERNELS)
        if any(k.plain_calls for k in ks):
            raise AssertionError(f"plain versions ran: {[(k.name, k.plain_calls) for k in ks]}")
        return {k.name: k.launches for k in ks if k.launches}

    four = {}
    for dtype, logn_f, batch_f in ((np.uint64, 24, 1), (np.uint64, 16, 128),
                                   (np.uint32, 24, 1), (np.uint32, 16, 128)):
        is64 = dtype == np.uint64
        pf = g.NTTParameters4Step(logn_f, MINUS, dtype)
        cell = f"4-step u{64 if is64 else 32} 2^{logn_f}x{batch_f}"
        t0 = time.perf_counter()
        planf = g.FourStepPlan.from_params(pf, device=dev)
        kp = hf.kernel_plan(planf)
        torch.cuda.synchronize()
        print(f"{cell} plan build {time.perf_counter() - t0:.3f} s, {kp.device_bytes()} bytes "
              f"of kernel tables on the card (n1={kp.n1} n2={kp.n2} T={kp.tile} "
              f"Tw={kp.w_tile}, rows on {kp.row_kernel})")
        n1, n2 = kp.n1, kp.n2
        xf_np = rng.integers(0, pf.modulus.value, size=(batch_f, pf.n), dtype=np.uint64)
        xf = from_numpy_u64(xf_np, dev)
        col_k, row_k = (hf.COL64, hf.ROW64) if is64 else (hf.COL32, hf.ROW32)
        if n2 <= hf.ROW_MAT_MAX:
            rows_fwd = rows_inv = row_k
        elif is64:
            rows_fwd, rows_inv = hm.FORWARD, hm.INVERSE
        else:
            k = hm32.tpu_kernel(n2.bit_length() - 1)
            rows_fwd, rows_inv = hm32.FORWARD[k], hm32.INVERSE[k]
        outs, runs = {}, {}
        for entry, fn, rows in (("ntt_lanes", g.fourstep_ntt_lanes, rows_fwd),
                                ("intt_lanes", g.fourstep_intt_lanes, rows_inv),
                                ("ntt_full", g.fourstep_ntt_full, rows_fwd),
                                ("intt_full", g.fourstep_intt_full, rows_inv)):
            reset()
            outs[entry] = fn(xf, planf)
            runs[entry] = counted4()
            check(runs[entry] == {col_k.name: 1, rows.name: 1},
                  f"{cell} {entry} launched {col_k.name} and {rows.name} once, no plain "
                  f"version ({runs[entry]})")
        for k in (col_k, row_k):
            if (k is col_k) == (logn_f == 24):  # each kernel's launches in its timed cell
                launches[k.name] = sum(r.get(k.name, 0) for r in runs.values())
        check("w" not in planf._lazy, f"{cell} built no (n1, n2) W table")

        pairs = {"ntt_lanes": hf.fourstep_plain(xf, kp),
                 "intt_lanes": hf.fourstep_plain(xf, kp, True),
                 "ntt_full": T(hf.fourstep_plain(T(xf, n1, n2), kp), n1, n2),
                 "intt_full": T(hf.fourstep_plain(T(xf, n2, n1), kp, True), n1, n2)}
        for entry, want in pairs.items():
            check(torch.equal(outs[entry], want),
                  f"{cell} {entry} == plain composition, all {batch_f} rows")
        del pairs
        check(torch.equal(g.fourstep_intt_full(outs["ntt_full"], planf), xf),
              f"{cell} intt_full(ntt_full(x)) == x, all rows")
        genf = g.NTT4StepCPU(pf)
        for r in sorted({0, batch_f - 1}):
            t0 = time.perf_counter()
            xr = xf_np[r].astype(dtype)
            check(np.array_equal(from_lanes(outs["ntt_full"][r], is64), genf.ntt(xr))
                  and np.array_equal(from_lanes(outs["intt_full"][r], is64), genf.intt(xr)),
                  f"{cell} ntt_full, intt_full row {r} == NTT4StepCPU "
                  f"({time.perf_counter() - t0:.1f} s on the host)")
        col_fn = hf.fourstep_u64_col if is64 else hf.fourstep_u32_col
        row_fn = hf.fourstep_u64_row if is64 else hf.fourstep_u32_row
        row_plain = hml.rowmat_plain if is64 else hf.row32_plain
        for inverse in (False, True):
            got, want = col_fn(xf, kp, inverse), hf.col_plain(xf, kp, inverse)
            e = int((got - want).abs().max().item())
            err[col_k.name] = max(err.get(col_k.name, 0), e)
            check(torch.equal(got, want),
                  f"{cell} {col_k.name} inverse={inverse} == plain version (max |diff| {e})")
            if n2 <= hf.ROW_MAT_MAX:
                r = got.view(-1, n2)
                got, want = row_fn(r, kp.rows, inverse), row_plain(r, kp.rows, inverse)
                e = int((got - want).abs().max().item())
                err[row_k.name] = max(err.get(row_k.name, 0), e)
                check(torch.equal(got, want), f"{cell} {row_k.name} inverse={inverse} == "
                      f"plain version on {r.shape[0]} rows (max |diff| {e})")
        four[(is64, logn_f)] = (planf, kp, xf, batch_f)
        del outs

    pf = g.NTTParameters4Step(16, PLUS, np.uint64)
    planf = g.FourStepPlan.from_params(pf, device=dev)
    xf_np = rng.integers(0, pf.modulus.value, size=(4, pf.n), dtype=np.uint64)
    xf = from_numpy_u64(xf_np, dev)
    reset()
    ff = g.fourstep_ntt_full(xf, planf)
    bf = g.fourstep_intt_full(ff, planf)
    check(counted4() == {hf.COL64.name: 2, hf.ROW64.name: 2},
          "4-step u64 2^16x4 X^N+1 launched K9 and K10 twice each")
    genf = g.NTT4StepCPU(pf)
    check(np.array_equal(to_numpy_u64(ff), np.stack([genf.ntt(v) for v in xf_np])),
          "4-step u64 2^16x4 X^N+1 ntt_full == NTT4StepCPU, all rows")
    check(torch.equal(bf, xf), "4-step u64 2^16x4 X^N+1 intt_full(ntt_full(x)) == x")

    # -- 13. times: plain, kernel, kernel, plain
    cases = {
        hm.FORWARD.name: (lambda: hm.merge_u64_fwd(a, plan),
                          lambda: hm.merge_u64_fwd_plain(a, plan),
                          bound_ms(BATCH, LOGN, 1, 16), f"u64 2^{LOGN}x{BATCH}"),
        hm.INVERSE.name: (lambda: hm.merge_u64_inv(fa, plan),
                          lambda: hm.merge_u64_inv_plain(fa, plan),
                          bound_ms(BATCH, LOGN, 1, 16), f"u64 2^{LOGN}x{BATCH}"),
        hm.POLYMUL_INVERSE.name: (
            lambda: hm.merge_u64_polymul_inv(fa, fa_plain, plan),
            lambda: hm.merge_u64_polymul_inv_plain(fa, fa_plain, plan),
            bound_ms(BATCH, LOGN, 2, 16), f"u64 2^{LOGN}x{BATCH}"),
    }
    for k, (plan32, x, fx, batch32, logn32) in sorted(u32_cells.items()):
        cell = f"u32 2^{logn32}x{batch32}"
        cases[hm32.FORWARD[k].name] = (
            lambda x=x, pl=plan32: hm32.merge_u32_fwd(x, pl),
            lambda x=x, pl=plan32: hm32.merge_u32_fwd_plain(x, pl),
            bound_ms(batch32, logn32, 1, 3), cell)
        cases[hm32.INVERSE[k].name] = (
            lambda fx=fx, pl=plan32: hm32.merge_u32_inv(fx, pl),
            lambda fx=fx, pl=plan32: hm32.merge_u32_inv_plain(fx, pl),
            bound_ms(batch32, logn32, 1, 3), cell)
    _, lp24, x24, _, fx24, _ = big[24]
    _, lp27, x27, _, _, _ = big[27]
    r27 = x27.view(-1, lp27.nested.B)

    def k7_bound(lp, batch, inverse):
        # log A stages of N/2 Shoup products, two for the twist (a third
        # for the inverse's A^-1) per word
        n = batch << lp.logn
        return bound_of(2 * 8 * n, 16 * (n // 2 * (lp.A.bit_length() - 1)
                                         + (3 if inverse else 2) * n))

    cases[CF] = (lambda: hml.merge_u64_large_colfwd(x24, lp24),
                 lambda: hml.colfwd_plain(x24, lp24), k7_bound(lp24, 1, False), "u64 2^24x1")
    cases[CI] = (lambda: hml.merge_u64_large_colinv(fx24, lp24),
                 lambda: hml.colinv_plain(fx24, lp24), k7_bound(lp24, 1, True), "u64 2^24x1")
    cases[RM] = (lambda: hml.merge_u64_large_rowmat(r27, lp27.nested.rows, False),
                 lambda: hml.rowmat_plain(r27, lp27.nested.rows, False),
                 bound_of(2 * 8 * r27.numel(), 16 * (r27.numel() // 2) * 9),
                 f"u64 rows {r27.shape[0]}x{r27.shape[1]} (2^27)")

    def col_bound(kp, batch, mul):
        # log n1 / 2 butterflies and two twist products per word, each a
        # Shoup product of `mul` 32-bit multiplies
        n, log1 = batch << kp.logn, kp.n1.bit_length() - 1
        return bound_of(2 * 8 * n, mul * (n // 2 * log1 + 2 * n))

    for is64, mul in ((True, 16), (False, 3)):
        _, kp, xf, batch_f = four[(is64, 24)]
        col_fn = hf.fourstep_u64_col if is64 else hf.fourstep_u32_col
        cases[(hf.COL64 if is64 else hf.COL32).name] = (
            lambda f=col_fn, x=xf, kp=kp: f(x, kp, False),
            lambda x=xf, kp=kp: hf.col_plain(x, kp, False), col_bound(kp, batch_f, mul),
            f"4-step u{64 if is64 else 32} 2^24x1")
        _, kp, xf, batch_f = four[(is64, 16)]
        r = hf.col_plain(xf, kp, False).view(-1, kp.n2)
        row_fn = hf.fourstep_u64_row if is64 else hf.fourstep_u32_row
        row_plain = hml.rowmat_plain if is64 else hf.row32_plain
        cases[(hf.ROW64 if is64 else hf.ROW32).name] = (
            lambda f=row_fn, r=r, kp=kp: f(r, kp.rows, False),
            lambda f=row_plain, r=r, kp=kp: f(r, kp.rows, False),
            bound_of(2 * 8 * r.numel(), mul * (r.numel() // 2) * (kp.n2.bit_length() - 1)),
            f"4-step u{64 if is64 else 32} 2^16x128 rows {r.shape[0]}x{r.shape[1]}")
    for name, (kernel, plain, bound, cell) in cases.items():
        runs = [time_cuda(plain, repeats=5, inner=2), time_cuda(kernel),
                time_cuda(kernel), time_cuda(plain, repeats=5, inner=2)]
        k_ms = (runs[1][0] + runs[2][0]) / 2
        p_ms = (runs[0][0] + runs[3][0]) / 2
        times[name], bounds[name] = (k_ms, p_ms), bound
        print(f"time {name} {cell}: kernel {k_ms:.5f} ms "
              f"(spread {max(runs[1][1], runs[2][1]):.3f}), plain {p_ms:.3f} ms "
              f"(spread {max(runs[0][1], runs[3][1]):.3f}), bound {bound[0]:.5f} ms "
              f"({bound[1]}), {bound[0] / k_ms:.1%} of it")
    e2e, spread = time_cuda(lambda: g.polymul_lanes(a, b, plan))
    print(f"time polymul_lanes u64 2^{LOGN}x{BATCH} end to end: {e2e:.4f} ms "
          f"(spread {spread:.3f})")
    plan32, x, _, batch32, logn32 = u32_cells["K4"]
    e2e, spread = time_cuda(lambda: g.polymul_lanes(x, x, plan32))
    print(f"time polymul_lanes u32 2^{logn32}x{batch32} end to end: {e2e:.4f} ms "
          f"(spread {spread:.3f})")
    for logn_b in (24, 20, 27, 28):
        planb, lp, xb, yb, fxb, batch_b = big[logn_b]
        cell = f"u64 2^{logn_b}x{batch_b}"
        heavy = logn_b >= 27  # a plain call takes a second or more
        for entry, kernel, plain, src in (
                ("ntt_lanes", g.ntt_lanes, hml.merge_u64_large_plain, xb),
                ("intt_lanes", g.intt_lanes,
                 lambda v, lp: hml.merge_u64_large_plain(v, lp, inverse=True), fxb)):
            runs = [time_cuda(lambda: plain(src, lp), warmup=1, repeats=3 if heavy else 5,
                              inner=1 if heavy else 2),
                    time_cuda(lambda: kernel(src, planb), repeats=5 if heavy else 10),
                    time_cuda(lambda: kernel(src, planb), repeats=5 if heavy else 10),
                    time_cuda(lambda: plain(src, lp), warmup=1, repeats=3 if heavy else 5,
                              inner=1 if heavy else 2)]
            k_ms = (runs[1][0] + runs[2][0]) / 2
            p_ms = (runs[0][0] + runs[3][0]) / 2
            bound = bound_ms(batch_b, logn_b, 1, 16)
            print(f"time {entry} {cell}: {k_ms:.5f} ms (spread "
                  f"{max(runs[1][1], runs[2][1]):.3f}), plain {p_ms:.3f} ms (spread "
                  f"{max(runs[0][1], runs[3][1]):.3f}), bound {bound[0]:.5f} ms "
                  f"({bound[1]}), {bound[0] / k_ms:.1%} of it")
        if yb is not None:
            e2e, spread = time_cuda(lambda: g.polymul_lanes(xb, yb, planb))
            print(f"time polymul_lanes {cell} end to end: {e2e:.4f} ms (spread {spread:.3f})")
    for (is64, logn_f), (planf, kp, xf, batch_f) in four.items():
        cell = f"4-step u{64 if is64 else 32} 2^{logn_f}x{batch_f}"
        bound = bound_ms(batch_f, logn_f, 1, 16 if is64 else 3)
        for entry, fn, plain in (
                ("ntt_lanes", g.fourstep_ntt_lanes, lambda: hf.fourstep_plain(xf, kp)),
                ("intt_lanes", g.fourstep_intt_lanes,
                 lambda: hf.fourstep_plain(xf, kp, True)),
                ("ntt_full", g.fourstep_ntt_full, None),
                ("intt_full", g.fourstep_intt_full, None)):
            p_runs = [time_cuda(plain, repeats=5, inner=2)] if plain else []
            k_runs = [time_cuda(lambda: fn(xf, planf)) for _ in range(2)]
            if plain:
                p_runs.append(time_cuda(plain, repeats=5, inner=2))
            k_ms = (k_runs[0][0] + k_runs[1][0]) / 2
            line = (f"time {entry} {cell}: {k_ms:.5f} ms "
                    f"(spread {max(r[1] for r in k_runs):.3f})")
            if p_runs:
                line += (f", plain {(p_runs[0][0] + p_runs[1][0]) / 2:.3f} ms "
                         f"(spread {max(r[1] for r in p_runs):.3f})")
            print(f"{line}, bound {bound[0]:.5f} ms ({bound[1]}), "
                  f"{bound[0] / k_ms:.1%} of it")
    rns_phase(dev, rng, reset, launches, err, times, bounds)
    rns32_phase(dev, rng, reset, launches, err, times, bounds)
    kmerge_phase(dev, rng, reset, launches, err, times, bounds)
    dist_phase(dev, rng, reset, launches, err, times, bounds)
    examples_phase(dev)
    entry_phase(dev)
    probe_phase(dev)
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")

    def row(k, name):
        return {"name": name, "route": k.route, "source": k.source,
                "replaces": k.replaces, "launches": launches[name],
                "max_abs_err": err[name], "ms": times[name][0],
                "plain_ms": times[name][1], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": None}

    # the u32 RNS kernels twice: their int64-lane and int32-lane (_i32) instances
    print(json.dumps({"kernels": [
        *(row(k, k.name)
          for k in (*hm.KERNELS, *hm32.KERNELS, *hml.KERNELS, *hml.LOCAL_KERNELS, *hf.KERNELS,
                    *hr.KERNELS, *hr32.KERNELS, *hk64.KERNELS, *hk.KERNELS)),
        *(row(k, f"{k.name}_i32") for k in hr32.KERNELS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
