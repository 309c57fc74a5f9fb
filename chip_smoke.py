#!/usr/bin/env python3
"""Drive the port's u64 merge NTT main path once on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Builds the kernels of gpuntt_tpu_torch/csrc/ and runs, on the card:

1. the card's name and power limit, torch and CUDA versions, build time;
2. the main path at its full width — the forward merge NTT, its inverse
   and the fused polymul of a (128, 2^16) u64 batch, X^N + 1, the
   61-bit pool prime — through ntt_lanes / intt_lanes / polymul_lanes,
   with every kernel's launch count read around that run; then each
   kernel against its plain PyTorch version on the same card, all 128
   rows, and two rows against the golden NTTCPU on the host;
3. logn 12, X^N - 1, batch 4 against schoolbook multiplication;
4. a 62-bit and a 46-bit modulus at logn 14 against NTTCPU;
5. PolynomialMultiplier (the nn.Module) on the main-path shape;
6. CUDA-event times of each kernel and of its plain version.

Every comparison is exact equality (integer arithmetic).  Any failure
raises, and the script exits non-zero without a result line; so it does
when no CUDA device is visible.  The line before the last is the JSON
kernel table; the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 128
LOGN = 16


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"ok   {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1

    import gpuntt_tpu_torch as g
    from gpuntt_tpu_torch.ops import _build
    from gpuntt_tpu_torch.ops import hopper_merge as hm
    from gpuntt_tpu_torch.ops.limb import from_numpy_u64, to_numpy_u64
    from gpuntt_tpu_torch.utils.timing import time_cuda

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)

    # -- 1. card and build
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build+load {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_info.get('seconds', 0.0):.2f} s)")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas", line.strip())

    # -- 2. the main path at full width
    p = g.NTTParameters(LOGN, g.ReductionPolynomial.X_N_plus, np.uint64)
    q = p.modulus.value
    plan = g.MergePlan.from_params(p, device=dev)
    a_np = rng.integers(0, q, size=(BATCH, p.n), dtype=np.uint64)
    b_np = rng.integers(0, q, size=(BATCH, p.n), dtype=np.uint64)
    a, b = from_numpy_u64(a_np, dev), from_numpy_u64(b_np, dev)

    hm.reset_counts()
    fa = g.ntt_lanes(a, plan)
    back = g.intt_lanes(fa, plan)
    prod = g.polymul_lanes(a, b, plan)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in hm.KERNELS}
    for k in hm.KERNELS:
        check(k.launches > 0 and k.plain_calls == 0,
              f"main path launched {k.name} {k.launches}x, plain version "
              f"{k.plain_calls}x")

    fa_plain = hm.merge_u64_fwd_plain(a, plan)
    fb_plain = hm.merge_u64_fwd_plain(b, plan)
    pairs = {
        hm.FORWARD.name: (fa, fa_plain),
        hm.INVERSE.name: (back, hm.merge_u64_inv_plain(fa, plan)),
        hm.POLYMUL_INVERSE.name: (
            prod, hm.merge_u64_polymul_inv_plain(fa_plain, fb_plain, plan)),
    }
    err = {}
    for name, (got, want) in pairs.items():
        err[name] = int((got - want).abs().max().item())
        check(torch.equal(got, want),
              f"{name} == plain version, all {BATCH} rows (max |diff| {err[name]})")
    check(torch.equal(back, a), "intt(ntt(a)) == a, all rows")

    gen = g.NTTCPU(p)
    for r in (0, BATCH - 1):
        check(np.array_equal(to_numpy_u64(fa[r]), gen.ntt(a_np[r])),
              f"ntt row {r} == NTTCPU")
        want = gen.intt(gen.mult(gen.ntt(a_np[r]), gen.ntt(b_np[r])))
        check(np.array_equal(to_numpy_u64(prod[r]), want), f"polymul row {r} == NTTCPU")

    # -- 3. small cell against schoolbook
    ps = g.NTTParameters(12, g.ReductionPolynomial.X_N_minus, np.uint64)
    xs = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64)
    ys = rng.integers(0, ps.modulus.value, size=(4, ps.n), dtype=np.uint64)
    hm.reset_counts()
    got = g.polymul(xs, ys, g.MergePlan.from_params(ps, device=dev))
    check(hm.POLYMUL_INVERSE.launches == 1, "logn 12 polymul ran the kernels")
    for r in range(4):
        check(np.array_equal(got[r], g.schoolbook_poly_multiplication(
            xs[r], ys[r], ps.modulus, ps.poly_reduction)),
            f"logn 12 X^N-1 polymul row {r} == schoolbook")

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
        hm.reset_counts()
        fw = g.ntt(xw, planw)
        check(np.array_equal(fw, genw.ntt(xw)), f"{bits}-bit q={qw} ntt == NTTCPU")
        check(np.array_equal(g.intt(fw, planw), xw), f"{bits}-bit intt(ntt) == x")
        check(np.array_equal(g.polymul(xw, yw, planw),
                             genw.intt(genw.mult(genw.ntt(xw), genw.ntt(yw)))),
              f"{bits}-bit polymul == NTTCPU")
        check(all(k.launches > 0 for k in hm.KERNELS), f"{bits}-bit q ran the kernels")

    # -- 5. the nn.Module
    model = g.PolynomialMultiplier(p, device=dev)
    check(torch.equal(model(a, b), prod), "PolynomialMultiplier == polymul_lanes")

    # -- 6. times: plain, kernel, kernel, plain
    cases = {
        hm.FORWARD.name: (lambda: hm.merge_u64_fwd(a, plan),
                          lambda: hm.merge_u64_fwd_plain(a, plan)),
        hm.INVERSE.name: (lambda: hm.merge_u64_inv(fa, plan),
                          lambda: hm.merge_u64_inv_plain(fa, plan)),
        hm.POLYMUL_INVERSE.name: (
            lambda: hm.merge_u64_polymul_inv(fa, fa_plain, plan),
            lambda: hm.merge_u64_polymul_inv_plain(fa, fa_plain, plan)),
    }
    times = {}
    for name, (kernel, plain) in cases.items():
        runs = [time_cuda(plain, repeats=5, inner=2), time_cuda(kernel),
                time_cuda(kernel), time_cuda(plain, repeats=5, inner=2)]
        k_ms = (runs[1][0] + runs[2][0]) / 2
        p_ms = (runs[0][0] + runs[3][0]) / 2
        times[name] = (k_ms, p_ms)
        print(f"time {name} 2^{LOGN}x{BATCH}: kernel {k_ms:.4f} ms "
              f"(spread {max(runs[1][1], runs[2][1]):.3f}, "
              f"{BATCH / k_ms * 1e3:.0f} NTTs/s), plain {p_ms:.3f} ms "
              f"(spread {max(runs[0][1], runs[3][1]):.3f})")
    e2e, spread = time_cuda(lambda: g.polymul_lanes(a, b, plan))
    print(f"time polymul_lanes 2^{LOGN}x{BATCH} end to end: {e2e:.4f} ms "
          f"(spread {spread:.3f})")

    print(json.dumps({"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": err[k.name], "ms": times[k.name][0],
         "plain_ms": times[k.name][1]} for k in hm.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
