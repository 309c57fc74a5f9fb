"""The 2^27 ZK transform cell, zk_n27_ntt_stream: its hand counts, its
prime, the merge-order reference against a plain sum, a traced run of
its entry on the big-ring route at a size the CPU holds, and the
per-kernel bandwidth readers."""

from __future__ import annotations

import time

import pytest
import torch

from portbench import harness
from portbench.reference import modpoly, primes

NAME = "zk_n27_ntt_stream"
SEED = 2**31 + 27


def _files():
    w = harness.cell(harness.benchmark(), NAME)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    return cfg, tr, harness.module("entries", tr["entry"])


def test_counts_per_call_are_the_hand_counts():
    """One 2^27 polynomial read and written (8-byte lanes); K7's two
    launches and K8's one each read and write it once."""
    cfg, tr, entry = _files()
    n = 1 << 27
    assert entry.counts(cfg, tr) == {"coefs": n, "bytes": 2 * 8 * n,
                                     "kernel_bytes": {"k7": 4 * 8 * n, "k8": 2 * 8 * n}}


def test_config_prime_is_found_by_the_search_and_taken_by_the_kernels():
    cfg, tr, _ = _files()
    q = cfg["q"]
    assert cfg["logn"] == 27 and cfg["reduction"] == "X^N-1" and tr["polys_per_call"] == 1
    assert q == primes.ntt_primes(59, 27, 1)[0] == 288230385815388161
    assert (q - 1) % (1 << 28) == 0 and q.bit_length() == cfg["prime_bits"] == 59
    assert q < 1 << 62  # the big-ring kernels' bound (4q < 2^64)


def test_pool_is_eight_polynomials_of_one_gib():
    cfg, tr, entry = _files()
    assert tr["pool_calls"] * 8 * entry.counts(cfg, tr)["coefs"] == 8 << 30


def test_merge_order_reference_is_the_plain_sum():
    """Position k of the forward holds sum_j x_j omega^(j br(k)) mod q; the
    inverse reads that order back, N^-1 included."""
    _, _, entry = _files()
    logn, q = 6, primes.ntt_primes(59, 6, 1)[0]
    omega, n = primes.root_pair(q, logn)[0], 1 << logn
    x = torch.randint(0, q, (2, n), generator=torch.Generator().manual_seed(3))
    qt, root = torch.full((2, 1), q), torch.full((2, 1), omega)
    got = entry.merge_forward(x, qt, root)
    br = modpoly.bitrev(logn).tolist()
    for r in range(2):
        xs = x[r].tolist()
        want = [sum(v * pow(omega, j * br[k], q) for j, v in enumerate(xs)) % q
                for k in range(n)]
        assert got[r].tolist() == want
    assert torch.equal(entry.merge_inverse(got, qt, root), x)
    with pytest.raises(ValueError):
        entry.merge_forward(x, torch.full((2, 1), 1 << 61), root)


def test_traced_run_on_the_big_ring_route():
    """The cell at 2^18 (128 x 2^11: the big-ring route, two passes) on the
    CPU: correct, and every traced transform's route span reads two
    passes; no device operation, so the kernel shares read nothing."""
    from gpuntt_tpu_torch.common import tracing

    spec = harness.cell_spec(NAME)
    cfg, tr = spec["config"], spec["traffic"]
    cfg.update(logn=18, q=primes.ntt_primes(59, 18, 1)[0])
    tr.update(pool_calls=2, warmup_calls=1, sample_calls=2, trace_calls=2)
    tracing.reset()
    try:
        rec = harness.execute(NAME, SEED, 0.05, True, "cpu", time.perf_counter(), spec=spec)
        assert rec["correct"], rec["check"]
        spans = tracing.snapshot()["spans"]
        assert [s["attrs"]["passes"] for s in spans if s["name"] == "ntt.route"] == [2, 2]
    finally:
        tracing.reset()
    assert rec["trace"]["calls"] == 2
    for name in ("k7_bw_share", "k8_bw_share"):
        assert harness.module("metrics", name).read(rec) is None


def test_kernel_shares_on_a_hand_built_record():
    """calls x kernel_bytes / 3.35 TB/s over the kernel's summed device
    time, each share over its own kernels' names only."""
    rec = {"kernel_bytes": {"k7": 4 * 8 << 27, "k8": 2 * 8 << 27},
           "trace": {"calls": 10, "device_ops": [
               ["merge_u64_large::col_mat<true, merge_u64::OneModulus, 9>", 0.020],
               ["merge_u64_large::col_mat<false, merge_u64::OneModulus, 9>", 0.018],
               ["merge_u64_large::row_mat<true>", 0.012],
               ["merge_u64_large::row_mat<false>", 0.012],
               ["torch: elementwise_kernel", 1.0]]}}
    k7 = harness.module("metrics", "k7_bw_share").read(rec)
    k8 = harness.module("metrics", "k8_bw_share").read(rec)
    assert k7 == pytest.approx(100 * 10 * (4 * 8 << 27) / 3.35e12 / 0.038)
    assert k8 == pytest.approx(100 * 10 * (2 * 8 << 27) / 3.35e12 / 0.024)
    assert harness.module("metrics", "k7_bw_share").read({"trace": rec["trace"]}) is None
    rec["trace"]["device_ops"] = rec["trace"]["device_ops"][-1:]
    assert harness.module("metrics", "k8_bw_share").read(rec) is None
