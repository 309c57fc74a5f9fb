"""The u32 HE cell, he_n15_u32_polymul_stream: its hand counts, its
ladder, its entry's int32 words and the control's narrow product."""

from __future__ import annotations

import math

import torch

from portbench import harness, operands
from portbench.reference import modpoly, primes
from portbench.tests import tiny

NAME = "he_n15_u32_polymul_stream"


def _files():
    w = harness.cell(harness.benchmark(), NAME)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    return cfg, tr, harness.module("entries", tr["entry"])


def test_counts_per_call_are_the_hand_counts():
    """8 ciphertext pairs x 2 polynomials x 30 primes = 480 rows of 2^15;
    a and b read and the product written, 4-byte words."""
    cfg, tr, entry = _files()
    assert entry.counts(cfg, tr) == {"coefs": 480 * 32768, "bytes": 3 * 4 * 480 * 32768}


def test_pool_is_four_times_the_l2_or_more():
    """4 batches of a and b, 480 rows of 2^15 int32 words each: 503 MB."""
    cfg, tr, entry = _files()
    inputs = 2 * 4 * entry.counts(cfg, tr)["coefs"]
    assert tr["pool_calls"] * inputs >= 4 * 50e6


def test_config_is_the_largest_30_bit_ladder_under_the_standard():
    cfg = harness.config("he_std128_n15_u32")
    qs = cfg["primes"]
    assert cfg["word_bits"] == 32 and cfg["prime_bits"] == 30 and len(qs) == 30
    assert qs == primes.ntt_primes(30, cfg["logn"], len(qs))
    assert all((q - 1) % (2 << cfg["logn"]) == 0 and q.bit_length() == 30 for q in qs)
    assert max(qs) < 1 << 30  # the port's u32 kernels: 4q < 2^32
    log2_q = math.log2(math.prod(qs))
    assert round(log2_q, 2) == cfg["log2_q"] and log2_q <= cfg["log2_q_limit"] == 881
    one_more = primes.ntt_primes(30, cfg["logn"], len(qs) + 1)
    assert math.log2(math.prod(one_more)) > 881


def test_pool_and_reference_are_int32_words():
    spec = tiny.spec(NAME)
    cfg, tr, entry = spec["config"], spec["traffic"], spec["entry"]
    pool = entry.operands_pool(cfg, tr, 2**31 + 3, "cpu")
    a, b = pool[0]
    assert a.dtype == b.dtype == torch.int32 and a.is_contiguous()
    assert int(a.min()) >= 0 and int(a.max()) < max(cfg["primes"])
    want = entry.reference(cfg, tr, pool, 0, modpoly.mulmod)
    assert want.dtype == torch.int32 and want.shape == a.shape


def test_pool_batches_are_drawn_one_at_a_time():
    """Batch i is operands.pool's draw under seed * pool_calls + i,
    narrowed to int32: the device never holds the whole pool as int64."""
    spec = tiny.spec(NAME)
    cfg, tr, entry = spec["config"], spec["traffic"], spec["entry"]
    seed, calls = 2**31 + 5, tr["pool_calls"]
    pool = entry.operands_pool(cfg, tr, seed, "cpu")
    rows = pool[0][0].shape[0]
    q = operands.row_moduli(cfg["primes"], rows)
    for i, (a, b) in enumerate(pool):
        want = operands.pool((2, rows, 1 << cfg["logn"]), q, seed * calls + i, "cpu")
        assert torch.equal(a, want[0].int()) and torch.equal(b, want[1].int())
    assert not torch.equal(pool[0][0], pool[1][0])


def test_the_control_takes_the_float32_product_on_32_bit_words():
    """The float64 product is exact at 30-bit moduli (a * b < 2^60: its
    quotient is off by one at most), so the entry reads the control's
    float product at float32, which misses most single products (and
    then, through a transform's chains of them, every coefficient)."""
    qs = harness.config("he_std128_n15_u32")["primes"]
    q = torch.tensor(qs).reshape(-1, 1)
    gen = torch.Generator().manual_seed(5)
    a, b = (torch.randint(0, 1 << 62, (30, 4096), generator=gen) % q for _ in range(2))
    exact = modpoly.mulmod(a, b, q)
    assert torch.equal(modpoly.mulmod_f64(a, b, q), exact)
    _, _, entry = _files()
    assert (entry.mulmod_f32(a, b, q) != exact).float().mean() > 0.5
