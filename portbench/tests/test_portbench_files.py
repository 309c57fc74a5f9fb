"""Every file BENCHMARK.json names loads by name, the configurations hold
the primes their search gives, and each cell's counts per call are the
hand counts."""

from __future__ import annotations

import math

import pytest

from portbench import harness
from portbench.reference import primes

BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    w = harness.cell(BENCH, name)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    assert cfg["name"] == w["config"]
    entry = harness.module("entries", tr["entry"])
    for fn in ("counts", "operands_pool", "build", "call", "reference"):
        assert callable(getattr(entry, fn))
    assert tr["loop"] in ("stream", "sync")
    assert tr["pool_calls"] >= 1 and tr["sample_calls"] >= 1


@pytest.mark.parametrize("name", METRICS)
def test_metric_readers_load_by_name(name):
    assert callable(harness.module("metrics", name).read)


def test_names_are_refused_outside_the_folders():
    with pytest.raises(ValueError):
        harness.config("../BENCHMARK")


def test_he_config_is_the_largest_ladder_under_the_standard():
    cfg = harness.config("he_std128_n15")
    qs = cfg["primes"]
    assert qs == primes.ntt_primes(59, cfg["logn"], len(qs))
    assert all((q - 1) % (2 << cfg["logn"]) == 0 and q.bit_length() == 59 for q in qs)
    assert math.log2(math.prod(qs)) <= cfg["log2_q_limit"] == 881
    one_more = primes.ntt_primes(59, cfg["logn"], len(qs) + 1)
    assert math.log2(math.prod(one_more)) > 881


def test_zk_prime_is_found_by_the_search():
    cfg = harness.config("zk_u64_n24")
    assert cfg["q"] == primes.ntt_primes(59, 24, 1)[0]
    assert (cfg["q"] - 1) % (1 << 25) == 0
    n1, n2 = cfg["fourstep_dims"]
    assert n1 * n2 == 1 << cfg["logn"]


# (output coefficients, operand bytes) of one call, counted by hand:
# HE: 8 (or 1) ciphertext pairs x 2 polynomials x 15 primes rows of 2^15,
# a and b read and the product written; 4-step: one 2^24 polynomial read
# and written; polymul: a and b read, the product written; 8-byte lanes
HAND = {
    "he_n15_polymul_stream": (240 * 32768, 3 * 8 * 240 * 32768),
    "zk_n24_ntt_stream": (16777216, 2 * 8 * 16777216),
    "he_n15_polymul_single": (30 * 32768, 3 * 8 * 30 * 32768),
    "zk_n24_polymul_stream": (16777216, 3 * 8 * 16777216),
}


@pytest.mark.parametrize("name", CELLS)
def test_counts_per_call_are_the_hand_counts(name):
    w = harness.cell(BENCH, name)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    got = harness.module("entries", tr["entry"]).counts(cfg, tr)
    assert (got["coefs"], got["bytes"]) == HAND[name]


@pytest.mark.parametrize("name", CELLS)
def test_pool_is_four_times_the_l2_or_more(name):
    w = harness.cell(BENCH, name)
    cfg, tr = harness.config(w["config"]), harness.traffic(w["traffic"])
    counts = harness.module("entries", tr["entry"]).counts(cfg, tr)
    inputs = counts["bytes"] - 8 * counts["coefs"]  # the operands a call reads
    assert tr["pool_calls"] * inputs >= 4 * 50e6


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell_name in m["workloads"]:
            assert cell_name in e2e.get("workloads", CELLS)
    for name in CELLS:
        assert len(harness.metrics_of(BENCH, name, False)) >= 2
        assert harness.metrics_of(BENCH, name, True)
