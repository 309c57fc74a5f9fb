"""The port's u64 big ring, nested composition included, against the
benchmark's plain reference (CPU, exact equality).

- The nested composition (rows that recurse into a nested LargePlan, as
  at logn 27-28) through the plain versions at logn 14-16, where a
  reduced split nests once or twice, both reduction polynomials, against
  portbench's merge-order reference (`entries/merge_lanes.py`, from
  `reference/modpoly`): forward, inverse and the round trip.
- ntt_lanes / intt_lanes on the "hopper-merge-large" route at logn 18
  and 20, against the same reference.
- LargePlan.passes on the route's splits at logn 18-28, read from plans
  that hold no ring-sized table; the `passes` attr of the route's span
  under the profiler; passes equal to the transform's launches.

Imports no jax; nothing above logn 20 is transformed here.
"""

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge_large as hml
from gpuntt_tpu_torch.ops import kernel

from portbench import harness
from portbench.reference import modpoly, primes

torch.set_num_threads(2)

MINUS, PLUS = tg.ReductionPolynomial.X_N_minus, tg.ReductionPolynomial.X_N_plus
ENTRY = harness.module("entries", "merge_lanes")
# rows beyond 2^9 recurse, with 8 columns at the first nesting
NESTED = dict(a_col=8, max_row_logn=9, row_kwargs=dict(a_col=8))


@pytest.fixture(autouse=True)
def _clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _params(logn: int, poly) -> tg.NTTParameters:
    """2^logn over the benchmark's 59-bit prime for it, the reference's
    range, with the benchmark's roots (as its ZK configurations take)."""
    q = primes.ntt_primes(59, logn, 1)[0]
    return tg.NTTParameters(logn, poly, np.uint64,
                            factors=tg.NTTFactors(tg.Modulus64(q), *primes.root_pair(q, logn)))


def _operand(q: int, logn: int, seed: int, rows: int = 2) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, q, (rows, 1 << logn), generator=gen, dtype=torch.int64)


def _reference(x: torch.Tensor, p: tg.NTTParameters, inverse: bool) -> torch.Tensor:
    """The merge transform of p's ring by the benchmark's reference:
    cyclic by omega, or for X^N + 1 twisted by psi^j around it."""
    q, n = p.modulus.value, p.n
    qt = torch.full((x.shape[0], 1), q)
    psi = p.root_of_unity if p.poly_reduction == PLUS else None
    omega = psi * psi % q if psi else p.root_of_unity
    root = torch.full_like(qt, omega)
    if inverse:
        y = ENTRY.merge_inverse(x, qt, root)
        if psi:
            y = modpoly.mulmod(y, modpoly.powers(torch.full_like(qt, pow(psi, -1, q)), qt, n), qt)
        return y
    if psi:
        x = modpoly.mulmod(x, modpoly.powers(torch.full_like(qt, psi), qt, n), qt)
    return ENTRY.merge_forward(x, qt, root)


def _nested_plan(logn: int, poly) -> tuple[tg.NTTParameters, hml.LargePlan]:
    p = _params(logn, poly)
    q = p.modulus.value
    lp = hml.LargePlan.from_spec(q, logn, p.root_of_unity, p.inverse_root_of_unity,
                                 poly == PLUS, pow(p.n, q - 2, q), device="cpu", **NESTED)
    return p, lp


def _depth(lp: hml.LargePlan) -> int:
    return 1 + _depth(lp.nested) if lp.nested is not None else 0


@pytest.mark.parametrize("poly", [MINUS, PLUS])
@pytest.mark.parametrize("logn,depth", [(14, 1), (15, 1), (16, 2)])
def test_nested_composition_matches_the_reference(logn, depth, poly):
    """2^14: 8 x 2^11, the rows nested as 8 x 256 on K8; 2^15: 8 x 2^12,
    nested 8 x 512; 2^16: 8 x 2^13, nested 8 x 2^10, whose rows nest
    again at the route's 128 x 8.  Every level's rows are X^B - 1."""
    p, lp = _nested_plan(logn, poly)
    assert _depth(lp) == depth and lp.row_kernel == "nested"
    leaf = lp
    while leaf.nested is not None:
        leaf = leaf.nested
    assert leaf.row_kernel == "K8"
    assert lp.passes == depth + 2  # the columns at each level, then K8's rows
    x = _operand(p.modulus.value, logn, logn)
    fx = hml.merge_u64_large_plain(x, lp)
    assert torch.equal(fx, _reference(x, p, False))
    assert torch.equal(hml.merge_u64_large_plain(x, lp, inverse=True), _reference(x, p, True))
    assert torch.equal(hml.merge_u64_large_plain(fx, lp, inverse=True), x)


@pytest.mark.parametrize("logn,poly", [(18, MINUS), (18, PLUS), (20, MINUS)])
def test_lanes_entries_on_the_big_ring_route_match_the_reference(logn, poly):
    """The public entries on the route the benchmark's ZK cell takes (the
    plain versions on the CPU): 2^18 as 128 x 2^11, 2^20 as 128 x 2^13."""
    p = _params(logn, poly)
    plan = tg.MergePlan.from_params(p, device="cpu")
    assert td._kernel_path(plan, (1, p.n), tg.NTTLayout.PerPolynomial) == "hopper-merge-large"
    x = _operand(p.modulus.value, logn, 100 + logn, rows=1)
    fx = tg.ntt_lanes(x, plan)
    assert torch.equal(fx, _reference(x, p, False))
    assert torch.equal(tg.intt_lanes(x, plan), _reference(x, p, True))
    assert torch.equal(tg.intt_lanes(fx, plan), x)
    assert (hml.COLFWD.plain_calls, hml.COLINV.plain_calls) == (1, 2)


@pytest.mark.parametrize("logn,passes", [(18, 2), (22, 2), (23, 3), (24, 3), (27, 3), (28, 3)])
def test_passes_of_the_routes_split(logn, passes):
    """1 for the columns, then the rows': K1 in one pass up to rows of
    2^15 (logn 18-22), in two above (23-26); at 27 the nested 512 x 512
    (K7 and K8), at 28 the nested 128 x 2^12 (K7 and K1 in one pass).
    No plan holds a ring-sized table."""
    p = tg.NTTParameters(logn, MINUS, np.uint64)
    plan = tg.MergePlan.from_params(p, device="cpu")
    lp = hml.large_plan(plan)
    assert plan.fwd_table is None and lp.device_bytes() < 48 << 20
    assert lp.passes == passes
    if logn == 27:
        assert (lp.A, lp.B, lp.nested.A, lp.nested.B, lp.nested.row_kernel) == (
            512, 1 << 18, 512, 512, "K8")


def test_route_span_notes_the_passes_under_the_profiler():
    """ntt_lanes and intt_lanes at logn 18 on the big-ring route: each
    route span notes the transform's passes; a ring of the register-pass
    kernels' own route (logn 12) notes none."""
    big = tg.MergePlan.from_params(tg.NTTParameters(18, MINUS, np.uint64), device="cpu")
    small = tg.MergePlan.from_params(tg.NTTParameters(12, MINUS, np.uint64), device="cpu")
    xb, xs = _operand(big.q, 18, 1, rows=1), _operand(small.q, 12, 2, rows=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tg.ntt_lanes(xb, big)
        tg.intt_lanes(xb, big)
        tg.ntt_lanes(xs, small)
    routes = [s["attrs"] for s in tracing.snapshot()["spans"] if s["name"] == "ntt.route"]
    assert [(a["path"], a.get("passes")) for a in routes] == [
        ("hopper-merge-large", 2), ("hopper-merge-large", 2), ("hopper-merge", None)]
    assert tracing.snapshot()["spans"][0]["attrs"] == {"entry": "ntt_lanes"}


@pytest.mark.parametrize("case", ["nested-15", "route-18"])
def test_passes_are_the_transforms_launches(monkeypatch, case):
    """LargePlan.passes equals the launches of a transform through the
    kernels' composition, forward and inverse: one a K7, K8 or K1 call at
    log A 0, two a K1 call at log A > 0 (merge_u64.cu's column and row
    kernels).  Nested at 2^15 as 8 x 2^12, nested 8 x 512 (3); the
    route's 2^18 as 128 x 2^11 with K1 rows (2)."""
    launches = []
    call = kernel.call

    def spy(stats, *args, log_a=None):
        launches.append(2 if log_a else 1)
        return call(stats, *args, log_a=log_a)

    monkeypatch.setattr(kernel, "call", spy)
    if case == "nested-15":
        p, lp = _nested_plan(15, MINUS)
        x = _operand(p.modulus.value, 15, 3, rows=1)
    else:
        plan = tg.MergePlan.from_params(tg.NTTParameters(18, MINUS, np.uint64), device="cpu")
        lp = hml.large_plan(plan)
        x = _operand(plan.q, 18, 4, rows=1)
    for inverse in (False, True):
        launches.clear()
        hml.merge_u64_large(x, lp, inverse=inverse)
        assert sum(launches) == lp.passes == (3 if case == "nested-15" else 2), launches
