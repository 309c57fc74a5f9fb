"""The RNS route memo (ops/dispatch._rns_route) and K12's product in one
C call (hopper_rns.prepare, hopper_rns.rns_u64_polymul), on the CPU.

- The memo: a repeat schedule hits, a new schedule, row count, rank or
  device misses, a schedule changed in place misses, at most 64 routes
  are kept, and hits and misses give the plain composition's product.
- Bad operands raise the wrappers' NTTDispatchError on a hit as on a
  miss; a non-contiguous operand is accepted.
- The C entry rns_u64_polymul, compiled by g++ through
  test_torch_merge.py's host emulation, against the three entries it
  chains (forward, forward, fused inverse) at logn 11-17, both
  polynomials; and the prepared call through that emulation: the same
  product, checks and errors, FORWARD 2 and POLYMUL_INVERSE 1 launch a
  call under one ntt.launch span.
"""

import types

import numpy as np
import pytest
import torch

import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge as hm
from gpuntt_tpu_torch.ops import hopper_rns as hr
from gpuntt_tpu_torch.ops import kernel
from gpuntt_tpu_torch.ops.limb import from_numpy_u64
from test_torch_merge import _emulate  # the host emulation of csrc/

torch.set_num_threads(2)

PLUS, MINUS = tg.ReductionPolynomial.X_N_plus, tg.ReductionPolynomial.X_N_minus


@pytest.fixture(autouse=True)
def _clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _plan(logn=12, poly=PLUS, count=3, device="cpu"):
    ms = []
    for q in tg.find_ntt_primes(59, logn, count):
        om, psi = tg.ntt_root_pair(q, logn)
        ms.append(tg.NTTParameters(logn, poly, np.uint64,
                                   factors=tg.NTTFactors(tg.Modulus64(q), om, psi)))
    return tg.RNSMergePlan.from_params(ms, device=device)


def _words(plan, rows, seed):
    rng = np.random.default_rng(seed)
    return from_numpy_u64(rng.integers(0, 1 << 64, size=(rows, plan.n), dtype=np.uint64), "cpu")


def _plain_product(a, b, plan, mod_idx):
    midx = torch.tensor(np.asarray(mod_idx), dtype=torch.int32)
    return hr.rns_u64_polymul_inv_plain(hr.rns_u64_fwd_plain(a, plan, midx),
                                        hr.rns_u64_fwd_plain(b, plan, midx), plan, midx)


def _outcomes():
    return tracing.COUNTERS["schedule.hit"], tracing.COUNTERS["schedule.miss"]


# ------------------------------------------------------------------ the memo


def test_route_memo_hits_a_repeat_and_misses_a_new_schedule_rows_rank_or_device():
    plan = _plan()
    x = _words(plan, 3, 0)
    _, first = td._rns_route(plan, x, np.arange(3) % 3)
    assert first.path == "hopper-rns" and first.product is None  # no prepared call off the card
    assert first.midx.dtype == torch.int32 and first.midx.tolist() == [0, 1, 2]
    assert _outcomes() == (0, 1)
    for same in (np.arange(3) % 3, [0, 1, 2], np.array([0, 1, 2], dtype=np.int32)):
        assert td._rns_route(plan, x, same)[1] is first  # the contents are the key
    assert _outcomes() == (3, 1)
    assert td._rns_route(plan, x, [2, 0, 1])[1].midx.tolist() == [2, 0, 1]
    assert _outcomes() == (3, 2)
    one = td._rns_route(plan, x, [1])[1]
    six = td._rns_route(plan, _words(plan, 6, 1), [1])[1]  # one entry serves every row
    assert (one.mod_idx.tolist(), six.mod_idx.tolist()) == ([1] * 3, [1] * 6)
    assert _outcomes() == (3, 4)
    flat = td._rns_route(plan, x.reshape(1, 3, plan.n)[0], [1])[1]
    deep = td._rns_route(plan, x.reshape(3, 1, plan.n), [1])[1]  # another rank: the engine
    assert (flat is one, deep.path) == (True, "engine")
    assert _outcomes() == (4, 5)
    meta, moved = td._rns_route(plan, x.to("meta"), np.arange(3) % 3)
    assert meta.device.type == "meta" and moved is not first and moved.midx.is_meta
    assert _outcomes() == (4, 6)
    assert len(plan._lazy["routes"]) == 5 and len(meta._lazy["routes"]) == 1


def test_a_schedule_changed_in_place_misses():
    plan = _plan()
    a, b = _words(plan, 3, 2), _words(plan, 3, 3)
    sched = np.arange(3) % 3
    before = td.rns_polymul_lanes(a, b, plan, sched)
    sched[0] = 2
    after = td.rns_polymul_lanes(a, b, plan, sched)
    assert _outcomes() == (0, 2)
    assert torch.equal(before, _plain_product(a, b, plan, [0, 1, 2]))
    assert torch.equal(after, _plain_product(a, b, plan, [2, 1, 2]))
    assert not torch.equal(before[0], after[0])


def test_the_memo_keeps_at_most_64_routes():
    plan = _plan()
    x = _words(plan, 3, 4)
    for k in range(70):
        td._rns_route(plan, x, [k % 3, k // 3 % 3, k // 9])
    assert _outcomes() == (0, 70) and len(plan._lazy["routes"]) == 70 - 64
    td._rns_route(plan, x, [69 % 3, 69 // 3 % 3, 69 // 9])
    assert _outcomes() == (1, 70)


@pytest.mark.parametrize("poly", [PLUS, MINUS])
def test_hits_and_misses_give_the_plain_composition(poly):
    plan = _plan(poly=poly)
    pairs = [(_words(plan, 4, 5 + k), _words(plan, 4, 9 + k)) for k in range(3)]
    sched = np.array([2, 0, 1, 2])
    for a, b in pairs:
        assert torch.equal(td.rns_polymul_lanes(a, b, plan, sched),
                           _plain_product(a, b, plan, sched))
    assert _outcomes() == (2, 1)
    assert (hr.FORWARD.plain_calls, hr.POLYMUL_INVERSE.plain_calls) == (6, 3)
    assert (hr.FORWARD.launches, hr.POLYMUL_INVERSE.launches) == (0, 0)


def _bad_operands(plan, a, b):
    """name -> (a, b): an operand the wrappers refuse."""
    return {
        "dtype": (a.to(torch.int32), b),
        "width": (a[:, :-1], b),
        "device": (a, b.to("meta")),
        "b rows": (a, b[:2]),
        "b width": (a, b[:, :-2]),
        "b dtype": (a, b.to(torch.float64)),
    }


@pytest.mark.parametrize("case", ["dtype", "width", "device", "b rows", "b width", "b dtype"])
def test_bad_operands_raise_the_same_error_on_a_hit_as_on_a_miss(case):
    plan = _plan()
    a, b = _words(plan, 3, 12), _words(plan, 3, 13)
    sched = np.arange(3) % 3
    bad = _bad_operands(plan, a, b)[case]
    with pytest.raises(tg.NTTDispatchError) as miss:
        td.rns_polymul_lanes(*bad, plan, sched)
    td.rns_polymul_lanes(a, b, plan, sched)
    with pytest.raises(tg.NTTDispatchError) as hit:
        td.rns_polymul_lanes(*bad, plan, sched)
    assert str(hit.value) == str(miss.value)
    assert _outcomes() == (2, 1)


def test_a_non_contiguous_operand_is_accepted():
    plan = _plan()
    a, b = _words(plan, 3, 14), _words(plan, 6, 15)[::2]
    assert not b.is_contiguous()
    sched = np.arange(3) % 3
    want = _plain_product(a, b.contiguous(), plan, sched)
    assert torch.equal(td.rns_polymul_lanes(a, b, plan, sched), want)
    assert torch.equal(td.rns_polymul_lanes(a.t().contiguous().t(), b, plan, sched), want)


# ----------------------------------------- the C entry and the prepared call


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _emulate(tmp_path_factory, "merge_u64")


def _entry(lib, entry, plan, midx, shift, *xs):
    table, shoup = ((plan.fwd_tables, plan.fwd_shoup) if entry == "rns_u64_forward"
                    else (plan.inv_tables, plan.inv_shoup))
    y = torch.empty_like(xs[0])
    rc = getattr(lib, entry)(0, *(x.data_ptr() for x in xs), y.data_ptr(), xs[0].shape[0],
                             plan.logn, hm.split(plan.logn), midx.data_ptr(), midx.numel(),
                             shift, table.data_ptr(), shoup.data_ptr(), plan.consts.data_ptr(),
                             int(plan.xnp), None)
    assert rc == 0, entry
    return y


@pytest.mark.parametrize("logn", [11, 12, 13, 14, 15, 16, 17])
def test_emulated_entry_equals_the_three_entries_it_chains(emu, logn):
    plan = _plan(logn, PLUS if logn % 2 else MINUS)
    for sched, shift in (([2, 0, 1], 0), ([1, 2], 1)):
        midx = torch.tensor(sched, dtype=torch.int32)
        rows = len(sched) << shift
        a, b = _words(plan, rows, logn), _words(plan, rows, logn + 1)
        fa = _entry(emu, "rns_u64_forward", plan, midx, shift, a)
        fb = _entry(emu, "rns_u64_forward", plan, midx, shift, b)
        want = _entry(emu, "rns_u64_polymul_inverse", plan, midx, shift, fa, fb)
        spectra, y = torch.empty((2, rows, plan.n), dtype=torch.int64), torch.empty_like(a)
        rc = emu.rns_u64_polymul(0, a.data_ptr(), b.data_ptr(), spectra[0].data_ptr(),
                                 spectra[1].data_ptr(), y.data_ptr(), rows, plan.logn,
                                 hm.split(plan.logn), midx.data_ptr(), midx.numel(), shift,
                                 plan.fwd_tables.data_ptr(), plan.fwd_shoup.data_ptr(),
                                 plan.inv_tables.data_ptr(), plan.inv_shoup.data_ptr(),
                                 plan.consts.data_ptr(), int(plan.xnp), None)
        assert rc == 0
        assert torch.equal(y, want) and torch.equal(spectra[0], fa) and torch.equal(spectra[1], fb)
        # a schedule that names the wrong number of rings is refused
        assert emu.rns_u64_polymul(0, a.data_ptr(), b.data_ptr(), spectra[0].data_ptr(),
                                   spectra[1].data_ptr(), y.data_ptr(), rows, plan.logn,
                                   hm.split(plan.logn), midx.data_ptr(), midx.numel() + 1,
                                   shift, plan.fwd_tables.data_ptr(), plan.fwd_shoup.data_ptr(),
                                   plan.inv_tables.data_ptr(), plan.inv_shoup.data_ptr(),
                                   plan.consts.data_ptr(), int(plan.xnp), None) == 1


class _Stream:
    cuda_stream = 0


@pytest.fixture
def emulated_prepare(emu, monkeypatch):
    """hopper_rns.prepare bound to the emulated library (card 0, any stream)."""
    lib = types.SimpleNamespace(rns_u64_polymul=lambda dev, *args: emu.rns_u64_polymul(0, *args))
    monkeypatch.setattr(kernel, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return hr.prepare


def test_prepared_call_through_the_emulation(emulated_prepare):
    plan = _plan(13, MINUS)
    sched = np.array([1, 2, 0, 1])
    midx = torch.tensor(sched, dtype=torch.int32)
    prepared = emulated_prepare(plan, midx)
    assert (prepared.rows, prepared.n, prepared.device) == (4, plan.n, plan.device)
    a, b = _words(plan, 4, 16), _words(plan, 8, 17)[1::2]
    want = _plain_product(a, b, plan, sched)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [hr.rns_u64_polymul(a, b, prepared) for _ in range(2)]
    assert all(torch.equal(y, want) for y in got)
    assert (hr.FORWARD.launches, hr.POLYMUL_INVERSE.launches) == (4, 2)
    assert (hr.FORWARD.plain_calls, hr.POLYMUL_INVERSE.plain_calls) == (0, 0)
    spans = tracing.snapshot()["spans"]
    assert [(s["name"], s["attrs"]) for s in spans] == [
        ("ntt.launch", {"kernel": "rns_u64_polymul", "word": 8, "passes": 1})] * 2


@pytest.mark.parametrize("case", ["dtype", "width", "device", "b rows", "b width", "b dtype"])
def test_prepared_call_raises_the_wrappers_error(emulated_prepare, case):
    plan = _plan()
    midx = torch.tensor([0, 1, 2], dtype=torch.int32)
    a, b = _words(plan, 3, 18), _words(plan, 3, 19)
    bad = _bad_operands(plan, a, b)[case]
    with pytest.raises(tg.NTTDispatchError) as wrappers:
        hr.rns_u64_polymul_inv(hr.rns_u64_fwd(bad[0].contiguous(), plan, midx),
                               hr.rns_u64_fwd(bad[1].contiguous(), plan, midx), plan, midx)
    with pytest.raises(tg.NTTDispatchError) as prepared:
        hr.rns_u64_polymul(*bad, emulated_prepare(plan, midx))
    assert str(prepared.value) == str(wrappers.value)
    assert hr.POLYMUL_INVERSE.launches == 0


def test_prepare_refuses_what_the_wrappers_refuse():
    wide = tg.RNSMergePlan.from_params([
        tg.NTTParameters(12, PLUS, np.uint64,
                         factors=tg.NTTFactors(tg.Modulus64(q), *tg.ntt_root_pair(q, 12)))
        for q in tg.find_ntt_primes(63, 12, 2)], device="cpu")
    midx = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(tg.NTTDispatchError):  # q >= 2^62: past the lazy butterflies
        hr.prepare(wide, midx)
    with pytest.raises(tg.NTTDispatchError):  # K12 takes logn 11-17
        hr.prepare(_plan(18, PLUS, 2), midx)
