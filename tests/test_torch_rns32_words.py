"""The u32 RNS entries on int32 lanes (4-byte words), on the CPU.

- ntt_rns_lanes, intt_rns_lanes and rns_polymul_lanes take int32 lanes on
  a u32 ladder and return int32 equal, bit for bit, to their int64-lane
  results narrowed: at logn 8-17 (K16's range) and 18 (K6's), both
  reduction polynomials, the cyclic and a permuted schedule.
- rns_polymul_lanes on the benchmark's own ladder (portbench's
  he_std128_n15_u32: 30 primes of 30 bits, each 1 mod 2^16) at logn 12,
  60 rows, against portbench/reference/modpoly.polymul (plain PyTorch);
  and one product against the JAX package's u32 RNS polymul on its
  uint32 arrays.
- merge_u32.cu's rns_u32_*_i32 entries, compiled by g++ through
  test_torch_merge.py's host emulation under UBSan's alignment check,
  against the int64-lane entries and the plain versions: views aligned
  to 16 bytes and views 1-3 words past it (4 bytes each), and the int64
  entries on views one word past it; the whole-ring kernels of logn
  14-15 (clusters of two blocks, each block a host thread) in place.
- The fused product (rns_u32_polymul and its _i32 twin: a row pair on a
  cluster of 2^(logn - 13) blocks) on any u32 word against the
  three-entry composition and the plain versions, in place too, and its
  refusals; the route's prepared product through the emulation (its
  launch count and span), and dispatch's choice of it: "hopper-rns32"
  on a card at logn 14-15 only.
- The engine route widens, runs and narrows; a u64 ladder refuses int32
  lanes; the wrappers and rns_polymul_lanes, on the engine route too,
  refuse mixed lanes; the `word` and `passes` attrs of ntt.launch spans,
  portbench's one_pass_share, and the `lanes` attr of the RNS ntt.route
  span under a profiler.
- The benchmark's he_n15_u32_polymul_stream at a CPU size: correct, and
  its control is not.
"""

import types

import numpy as np
import pytest
import torch

import gpuntt_tpu as jg
import gpuntt_tpu_torch as tg
from gpuntt_tpu_torch.common import tracing
from gpuntt_tpu_torch.ops import dispatch as td
from gpuntt_tpu_torch.ops import hopper_merge32 as hm32
from gpuntt_tpu_torch.ops import hopper_rns32 as hr32
from gpuntt_tpu_torch.ops import kernel
from gpuntt_tpu_torch.ops.rns import row_schedule
from portbench import harness
from portbench.reference import modpoly, primes
from test_torch_merge import _emulate  # the host emulation of csrc/

torch.set_num_threads(2)

MINUS, PLUS = tg.ReductionPolynomial.X_N_minus, tg.ReductionPolynomial.X_N_plus


@pytest.fixture(autouse=True)
def _clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def members(pkg, logn, poly, qs):
    return [pkg.NTTParameters(
        logn, pkg.ReductionPolynomial(poly.value), np.uint32,
        factors=pkg.NTTFactors(pkg.Modulus32(q), *primes.root_pair(q, logn))) for q in qs]


def ladder(logn, poly, count=3, bits=30):
    return tg.RNSMergePlan.from_params(
        members(tg, logn, poly, primes.ntt_primes(bits, logn, count)), device="cpu")


def residues(plan, mod_idx, seed):
    """(rows, N) int64 lanes, row r canonical under modulus mod_idx[r]."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.integers(0, plan.qs[m], plan.n)
                                      for m in mod_idx]).astype(np.int64))


# ------------------------------------------- int32 lanes against int64 lanes


SCHEDULES = {"cyclic": [0, 1, 2, 0, 1, 2], "permuted": [2, 0, 1, 1, 2, 0]}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("poly", [MINUS, PLUS])
@pytest.mark.parametrize("logn", [*range(8, 18), 18])
def test_int32_lanes_equal_int64_lanes_narrowed(logn, poly, schedule):
    plan = ladder(logn, poly)
    mod_idx = np.array(SCHEDULES[schedule])
    assert td._rns_kernel_path(plan, (len(mod_idx), plan.n)) == "hopper-rns32"
    a, b = residues(plan, mod_idx, logn), residues(plan, mod_idx, logn + 100)
    a32, b32 = a.int(), b.int()
    for fn in (td.ntt_rns_lanes, td.intt_rns_lanes):
        got, want = fn(a32, plan, mod_idx), fn(a, plan, mod_idx)
        assert got.dtype == torch.int32 and torch.equal(got, want.int()), fn.__name__
    got = td.rns_polymul_lanes(a32, b32, plan, mod_idx)
    assert got.dtype == torch.int32
    assert torch.equal(got, td.rns_polymul_lanes(a, b, plan, mod_idx).int())
    k = hr32.tpu_kernel(logn)
    assert hr32.FORWARD[k].plain_calls == 2 * 3 and hr32.POLYMUL_INVERSE[k].plain_calls == 2


# ---------------------------------------- against the reference and the JAX package


def test_polymul_on_the_benchmarks_ladder_equals_the_plain_reference():
    """The configuration's 30 primes at logn 12 (each is 1 mod 2^16, so
    has a 2^13-th root), 60 rows: two ciphertexts' worth, row r under
    prime r mod 30."""
    qs = harness.config("he_std128_n15_u32")["primes"]
    logn, rows = 12, 60
    plan = tg.RNSMergePlan.from_params(members(tg, logn, PLUS, qs), device="cpu")
    mod_idx = np.arange(rows) % len(qs)
    a, b = residues(plan, mod_idx, 1), residues(plan, mod_idx, 2)
    got = td.rns_polymul_lanes(a.int(), b.int(), plan, mod_idx)
    q = torch.tensor([qs[m] for m in mod_idx]).reshape(-1, 1)
    psi = torch.tensor([primes.root_pair(qs[m], logn)[1] for m in mod_idx]).reshape(-1, 1)
    want = modpoly.polymul(a, b, q, psi, True)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want)


def test_polymul_on_int32_lanes_equals_the_jax_packages_u32_polymul():
    logn, qs = 12, primes.ntt_primes(30, 12, 3)
    jplan = jg.RNSMergePlan.from_params(members(jg, logn, MINUS, qs))
    plan = tg.RNSMergePlan.from_params(members(tg, logn, MINUS, qs), device="cpu")
    mod_idx = np.arange(5) % 3
    x = residues(plan, mod_idx, 3).numpy().astype(np.uint32)
    y = residues(plan, mod_idx, 4).numpy().astype(np.uint32)
    want = np.asarray(jg.rns_polymul(x, y, jplan))
    got = td.rns_polymul_lanes(torch.from_numpy(x.view(np.int32)),
                               torch.from_numpy(y.view(np.int32)), plan, mod_idx)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ------------------------------------------------ the CUDA source, emulated


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """merge_u32.cu emulated under UBSan's alignment check: a 16-byte
    access at an address that is not 16-byte aligned reports itself on
    stderr."""
    return _emulate(tmp_path_factory, "merge_u32", ("-fsanitize=alignment",))


def _entry(lib, entry, plan, midx, shift, *xs, y):
    table = hm32.packed_tables(plan)[int(not entry.startswith("rns_u32_forward"))]
    rc = getattr(lib, entry)(0, *(x.data_ptr() for x in xs), y.data_ptr(), xs[0].shape[0],
                             plan.logn, hm32.split(plan.logn), midx.data_ptr(), midx.numel(),
                             shift, table.data_ptr(), plan.consts.data_ptr(), int(plan.xnp),
                             None)
    assert rc == 0, entry
    return y


def _at(x: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of x in a view that starts `offset` bytes past a 16-byte
    boundary."""
    step = x.element_size()
    flat = torch.zeros(x.numel() + 32 // step, dtype=x.dtype)
    start = (-flat.data_ptr() % 16 + offset) // step
    v = flat[start:start + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.data_ptr() % 16 == offset
    return v


@pytest.mark.parametrize("logn,poly", [(8, PLUS), (14, MINUS), (14, PLUS), (15, PLUS),
                                       (15, MINUS), (18, MINUS)])
def test_source_emulated_int32_entries(emu, capfd, logn, poly):
    """The three rns_u32_*_i32 entries on canonical residues equal the
    int64-lane entries and the plain versions, narrowed, on schedules of
    one entry per ring and per two rings, with operands and outputs at
    every 4-byte offset from a 16-byte boundary (one launch over whole
    rings at logn 8, one over whole rings held by clusters of two blocks
    at 14 and 15, a column and a row launch at 18); the int64-lane
    entries on views one word (8 bytes) past it agree too."""
    plan = ladder(logn, poly)
    for midx, shift in ((torch.tensor([2, 0, 1, 1], dtype=torch.int32), 0),
                        (torch.tensor([1, 2], dtype=torch.int32), 1)):
        rows = midx.numel() << shift
        sched = row_schedule(midx, shift).numpy()
        x, w = residues(plan, sched, logn), residues(plan, sched, logn + 1)
        fx = hr32.rns_u32_fwd_plain(x, plan, midx, shift)
        fw = hr32.rns_u32_fwd_plain(w, plan, midx, shift)
        want = {"rns_u32_forward": (fx, (x,)),
                "rns_u32_inverse": (hr32.rns_u32_inv_plain(x, plan, midx, shift), (x,)),
                "rns_u32_polymul_inverse": (hr32.rns_u32_polymul_inv_plain(fx, fw, plan, midx,
                                                                          shift), (fx, fw))}
        for entry, (out, ins) in want.items():
            for k, off in enumerate((0, 4, 8, 12)):
                xs = [_at(v.int(), (off + 4 * j) % 16) for j, v in enumerate(ins)]
                y = _at(torch.empty((rows, plan.n), dtype=torch.int32), (16 - off) % 16)
                got = _entry(emu, entry + "_i32", plan, midx, shift, *xs, y=y)
                assert torch.equal(got, out.int()), (entry, off)
            xs = [_at(v, 8 * j) for j, v in enumerate(ins)]
            y = _at(torch.empty((rows, plan.n), dtype=torch.int64), 8)
            assert torch.equal(_entry(emu, entry, plan, midx, shift, *xs, y=y), out), entry
    err = capfd.readouterr().err
    assert "misaligned" not in err, err


@pytest.mark.parametrize("poly", [MINUS, PLUS])
@pytest.mark.parametrize("logn", [14, 15])
def test_source_emulated_whole_ring_in_place(emu, capfd, logn, poly):
    """The whole-ring kernels (a cluster of two blocks a ring) with the
    output aliasing the input, x = y, on int32 and int64 lanes, in views
    off a 16-byte boundary too: each block reads its words of the ring
    before the cluster barrier that precedes any write of them."""
    plan = ladder(logn, poly)
    midx = torch.tensor([1, 2, 0], dtype=torch.int32)
    x, w = residues(plan, [1, 2, 0], logn), residues(plan, [1, 2, 0], logn + 2)
    fx = hr32.rns_u32_fwd_plain(x, plan, midx)
    fw = hr32.rns_u32_fwd_plain(w, plan, midx)
    want = {"rns_u32_forward": (fx, (x,)),
            "rns_u32_inverse": (hr32.rns_u32_inv_plain(x, plan, midx), (x,)),
            "rns_u32_polymul_inverse": (hr32.rns_u32_polymul_inv_plain(fx, fw, plan, midx),
                                        (fx, fw))}
    for entry, (out, ins) in want.items():
        for suffix, dtype, off in (("_i32", torch.int32, 0), ("_i32", torch.int32, 4),
                                   ("", torch.int64, 0), ("", torch.int64, 8)):
            xs = [_at(v.to(dtype), off) for v in ins]
            got = _entry(emu, entry + suffix, plan, midx, 0, *xs, y=xs[0])
            assert got.data_ptr() == xs[0].data_ptr()
            assert torch.equal(got, out.to(dtype)), (entry, dtype, off)
    err = capfd.readouterr().err
    assert "misaligned" not in err, err


def test_source_emulated_int32_entries_refuse_bad_schedules(emu):
    plan = ladder(12, PLUS, 2)
    x = torch.zeros((4, plan.n), dtype=torch.int32)
    midx = torch.tensor([1, 0, 1], dtype=torch.int32)
    for entries, shift in ((3, 0), (3, 1), (0, 2)):  # 3 or 6 rings named for 4 rows, or none
        rc = emu.rns_u32_forward_i32(0, x.data_ptr(), x.data_ptr(), 4, 12, hm32.split(12),
                                     midx.data_ptr(), entries, shift,
                                     hm32.packed_tables(plan)[0].data_ptr(),
                                     plan.consts.data_ptr(), 1, None)
        assert rc == 1  # cudaErrorInvalidValue


def _product(lib, entry, plan, midx, shift, a, b, y, log_a=0, rows=None):
    """merge_u32.cu's fused product `entry` through the emulation; its rc."""
    fwd, inv = hm32.packed_tables(plan)
    return getattr(lib, entry)(0, a.data_ptr(), b.data_ptr(), y.data_ptr(),
                               a.shape[0] if rows is None else rows, plan.logn, log_a,
                               midx.data_ptr(), midx.numel(), shift, fwd.data_ptr(),
                               inv.data_ptr(), plan.consts.data_ptr(), int(plan.xnp), None)


@pytest.mark.parametrize("poly", [MINUS, PLUS])
@pytest.mark.parametrize("logn", [14, 15])
def test_source_emulated_fused_product(emu, capfd, logn, poly):
    """rns_u32_polymul and rns_u32_polymul_i32 (both forwards, the product
    and the inverse in one launch, a row pair on a cluster of 2^(logn -
    13) blocks) on any u32 word equal the three-entry composition (two
    forwards, the fused inverse) and the plain versions, under one
    schedule entry for all four rows and one a ring, on int64 and int32
    lanes, into a fresh output, into a view one word past a 16-byte
    boundary and in place over a."""
    plan = ladder(logn, poly)
    gen = torch.Generator().manual_seed(logn)
    words = torch.randint(0, 1 << 32, (2, 4, plan.n), generator=gen)
    for midx, shift in ((torch.tensor([2], dtype=torch.int32), 2),
                        (torch.tensor([2, 0, 1, 1], dtype=torch.int32), 0)):
        for suffix, dtype in (("", torch.int64), ("_i32", torch.int32)):
            a, b = (w.to(dtype) for w in words)  # int32 lanes: every 32-bit pattern
            ua, ub = a.long() & 0xFFFFFFFF, b.long() & 0xFFFFFFFF
            want = hr32.rns_u32_polymul_inv_plain(hr32.rns_u32_fwd_plain(ua, plan, midx, shift),
                                                  hr32.rns_u32_fwd_plain(ub, plan, midx, shift),
                                                  plan, midx, shift).to(dtype)
            fa = _entry(emu, "rns_u32_forward" + suffix, plan, midx, shift, a,
                        y=torch.empty_like(a))
            fb = _entry(emu, "rns_u32_forward" + suffix, plan, midx, shift, b,
                        y=torch.empty_like(b))
            three = _entry(emu, "rns_u32_polymul_inverse" + suffix, plan, midx, shift, fa, fb,
                           y=torch.empty_like(a))
            assert torch.equal(three, want)
            entry = "rns_u32_polymul" + suffix
            odd = _at(torch.empty_like(a), a.element_size())  # one word past 16 bytes
            for x, y in ((a, torch.empty_like(a)), (a, odd), (a.clone(),) * 2):  # last in place
                assert _product(emu, entry, plan, midx, shift, x, b, y) == 0
                assert torch.equal(y, want), (entry, shift)
    err = capfd.readouterr().err
    assert "misaligned" not in err, err


@pytest.mark.parametrize("case", ["logn 13", "logn 16", "logn 16 at log A 0", "empty batch",
                                  "schedule of 3 for 4 rows", "schedule of 2 rings of 4"])
def test_source_emulated_fused_product_refuses(emu, case):
    """The fused product takes only the shapes whose transforms run on the
    clusters (logn 14-15, log A 0), a batch, and a schedule of one entry
    per ring of 2^shift rows: anything else returns
    cudaErrorInvalidValue and launches nothing."""
    logn = {"logn 13": 13, "logn 16": 16, "logn 16 at log A 0": 16}.get(case, 14)
    plan = ladder(logn, PLUS, 2)
    x = torch.zeros((4, plan.n), dtype=torch.int32)
    y = torch.full_like(x, 7)
    midx, shift, rows = torch.tensor([1, 0, 1, 0], dtype=torch.int32), 0, 4
    log_a = 0 if case == "logn 16 at log A 0" else hm32.split(logn)
    if case == "empty batch":
        midx, rows = midx[:0], 0
    elif case == "schedule of 3 for 4 rows":
        midx = midx[:3]
    elif case == "schedule of 2 rings of 4":
        midx, shift = midx[:2], 2
    assert _product(emu, "rns_u32_polymul_i32", plan, midx, shift, x, x, y, log_a, rows) == 1
    assert torch.equal(y, torch.full_like(x, 7))


@pytest.fixture
def prepared32(emu, monkeypatch):
    """hopper_rns32.prepare bound to the emulated library (card 0, any stream)."""
    lib = types.SimpleNamespace(**{e: (lambda fn: lambda dev, *args: fn(0, *args))(
        getattr(emu, e)) for e in ("rns_u32_polymul", "rns_u32_polymul_i32")})
    monkeypatch.setattr(kernel, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    return hr32.prepare


def test_prepared_product_through_the_emulation(prepared32):
    """The route's prepared u32 product: one launch a call on either lane
    width, counted under POLYMUL, one ntt.launch span naming the C entry
    with the word's bytes and passes 1, the plain versions' result;
    operands the wrappers refuse raise their error."""
    plan = ladder(14, MINUS)
    sched = np.array([1, 2, 0, 1])
    midx = torch.tensor(sched, dtype=torch.int32)
    prepared = prepared32(plan, midx)
    a, b = residues(plan, sched, 30), residues(plan, sched, 31)
    want = hr32.rns_u32_polymul_inv_plain(hr32.rns_u32_fwd_plain(a, plan, midx),
                                          hr32.rns_u32_fwd_plain(b, plan, midx), plan, midx)
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = [hr32.rns_u32_polymul(x, w, prepared) for x, w in ((a.int(), b.int()), (a, b))]
    assert torch.equal(got[0], want.int()) and torch.equal(got[1], want)
    assert [(k.name, k.launches, k.plain_calls) for k in hr32.KERNELS if k.launches
            or k.plain_calls] == [(hr32.POLYMUL.name, 2, 0)]
    assert [(s["name"], s["attrs"]) for s in tracing.snapshot()["spans"]] == [
        ("ntt.launch", {"kernel": "rns_u32_polymul_i32", "word": 4, "passes": 1}),
        ("ntt.launch", {"kernel": "rns_u32_polymul", "word": 8, "passes": 1})]
    for bad in ((a.int(), b), (a[:3], b[:3]), (a[:, :-1], b[:, :-1]), (a.float(), b.float())):
        with pytest.raises(tg.NTTDispatchError):
            hr32.rns_u32_polymul(*bad, prepared)
    assert hr32.POLYMUL.launches == 2
    with pytest.raises(tg.NTTDispatchError):  # rings that no cluster holds
        prepared32(ladder(13, MINUS), midx)


@pytest.mark.parametrize("logn", [12, 13, 14, 15, 16])
def test_route_prepares_the_fused_product_at_logn_14_15_on_a_card(monkeypatch, logn):
    """dispatch prepares the one-launch product on a card for "hopper-rns32"
    at logn 14-15 only (K12's for "hopper-rns", none for the other
    paths or off the card); on the CPU the route holds none, and
    rns_polymul_lanes runs the three plain versions as before."""
    monkeypatch.setattr(hr32, "prepare", lambda plan, midx: "u32 product")
    monkeypatch.setattr(td.hr, "prepare", lambda plan, midx: "K12 product")
    plan = ladder(logn, PLUS, 2)
    midx = torch.tensor([0, 1], dtype=torch.int32)
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert hr32.fuses(plan) == (logn in (14, 15))
    assert td._prepared(plan, "hopper-rns32", midx, card) == (
        "u32 product" if logn in (14, 15) else None)
    assert td._prepared(plan, "hopper-rns", midx, card) == "K12 product"
    for path in ("hopper-rns-large", "engine"):
        assert td._prepared(plan, path, midx, card) is None
    assert td._prepared(plan, "hopper-rns32", midx, cpu) is None
    a = residues(plan, [0, 1], logn)
    _, route = td._rns_route(plan, a, [0, 1])
    assert route.path == "hopper-rns32" and route.product is None
    td.rns_polymul_lanes(a.int(), a.int(), plan, [0, 1])
    k = hr32.tpu_kernel(logn)
    assert [(s.name, s.plain_calls) for s in hr32.KERNELS if s.plain_calls] == [
        (hr32.FORWARD[k].name, 2), (hr32.POLYMUL_INVERSE[k].name, 1)]


# ------------------------------------------------ the engine and the refusals


@pytest.mark.parametrize("case", ["logn 7", "q above 2^30"])
def test_engine_route_widens_runs_and_narrows(case):
    plan = ladder(7, PLUS) if case == "logn 7" else ladder(12, MINUS, 2, bits=31)
    mod_idx = np.array([1, 0, 1])
    assert td._rns_kernel_path(plan, (3, plan.n)) == "engine"
    a, b = residues(plan, mod_idx, 5), residues(plan, mod_idx, 6)
    for fn in (td.ntt_rns_lanes, td.intt_rns_lanes):
        got = fn(a.int(), plan, mod_idx)
        assert got.dtype == torch.int32 and torch.equal(got, fn(a, plan, mod_idx).int())
    got = td.rns_polymul_lanes(a.int(), b.int(), plan, mod_idx)
    assert got.dtype == torch.int32
    assert torch.equal(got, td.rns_polymul_lanes(a, b, plan, mod_idx).int())
    assert sum(k.plain_calls for k in hr32.KERNELS) == 0


def test_u64_ladder_refuses_int32_lanes():
    ms = [tg.NTTParameters(12, PLUS, np.uint64,
                           factors=tg.NTTFactors(tg.Modulus64(q), *primes.root_pair(q, 12)))
          for q in primes.ntt_primes(59, 12, 2)]
    plan = tg.RNSMergePlan.from_params(ms, device="cpu")
    a = torch.zeros((2, plan.n), dtype=torch.int32)
    for call in (lambda: td.ntt_rns_lanes(a, plan, [0, 1]),
                 lambda: td.intt_rns_lanes(a, plan, [0, 1]),
                 lambda: td.rns_polymul_lanes(a, a, plan, [0, 1])):
        with pytest.raises(tg.NTTDispatchError):
            call()
    td.rns_polymul_lanes(a.long(), a.long(), plan, [0, 1])  # int64 lanes still taken
    with pytest.raises(tg.NTTDispatchError):  # and int32 refused on the route's hit too
        td.rns_polymul_lanes(a, a, plan, [0, 1])
    assert (tracing.COUNTERS["schedule.hit"], tracing.COUNTERS["schedule.miss"]) == (4, 1)


def test_wrappers_refuse_mixed_lanes():
    plan = ladder(12, PLUS, 2)
    midx = torch.tensor([1, 0], dtype=torch.int32)
    x = residues(plan, [1, 0], 7)
    with pytest.raises(tg.NTTDispatchError):
        hr32.rns_u32_polymul_inv(x, x.int(), plan, midx)
    with pytest.raises(tg.NTTDispatchError):
        td.rns_polymul_lanes(x.int(), x, plan, [1, 0])
    assert hr32.rns_u32_fwd(x.int(), plan, midx).dtype == torch.int32


@pytest.mark.parametrize("order", ["int32, int64", "int64, int32"])
@pytest.mark.parametrize("case", ["logn 7", "q above 2^30"])
def test_engine_route_refuses_mixed_lanes(case, order):
    plan = ladder(7, PLUS) if case == "logn 7" else ladder(12, MINUS, 2, bits=31)
    mod_idx = np.array([1, 0, 1])
    assert td._rns_kernel_path(plan, (3, plan.n)) == "engine"
    a = residues(plan, mod_idx, 9)
    ops = (a.int(), a) if order == "int32, int64" else (a, a.int())
    with pytest.raises(tg.NTTDispatchError):
        td.rns_polymul_lanes(*ops, plan, mod_idx)
    assert td.rns_polymul_lanes(a.int(), a.int(), plan, mod_idx).dtype == torch.int32


# ------------------------------------------- the benchmark's cell, cut down


@pytest.mark.parametrize("control", [False, True], ids=["sound", "control"])
def test_the_u32_cell_at_a_cpu_size(control):
    """he_n15_u32_polymul_stream cut to portbench's tiny size (logn 12,
    two primes, one ciphertext pair a call): a run of the port is
    correct, and the control's, whose float product the entry reads at
    float32, is not."""
    import time

    from portbench.control import Control
    from portbench.tests import tiny

    name = "he_n15_u32_polymul_stream"
    spec = tiny.spec(name)
    if control:
        spec["entry"] = Control(spec["entry"], spec["config"], spec["traffic"])
    rec = harness.execute(name, 2**31 + 29, 0.2, False, "cpu", time.perf_counter(), spec=spec)
    assert rec["correct"] is not control, rec["check"]
    assert rec["check"]["compared_calls"]["value"] >= 1 and rec["failed"] == 0
    if control:
        assert rec["check"]["mismatched_coefs"]["value"] > 0


# ------------------------------------------------------------------- spans


class _Stream:
    cuda_stream = 0


def test_word_attr_on_launch_spans(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for dtype in (torch.int32, torch.int64):
            kernel.launch(hr32.FORWARD["K16"], lambda *args: 0, torch.zeros(4, dtype=dtype))
    kernel.launch(hr32.FORWARD["K16"], lambda *args: 0, torch.zeros(4, dtype=torch.int32))
    spans = tracing.snapshot()["spans"]
    assert [s["attrs"] for s in spans] == [{"kernel": hr32.FORWARD["K16"].name, "word": w}
                                           for w in (4, 8)]
    assert hr32.FORWARD["K16"].launches == 3


def test_passes_attr_on_launch_spans(monkeypatch):
    """Given the split's log A, a launch span's `passes` attr is the
    passes over device memory a transform of the launch takes: 1 up to
    logn 15 (log A 0: a whole ring on chip), 2 above; a launch given no
    split carries no such attr."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    x = torch.zeros(4, dtype=torch.int32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for logn in (8, 13, 14, 15, 16, 25):
            kernel.launch(hr32.FORWARD["K16"], lambda *args: 0, x, log_a=hm32.split(logn))
        kernel.launch(hr32.FORWARD["K16"], lambda *args: 0, x)
    assert [s["attrs"].get("passes") for s in tracing.snapshot()["spans"]] == \
        [1, 1, 1, 1, 2, 2, None]


def test_one_pass_share_reads_the_calls_launch_spans():
    """portbench's one_pass_share: the percent of the calls' launch spans
    with passes 1, among those that carry the attr; None where none does
    (a program without the attr) or no call was traced (the plain
    versions on the host launch nothing)."""
    share = harness.module("metrics", "one_pass_share")

    def snap(*launches, calls=(0, 1)):
        return {"spans": [*({"name": "ntt.entry", "call": c, "attrs": {}} for c in calls),
                          *({"name": "ntt.launch", "call": c, "attrs": a} for c, a in launches)]}

    one, two = {"word": 4, "passes": 1}, {"word": 4, "passes": 2}
    assert share.of(snap((0, one), (0, one), (1, one))) == 100.0
    assert share.of(snap((0, one), (1, two), (1, {"word": 8}), (2, two))) == 50.0
    assert share.of(snap((0, {"word": 4}))) is None
    assert share.of(snap((0, one), calls=())) is None
    plan = ladder(12, PLUS, 2)
    a = residues(plan, [0, 1], 8).int()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        td.rns_polymul_lanes(a, a, plan, [0, 1])
    assert share.read({}) is None


def test_lanes_attr_on_the_rns_route_span():
    plan = ladder(12, PLUS, 2)
    a = residues(plan, [0, 1], 8)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for x in (a.int(), a, a.int()):
            td.rns_polymul_lanes(x, x, plan, [0, 1])
    routes = [s["attrs"] for s in tracing.snapshot()["spans"] if s["name"] == "ntt.route"]
    assert [(r["lanes"], r["schedule"], r["path"]) for r in routes] == [
        ("int32", "miss", "hopper-rns32"), ("int64", "hit", "hopper-rns32"),
        ("int32", "hit", "hopper-rns32")]
