"""The metric arithmetic on a synthetic trace: interval union, idle
share, the bandwidth share, launches a call, percentiles over all calls."""

from __future__ import annotations

import json

import pytest

from portbench import harness, trace

BENCH = harness.benchmark()


def read(name, rec):
    return harness.module("metrics", name).read(rec)


def test_union_merges_overlaps_and_keeps_gaps():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]


@pytest.mark.parametrize("raw, want", [
    ("void merge_u64::rows<15, true, (merge_u64::RowIn)1, (anonymous namespace)::Stacked>"
     "(long*, long const*, int)", "merge_u64::rows<15, true, (merge_u64::RowIn)1, Stacked>"),
    ("void fourstep::cols<unsigned long, false, merge_u64::OneModulus, 8>(long*)",
     "fourstep::cols<unsigned long, false, merge_u64::OneModulus, 8>"),
    ("void at::native::elementwise_kernel<128, 2>(int, at::native::Op)",
     "torch: elementwise_kernel"),
    ("Memcpy DtoD (Device -> Device)", "torch: Memcpy DtoD"),
])
def test_short_kernel_names(raw, want):
    assert trace.short(raw) == want


def _synthetic():
    # window 0..10 s; ops busy 1..3 (two overlapping kernels) and 6..8;
    # the host sits in pb.wait over the first gap and pb.entry over the last
    ops = [("void merge_u64::rows<16, (anonymous namespace)::Stacked>(long*)", 1.0, 2.5),
           ("void at::native::vectorized_elementwise_kernel<4>(int)", 2.0, 3.0),
           ("Memcpy DtoD (Device -> Device)", 6.0, 8.0)]
    spans = [("pb.window", 0.0, 10.0), ("pb.wait", 3.0, 6.0), ("pb.entry", 8.0, 10.0),
             ("pb.entry", 0.0, 0.4)]
    return {"ops": ops, "spans": spans, "window": (0.0, 10.0)}


def test_summarize_counts_busy_idle_and_labels_gaps():
    t = trace.summarize(_synthetic(), calls=4)
    assert t["window_s"] == 10.0 and t["busy_s"] == 4.0
    assert t["op_s"] == pytest.approx(4.5) and t["ops"] == 3
    assert dict(map(tuple, t["idle_gaps"])) == {"pb.wait": 3.0, "pb.entry": 2.0,
                                                 "harness": 1.0}
    names = dict(map(tuple, t["device_ops"]))
    assert names["merge_u64::rows<16, Stacked>"] == 1.5
    assert names["torch: vectorized_elementwise_kernel"] == 1.0


def test_read_chrome_trace(tmp_path):
    events = [{"ph": "X", "cat": "user_annotation", "name": "pb.window", "ts": 100, "dur": 50},
              {"ph": "X", "cat": "user_annotation", "name": "pb.entry", "ts": 101, "dur": 5},
              {"ph": "X", "cat": "user_annotation", "name": "aten::add", "ts": 102, "dur": 1},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 110, "dur": 45},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy", "ts": 105, "dur": 2},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 103, "dur": 1}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.read_chrome_trace(str(path))
    assert [n for n, _, _ in t["ops"]] == ["k", "Memcpy"]
    assert {n for n, _, _ in t["spans"]} == {"pb.window", "pb.entry"}
    assert t["window"] == pytest.approx((100e-6, 155e-6))  # the last kernel ends after the span


def test_device_metrics_on_the_synthetic_trace():
    rec = {"trace": trace.summarize(_synthetic(), calls=4), "bytes": 3.35e12}
    # 4 calls of 3.35 TB need 4 s at the peak; the ops took 4.5 s
    assert read("kernel_bw_share", rec) == pytest.approx(100 * 4 / 4.5)
    assert read("launches_per_call", rec) == pytest.approx(3 / 4)
    assert read("device_idle.stream", rec) == pytest.approx(60.0)
    assert read("device_idle.single", rec) == pytest.approx(60.0)


def test_device_metrics_read_nothing_without_device_ops():
    rec = {"trace": trace.summarize({"ops": [], "spans": [], "window": (0, 1)}, 3),
           "bytes": 8}
    for name in ("kernel_bw_share", "launches_per_call", "device_idle.stream"):
        assert read(name, rec) is None


def test_percentiles_are_over_all_calls():
    lat = [float(v) for v in range(1, 101)]  # 1..100 ms
    rec = {"latencies_ms": lat}
    assert read("latency_p50_ms", rec) == pytest.approx(50.5)
    assert read("latency_p95_ms", rec) == pytest.approx(95.05)


def test_throughput_and_host_time():
    rec = {"calls": 1000, "coefs": 2_000_000, "window_s": 10.0, "enqueue_s": 0.25,
           "setup_s": 7.0}
    assert read("throughput", rec) == pytest.approx(200.0)
    assert read("host_ms_per_call", rec) == pytest.approx(0.25)
    assert read("setup_s", rec) == 7.0
    assert read("throughput", dict(rec, latencies_ms=[1.0])) is None
