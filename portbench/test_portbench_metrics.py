"""The metric arithmetic on synthetic times and traces."""
from types import SimpleNamespace

import pytest

from portbench import harness, roofline, stats, testing, trace
from portbench.e2e import input_rows_per_s, query_p90_ms


def test_p90_from_raw_times():
    xs = [float(i) for i in range(1, 101)]
    assert stats.percentile(xs, 90) == 90.0
    assert stats.percentile([5.0, 1.0, 3.0], 90) == 5.0
    assert stats.percentile([2.0], 90) == 2.0
    r = SimpleNamespace(latencies=[0.1] * 9 + [0.5])
    assert query_p90_ms.read(r) == pytest.approx(100.0)


def test_rate_over_the_window():
    r = SimpleNamespace(rows_per_query=2 * 10 ** 8, queries=30,
                        window_s=12.0)
    assert input_rows_per_s.read(r) == pytest.approx(5e8)
    assert input_rows_per_s.read(SimpleNamespace(
        rows_per_query=1, queries=0, window_s=1.0)) is None


def synthetic():
    # window 0-100 us; device busy 10-30, 20-40 (overlap), 60-70, and a
    # kernel straddling the window's end
    dev = [("(anonymous namespace)::plan_stream(unsigned int const*)", 10,
            30),
           ("void cub::DeviceRadixSortOnesweepKernel<x>", 20, 40),
           ("Memcpy DtoH (Device -> Pageable)", 60, 70),
           ("(anonymous namespace)::join_expand(int const*)", 95, 120)]
    rt = [("cudaLaunchKernel", 9, 10), ("cudaStreamSynchronize", 41, 59),
          ("cudaDeviceSynchronize", 96, 99), ("cudaMemcpyAsync", 59, 60)]
    host = [("cylon:join.plan#3", 0, 60), ("aten::item", 40, 60),
            ("portbench:query", 0, 5),
            ("aten::sort", 70, 95), ("portbench:window", 0, 100)]
    return trace.Trace((0.0, 100.0), dev, rt, host)


def test_union_busy_and_gaps():
    tr = synthetic()
    assert trace.busy_s(tr) == pytest.approx(45e-6)
    g = trace.gaps(tr)
    assert g[0] == (70, 95) and sorted(g) == [(0, 10), (40, 60), (70, 95)]
    assert sum(b - a for a, b in g) / 1e6 + trace.busy_s(tr) == \
        pytest.approx(tr.window_s)


def test_device_seconds_by_pattern():
    tr = synthetic()
    assert trace.device_seconds(tr, [r"(^|[\s:])plan_stream\("]) == \
        pytest.approx(20e-6)
    assert trace.device_seconds(tr, [r"RadixSort"]) == pytest.approx(20e-6)
    assert trace.device_seconds(tr) == pytest.approx(55e-6)
    assert trace.device_seconds(tr, None, exclude=[r"RadixSort"]) == \
        pytest.approx(35e-6)


def test_sync_calls_and_gap_owners():
    tr = synthetic()
    assert trace.sync_calls(tr) == 2
    owners = dict(trace.gap_owners(tr))
    assert owners["aten::sort"] == pytest.approx(25e-6)
    assert owners["cylon:join.plan > cudaStreamSynchronize"] == \
        pytest.approx(20e-6)
    assert owners["cylon:join.plan > host, in a query"] == \
        pytest.approx(10e-6)
    top = trace.top_device_ops(tr)
    assert top[0][1] == pytest.approx(20e-6) and len(top) == 4


def reading(tr, stats_, queries=1):
    return harness.Reading(queries, tr.window_s, [], 0.0, 0, 3 * 2 ** 30,
                           stats_,
                           harness.load_json(harness.HERE / "peaks.json"),
                           tr, harness.roofline_modules(),
                           harness.kernel_symbols())


def join_stats():
    return {"op": "join", "query": {"op": "join", "left": "l", "right": "r",
                                    "on": "k"},
            "tables": {"l": {"rows": 1000, "columns": {"k": 8, "v": 8},
                             "float_columns": ["v"]},
                       "r": {"rows": 1000, "columns": {"k": 8, "w": 8},
                             "float_columns": ["w"]}},
            "left_matched": 600, "right_matched": 600, "out_rows": 1000,
            "query_bytes": 64000}


def test_readers_on_a_synthetic_trace():
    r = reading(synthetic(), join_stats())
    m = {n: harness.load_module(harness.HERE / "metrics" / f"{n}.py").read(r)
         for n in ("device_idle_pct", "peak_device_gib", "kernel_ms",
                   "sort_ms", "torch_op_ms", "host_syncs_per_query",
                   "kernel_roofline_pct", "join_plan_stream_roofline",
                   "join_expand_stream_roofline", "segment_sum_roofline",
                   "query_roofline_pct")}
    assert m["device_idle_pct"] == pytest.approx(55.0)
    assert m["peak_device_gib"] == pytest.approx(3.0)
    assert m["kernel_ms"] == pytest.approx(0.025)
    assert m["sort_ms"] == pytest.approx(0.020)
    assert m["torch_op_ms"] == pytest.approx(0.010)
    assert m["host_syncs_per_query"] == 1.0
    k3 = (2000 * 12 + 4 * 1200) / 3.35e12
    k4 = (4 * 1200 + 8 * 1000) / 3.35e12
    assert m["join_plan_stream_roofline"] == pytest.approx(100 * k3 / 20e-6)
    assert m["join_expand_stream_roofline"] == pytest.approx(
        100 * k4 / 5e-6)
    assert m["kernel_roofline_pct"] == pytest.approx(
        100 * (k3 + k4) / 25e-6)
    assert m["segment_sum_roofline"] is None
    assert m["query_roofline_pct"] == pytest.approx(
        100 * 64000 / 3.35e12 / 100e-6)


def test_readers_return_nothing_without_a_trace():
    r = reading(trace.Trace((0.0, 100.0)), join_stats())
    for n in ("device_idle_pct", "kernel_ms", "kernel_roofline_pct",
              "query_roofline_pct", "host_syncs_per_query", "sort_ms"):
        mod = harness.load_module(harness.HERE / "metrics" / f"{n}.py")
        assert mod.read(r) is None, n


def test_a_new_kernel_brings_its_symbols_in_its_roofline_file(tmp_path):
    root = testing.tiny_checkout(tmp_path / "c", program=False) / \
        "portbench"
    (root / "rooflines" / "toy_kernel.py").write_text(
        'SYMBOLS = (r"toy_kernel\\(",)\n\n\n'
        'def stage_bytes(stats):\n    return 1000\n')
    got = harness.kernel_symbols(root)
    assert got["toy_kernel"] == [r"toy_kernel\("]
    assert got["segment_sum"] == harness.kernel_symbols()["segment_sum"]
    tr = trace.Trace((0.0, 100.0), [("toy_kernel(int)", 10, 20)])
    r = harness.Reading(1, tr.window_s, [], 0.0, 0, 0, {"op": "toy"},
                        harness.load_json(root / "peaks.json"), tr,
                        harness.roofline_modules(root), got)
    least, spent = roofline.kernel_times(r, "toy_kernel")
    assert spent == pytest.approx(10e-6)
    assert least == pytest.approx(1000 / 3.35e12)
