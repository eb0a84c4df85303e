"""The stage spans of the port's world-1 join and group-by, their device
time and their host stamps, on the CPU.

* A world-1 inner join on an int64 key (the hash-stream route, forced on
  the CPU, where the kernel wrappers run their plain versions) and a
  world-1 sum group-by open exactly their stage spans, nested and in
  order, and fetch from the device once each (``cylon_host_syncs_total``).
* With no profiler running, a span records no CUDA event and leaves the
  ``cylon_span_*`` counters alone; under a profiler, the event pool is
  reused and the counters fold each span's event pair (fake events stand
  in for the card's, whose own test is in test_torch_port_gpu.py).
* ``span_device_times()`` on the CPU is ``{}``.
* The JSONL export's ``start_ns``/``end_ns`` sit on torch.profiler's
  clock: within 50 us of the span's ``record_function`` range.
"""
import io
import json
import re
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cylon_tpu_torch as ct
from cylon_tpu_torch import telemetry as tel
from cylon_tpu_torch.ops import join as J
from cylon_tpu_torch.telemetry import metrics as tmetrics
from cylon_tpu_torch.telemetry import spans as tspans

N = 4096
JOIN_TREE = ("join", [("join.prepare", []),
                      ("join.plan", [("join.plan.hash", []),
                                     ("join.plan.sort", []),
                                     ("join.plan.stream", [])]),
                      ("join.materialize", []),
                      ("join.rebuild", [])])
GROUPBY_TREE = ("groupby", [(s, []) for s in (
    "groupby.keys", "groupby.sort", "groupby.gather", "groupby.aggregate",
    "groupby.rebuild")])


@pytest.fixture
def ctx():
    return ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(1),
                                           device="cpu")


@pytest.fixture
def hash_stream(monkeypatch):
    monkeypatch.setattr(J, "STREAM_PLAN", True)


def _tables(ctx):
    rng = np.random.default_rng(20)
    return [ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, N, N).astype(np.int64), c: rng.random(N)})
        for c in ("v", "w")]


def _join(ctx):
    left, right = _tables(ctx)
    return left.distributed_join(right, "inner", on="k")


def _groupby(ctx):
    left, _right = _tables(ctx)
    return left.groupby("k", ["v"], ["sum"])


OPS = {"join": (_join, JOIN_TREE, "join.plan"),
       "groupby": (_groupby, GROUPBY_TREE, "groupby.count")}


def _tree(s):
    return (s.name, [_tree(c) for c in s.children])


def _flat(tree):
    name, children = tree
    return [name] + [n for c in children for n in _flat(c)]


def _syncs():
    return {k: v for k, v in tel.metrics_snapshot().items()
            if k.startswith("cylon_host_syncs_total")}


@pytest.mark.parametrize("op", sorted(OPS))
def test_world1_op_opens_its_stage_spans_in_order(ctx, hash_stream, op):
    run, tree, _site = OPS[op]
    with tel.collect_phases() as cp:
        out = run(ctx)
    assert out.row_count > 0
    assert [re.sub(r"#\d+$", "", x) for x in cp.labels] == _flat(tree)
    assert _tree(cp.spans[0]) == tree


@pytest.mark.parametrize("op", sorted(OPS))
def test_world1_op_counts_one_host_sync(ctx, hash_stream, op):
    run, _tree_, site = OPS[op]
    before = _syncs()
    run(ctx)
    after = _syncs()
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    assert delta == {f'cylon_host_syncs_total{{site="{site}"}}': 1}


class _CountingTimer:
    def __init__(self):
        self.calls = 0

    def start(self):
        self.calls += 1
        return (0, None)

    def stop(self, name, start):
        self.calls += 1


@pytest.fixture
def on_cuda(monkeypatch):
    """The span layer as it runs on a CUDA machine: NVTX ranges are
    pushed (no-ops here) and spans may time themselves."""
    monkeypatch.setattr(tspans, "_nvtx", True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda label: 0)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: 0)


def _span_series():
    return {k: v for k, v in tel.metrics_snapshot().items()
            if k.startswith("cylon_span_")}


def test_no_profiler_no_device_event(ctx, hash_stream, on_cuda,
                                     monkeypatch):
    timer = _CountingTimer()
    monkeypatch.setattr(tspans, "_timer", timer)
    before = _span_series()
    with tel.span("probe.stage"):
        pass
    _join(ctx)
    _groupby(ctx)
    assert timer.calls == 0
    assert _span_series() == before
    # the same spans under a profiler: one start and one stop a span
    with tel.collect_phases() as cp:
        with profile(activities=[ProfilerActivity.CPU]):
            _join(ctx)
    assert timer.calls == 2 * len(cp.labels)


class _FakeEvent:
    """A timing event whose record() reads a fake device clock."""
    made = 0
    clock = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.clock[0] += 1.5
        self.t = self.clock[0]

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.t - self.t


def test_span_times_fold_from_a_reused_event_pool(on_cuda, monkeypatch):
    monkeypatch.setattr(tmetrics, "REGISTRY", tmetrics.MetricsRegistry())
    monkeypatch.setattr(tspans, "_timer", tspans._DeviceTimer())
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _FakeEvent.made = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(10):
            with tel.span("probe.outer"):
                with tel.span("probe.inner"):
                    pass
    # enter outer, enter inner, exit inner, exit outer: 1.5 per record
    assert tel.span_device_times() == {"probe.outer": (45.0, 10),
                                       "probe.inner": (15.0, 10)}
    # three events in flight at most: the inner pair goes back to the
    # pool before the outer span closes
    assert _FakeEvent.made == 3
    snap = tel.metrics_snapshot()
    assert snap['cylon_span_timed_total{span="probe.inner"}'] == 10
    assert snap['cylon_span_device_ms_total{span="probe.outer"}'] == 45.0


def test_span_device_times_on_the_cpu_is_empty(ctx, hash_stream):
    with profile(activities=[ProfilerActivity.CPU]):
        _join(ctx)
        _groupby(ctx)
    assert tel.span_device_times() == {}


def test_jsonl_stamps_on_the_profiler_clock():
    buf = io.StringIO()
    with tel.JsonlSpanSink(buf):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tel.span("probe.warm"):
                pass
            for i in range(9):
                with tel.span("probe.clock", i):
                    torch.ones(1000).sum()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = {e.name: e.time_range for e in prof.events()
              if e.name.startswith("cylon:probe.clock")}
    diffs = []
    for line in buf.getvalue().splitlines():
        d = json.loads(line)
        if d["name"] != "probe.clock":
            continue
        r = ranges[f"cylon:probe.clock#{d['seq']}"]
        assert d["start_ns"] <= d["end_ns"]
        diffs += [abs(d["start_ns"] - (t0 + r.start * 1e3)),
                  abs(d["end_ns"] - (t0 + r.end * 1e3))]
    assert len(diffs) == 18
    assert statistics.median(diffs) < 50e3, diffs
