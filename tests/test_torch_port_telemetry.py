"""The telemetry layer of cylon_tpu_torch against cylon_tpu's on the CPU
(the JAX package's tests/test_telemetry.py, test_ledger.py,
test_observatory.py, test_obs.py, test_stats.py and test_adaptive_join.py
cover the same surfaces there):

* the same scripted counters, gauges, histograms and skew observations
  give equal ``snapshot()`` and ``prometheus_text()``;
* the same scripted span trees give equal JSONL traces (span ids, times
  and the per-span memory attributes masked: the CPU pools differ);
* ``SkewStats`` gives equal span attributes for the same count matrices;
* the same ledger events give equal leak reports and live bytes;
* head sampling decides the same for the same query ids;
* the statistics warehouse, fed the same query trees through the query
  log's root hook, gives the same ``effective_bytes``,
  ``join_input_bytes`` and ``node_skew``;
* after the same warm-up queries, the optimizer's broadcast and salting
  rewrites pick the same plans.
"""
import io
import json

import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu import plan as jplan
from cylon_tpu import telemetry as jtel
from cylon_tpu.service import plancache as jplancache

import cylon_tpu_torch as tct
from cylon_tpu_torch import plan as tplan
from cylon_tpu_torch import telemetry as ttel

TEL = {"jax": jtel, "torch": ttel}
MASK = ("span_id", "parent_id", "root_id", "elapsed_ms")


@pytest.fixture(scope="module")
def ctxs(request):
    return {"jax": {4: request.getfixturevalue("dist_ctx"),
                    0: request.getfixturevalue("local_ctx")},
            "torch": {4: tct.CylonContext.InitDistributed(
                tct.VirtualWorldConfig(4), device="cpu"),
                0: tct.CylonContext.Init(device="cpu")}}


@pytest.fixture
def clean_stats():
    def reset():
        for t in TEL.values():
            t.stats.reset()
            t.querylog.reset()
        jplancache.global_cache().clear()
    reset()
    yield
    reset()


def _script_metrics(tel):
    reg = tel.MetricsRegistry()
    reg.counter("cylon_shuffle_bytes_total").inc(4096)
    reg.counter("cylon_retries_total", {"site": "exchange"}).inc()
    reg.counter("cylon_retries_total", {"site": "exchange"}).inc(2)
    reg.gauge("cylon_hbm_live_bytes").set(123456)
    h = reg.histogram("cylon_phase_latency_ms", {"phase": "plan.join"})
    for v in (0.05, 0.7, 3.0, 42.0, 7000.0):
        h.observe(v)
    counts = np.array([[5, 1, 0, 2], [0, 9, 3, 1], [4, 4, 4, 4],
                       [0, 0, 30, 0]])
    tel.skew.SkewStats.from_counts(counts, 12).record(reg)
    quant = [h.quantile(q) for q in (0.0, 0.5, 0.95, 1.0)]
    return reg.snapshot(), tel.prometheus_text(reg), quant


def test_scripted_metrics_equal():
    j = _script_metrics(jtel)
    t = _script_metrics(ttel)
    assert t == j


def _script_spans(tel):
    buf = io.StringIO()
    pool = tel.get_memory_pool()
    tel.set_memory_pool(None)
    try:
        with tel.JsonlSpanSink(buf):
            with tel.root_attrs(tenant="acme", query_id=7):
                with tel.span("plan.query", plan_fp="abc") as root:
                    with tel.span("plan.scan", 1, rows_in=10, world=4):
                        pass
                    with tel.phase("join.plan", 2):
                        tel.annotate(rows_out=5)
                    try:
                        with tel.span("shuffle.exchange", 3, mode="padded",
                                      rows=8, bytes_moved=64):
                            raise ValueError("boom")
                    except ValueError:
                        pass
    finally:
        tel.set_memory_pool(pool)
    lines = []
    for line in buf.getvalue().splitlines():
        d = json.loads(line)
        for k in MASK:
            d.pop(k)
        if tel is ttel:
            # the port's host stamps on torch.profiler's clock, which the
            # JAX package's records do not carry
            start, end = d.pop("start_ns"), d.pop("end_ns")
            assert 0 < start <= end
        lines.append(d)
    return lines, root.label, [s.name for s in root.walk_postorder()]


def test_scripted_span_json_equal():
    j = _script_spans(jtel)
    t = _script_spans(ttel)
    assert t == j
    assert [d["name"] for d in t[0]] == ["plan.scan", "join.plan",
                                         "shuffle.exchange", "plan.query"]
    assert t[0][2]["error"] is True


@pytest.mark.parametrize("world", [2, 4, 16, 32])
def test_skew_span_attrs_equal(world):
    rng = np.random.default_rng(world)
    counts = rng.integers(0, 1000, (world, world))
    counts[:, 1] *= 7
    a = jtel.skew.SkewStats.from_counts(counts, 20).span_attrs()
    b = ttel.skew.SkewStats.from_counts(counts, 20).span_attrs()
    assert a == b
    assert (jtel.skew.SkewStats.from_counts(counts[:1, :1]) is None
            and ttel.skew.SkewStats.from_counts(counts[:1, :1]) is None)


def _ledger_events(P, tel, ctx):
    tel.ledger.reset()
    mk = lambda n: P.Table.from_pydict(ctx, {  # noqa: E731
        "a": np.arange(n, dtype=np.int32),
        "b": np.linspace(0, 1, n)})
    keep = []
    with tel.span("plan.query") as root:
        with tel.span("plan.scan"):
            user = tel.ledger.track(mk(64), "scripted.scan", borrowed=True)
        with tel.span("plan.join"):
            leaked = tel.ledger.track(mk(128), "scripted.join")
        with tel.span("plan.project"):
            view = tel.ledger.track(leaked.project([0]), "scripted.project")
        freed = tel.ledger.track(mk(32), "scripted.freed")
        freed.clear()
        freed.clear()  # idempotent
        keep += [user, leaked, view]
    rep = [{k: v for k, v in e.items() if k not in ("event_id", "age_s",
                                                   "root_id")}
           for e in tel.ledger.leak_report(root.span_id)]
    gauges = {o: tel.metrics_snapshot().get(
        f'cylon_live_table_bytes{{owner="{o}"}}')
        for o in ("scripted.scan", "scripted.join", "scripted.project",
                  "scripted.freed")}
    live = tel.ledger.live_bytes()
    tel.ledger.reset()
    return rep, gauges, live


def test_ledger_leak_reports_equal(ctxs):
    j = _ledger_events(jct, jtel, ctxs["jax"][0])
    t = _ledger_events(tct, ttel, ctxs["torch"][0])
    assert t == j
    rep, gauges, live = t
    assert [e["owner"] for e in rep] == ["scripted.join", "scripted.project"]
    # the project view shares the join output's buffer: counted once
    assert live == 64 * 12 + 128 * 12
    assert gauges["scripted.freed"] == 0


@pytest.mark.parametrize("rate", [0.0, 0.01, 0.25, 0.5, 0.99, 1.0])
def test_head_sampling_same_decisions(rate):
    keys = list(range(500)) + [f"q-{i}" for i in range(100)]
    a = [jtel.sampling.decide(k, rate) for k in keys]
    b = [ttel.sampling.decide(k, rate) for k in keys]
    assert a == b
    assert [jtel.sampling.fraction(k) for k in keys[:50]] == \
        [ttel.sampling.fraction(k) for k in keys[:50]]


def test_root_sampling_from_knob(monkeypatch):
    monkeypatch.setenv("CYLON_TRACE_SAMPLE_RATE", "0.5")
    got = {}
    for k, tel in TEL.items():
        flags = []
        for qid in range(40):
            with tel.root_attrs(query_id=qid):
                with tel.span("plan.query") as s:
                    pass
            flags.append(s.sampled)
        got[k] = flags
    assert got["torch"] == got["jax"] and 0 < sum(got["torch"]) < 40


def _feed_warehouse(tel):
    """Three scripted query trees through the query log's root hook; the
    adaptive epoch as its change (it is monotonic over the process:
    stats.reset() bumps it)."""
    epoch0 = tel.stats.epoch()
    for i in range(3):
        with tel.span("plan.query", plan_fp="fp-query"):
            with tel.span("plan.shuffle.join", stats_fp="fp-join",
                          stats_kind="join", est_bytes=1 << 20,
                          bytes_out=40000 + 1000 * i, rows_out=5000,
                          stats_decision_fp="fp-join-decision",
                          left_in_bytes=1 << 18,
                          right_in_bytes=2048 + 64 * i):
                pass
            with tel.span("plan.shuffle.explicit", stats_fp="fp-shuffle",
                          stats_kind="shuffle", est_bytes=1 << 16,
                          bytes_out=30000, rows_out=4000,
                          stats_decision_fp="fp-shuffle-decision",
                          skew_max=3.5 + i):
                pass
    st = tel.stats
    return (st.effective_bytes("fp-join", 1 << 20),
            st.effective_bytes("fp-shuffle", 1 << 16),
            st.effective_bytes("fp-unknown", 999),
            st.join_input_bytes("fp-join-decision"),
            st.node_skew("fp-shuffle-decision"),
            st.node_obs("fp-join"), st.epoch() - epoch0)


def test_warehouse_fed_through_querylog_hook(clean_stats, monkeypatch):
    monkeypatch.setenv("CYLON_STATS_MIN_OBS", "2")
    j = _feed_warehouse(jtel)
    t = _feed_warehouse(ttel)
    assert t == j
    assert t[0][1] == "measured" and t[2] == (999, "static")
    assert ttel.querylog.recent()[-1]["plan_fp"] == "fp-query"


def _broadcast_tables(P, ctx):
    rng = np.random.default_rng(20)
    left = P.Table.from_pydict(ctx, {
        "k": rng.integers(0, 64, 1 << 13).astype(np.int32),
        "v": rng.normal(size=1 << 13).astype(np.float32)})
    right = P.Table.from_pydict(ctx, {
        "k": rng.integers(0, 64, 16).astype(np.int32),
        "w": rng.normal(size=16).astype(np.float32)})
    return left, right


def test_adaptive_broadcast_rewrite_same_plan(ctxs, clean_stats,
                                              monkeypatch):
    monkeypatch.setenv("CYLON_STATS_MIN_OBS", "2")
    got = {}
    for k, (P, plan) in {"jax": (jct, jplan), "torch": (tct, tplan)}.items():
        left, right = _broadcast_tables(P, ctxs[k][4])

        def pipe():
            return plan.scan(left).join(plan.scan(right), on="k")
        texts = [pipe().explain()]
        rows = []
        for _ in range(3):
            rows.append(sorted(map(tuple, np.stack(
                [np.asarray(v, np.float64)
                 for v in pipe().execute().to_pydict().values()], 1))))
            texts.append(pipe().explain())
        assert all(r == rows[0] for r in rows)
        got[k] = (texts, rows[0])
    assert got["torch"] == got["jax"]
    assert "algo=broadcast" in got["torch"][0][-1]
    assert "algo=broadcast" not in got["torch"][0][0]


def test_adaptive_salting_rewrite_same_plan(ctxs, clean_stats, monkeypatch):
    monkeypatch.setenv("CYLON_STATS_MIN_OBS", "2")
    got = {}
    for k, (P, plan) in {"jax": (jct, jplan), "torch": (tct, tplan)}.items():
        rng = np.random.default_rng(29)
        n = 4096
        key = np.where(rng.random(n) < 0.7, 7,
                       rng.integers(0, 1000, n)).astype(np.int32)
        src = P.Table.from_pydict(ctxs[k][4], {
            "k": key, "v": np.arange(n, dtype=np.float32)})

        def pipe():
            return plan.scan(src).shuffle(["k"])
        texts = []
        for _ in range(2):
            pipe().execute()
            texts.append(pipe().explain())
        p = pipe()
        analyzed = p.explain(analyze=True)
        salted = p.last_report.root.salted
        got[k] = (texts, salted, ", salted" in analyzed)
    assert got["torch"] == got["jax"]
    assert ", salted" in got["torch"][0][-1] and got["torch"][1]
