"""EXPLAIN ANALYZE and the executor's guards of cylon_tpu_torch against
cylon_tpu's on the CPU (the JAX package's tests/test_plan.py EXPLAIN
ANALYZE cases, tests/test_ledger.py's pre-flight and leak checks and
tests/test_resilience.py's admission, deadline and fault drills):

* ``report.preflight_estimates`` bytes and rows per node are equal (the
  widths check: the port's type strings are numpy dtype names, so
  ``np.dtype`` reads them as the reference's);
* ``PlanReport.to_dict()``: every node's rows, bytes, estimates,
  exchanges, skew, retries and span names, and ``shuffle_count``;
* admission with a clamped budget: the same shed (both raise
  ``CylonResourceExhausted`` before any exchange) and the same degrade
  ``probe_block_rows`` map, whose blocked join equals the reference's;
* ``CYLON_QUERY_DEADLINE_S`` raises ``CylonTimeoutError`` in both;
* an injected ``exchange`` fault is retried to the same ``retries``;
* the leak report of a clean query is empty;
* ``partition_signature`` spells each fixed-width dtype as the
  reference does (numpy names).
"""
import re

import numpy as np
import pytest

import cylon_tpu as jct
from cylon_tpu.parallel import shard as jshard
from cylon_tpu.plan import report as jreport
from cylon_tpu.resilience import inject as jinject

import cylon_tpu_torch as tct
from cylon_tpu_torch.parallel import shard as tshard
from cylon_tpu_torch.plan import report as treport
from cylon_tpu_torch.resilience import inject as tinject

from test_torch_port_plan import (CASES, LABEL_PREFIXES, _pkgs, _rows,
                                   make_tables)
# the autouse module fixture that resets both statistics warehouses
from test_torch_port_plan import _forget_learned_statistics  # noqa: F401

REPORT = {"jax": jreport, "torch": treport}
INJECT = {"jax": jinject, "torch": tinject}
NODE_KEYS = ("kind", "desc", "partitioned_by", "executed", "rows", "bytes",
             "est_bytes", "calibrated_bytes", "est_source", "mem_warn",
             "retries", "partition_path", "join_algorithm", "salted",
             "shuffles", "skew")


@pytest.fixture(scope="module")
def pkgs(request):
    return _pkgs(request)


def _pipeline(P):
    l, r = make_tables(P, P.ctx[4])
    return P.plan.scan(l).join(P.plan.scan(r), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"])


def _nodes(d):
    """Pre-order node records of a report dict, with the node's own span
    names filtered as test_torch_port_plan filters them (``#seq``
    dropped)."""
    out = [{k: d[k] for k in NODE_KEYS}]
    out[0]["labels"] = [re.sub(r"#\d+$", "", x) for x in d["labels"]
                        if x.startswith(LABEL_PREFIXES)]
    for c in d["children"]:
        out.extend(_nodes(c))
    return out


@pytest.mark.parametrize("name", [n for n in CASES if n not in (
    "table_api_roundtrip", "registry_rebind")])
def test_preflight_estimates_equal(pkgs, name):
    got = {}
    for k, P in pkgs.items():
        pipe, _kw, _run = CASES[name](P, P.ctx[4], False)
        root, _stats = pipe.optimized()
        est = REPORT[k].preflight_estimates(root)
        got[k] = [(n.kind, est[id(n)]["rows"], est[id(n)]["bytes"])
                  for n in P.ir.walk(root)]
    assert got["torch"] == got["jax"]


@pytest.fixture(scope="module")
def analyzed(pkgs):
    out = {}
    for k, P in pkgs.items():
        pipe = _pipeline(P)
        text = pipe.explain(analyze=True)
        out[k] = (pipe.last_report, text, _rows(pipe.execute()))
    return out


def test_report_nodes_equal(analyzed):
    jd = analyzed["jax"][0].to_dict()
    td = analyzed["torch"][0].to_dict()
    assert _nodes(td["plan"]) == _nodes(jd["plan"])
    assert td["shuffle_count"] == jd["shuffle_count"] == 1
    assert td["world"] == jd["world"] == 4
    assert td["optimizer"] == jd["optimizer"]
    assert td["admission"] == jd["admission"]


def test_report_measures_live_rows(analyzed):
    """Every executed node's rows are its output's live rows; the root's
    are the result's."""
    rep, text, rows = analyzed["torch"]
    assert rep.root.rows == len(rows)
    assert "actual time=" in text and "-- measured:" in text
    assert rep.span.name == "plan.query"
    assert rep.memory  # sampled from the context's pool


def test_clean_query_has_no_leaks(analyzed):
    assert analyzed["torch"][0].leaks == []
    assert analyzed["jax"][0].leaks == []


def _shuffle_spans(cp):
    return [x for x in cp.labels if x.startswith("shuffle.")]


def test_admission_shed_before_device_work(pkgs, monkeypatch):
    """A stubbed 4 KiB comm budget sheds the world-4 pipeline in both
    packages before any exchange runs, with the same decision."""
    decisions = {}
    for k, P in pkgs.items():
        monkeypatch.setattr(P.ctx[4].memory_pool, "comm_budget_bytes",
                            lambda: 4096)
        pipe = _pipeline(P)
        with P.tel.collect_phases() as cp:
            with pytest.raises(P.ct.CylonResourceExhausted,
                               match="shed by admission"):
                pipe.execute()
        decisions[k] = P.tel.flight.admissions()[-1]
        assert _shuffle_spans(cp) == [], (k, cp.labels)
        assert any(x.startswith("plan.admission") for x in cp.labels)
    assert decisions["torch"] == decisions["jax"]
    assert decisions["torch"]["action"] == "shed"


def test_admission_degrade_block_map(pkgs):
    """A 32 KiB budget degrades the world-1 join to the blocked local
    join with the same probe_block_rows in both packages; the blocked
    result equals the reference's."""
    got = {}
    for k, P in pkgs.items():
        l, r = make_tables(P, P.ctx[0], seed=41)
        pipe = P.plan.scan(l).join(P.plan.scan(r), on="k")
        INJECT[k].arm("pool:32768:oom")
        try:
            res = pipe.execute(analyze=True)
        finally:
            INJECT[k].disarm()
        rep = pipe.last_report
        join = next(s for s in rep.span.walk()
                    if s.name in ("plan.join", "plan.shuffle.join"))
        got[k] = (rep.admission["action"], join.attrs.get("mode"),
                  join.attrs.get("probe_block_rows"), _rows(res))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == "degrade" and got["torch"][1] == "blocked"


def test_deadline_raises_timeout(pkgs, monkeypatch):
    monkeypatch.setenv("CYLON_QUERY_DEADLINE_S", "0.000001")
    for k, P in pkgs.items():
        pipe = _pipeline(P)
        with pytest.raises(P.ct.CylonTimeoutError, match="deadline"):
            pipe.execute()


def test_injected_exchange_fault_retried(pkgs, monkeypatch):
    """``exchange:1:transient``: the first exchange launch fails, the
    retry recovers, the join node reports retries=1 in both, and the
    result equals the fault-free one."""
    monkeypatch.setenv("CYLON_RETRY_BACKOFF_S", "0")
    got = {}
    for k, P in pkgs.items():
        before = P.tel.metrics_snapshot().get(
            'cylon_retries_total{site="exchange"}', 0)
        pipe = _pipeline(P)
        INJECT[k].arm("exchange:1:transient")
        try:
            pipe.explain(analyze=True)
        finally:
            INJECT[k].disarm()
        rep = pipe.last_report
        after = P.tel.metrics_snapshot()['cylon_retries_total{site="exchange"}']
        retries = [n["retries"] for n in _nodes(rep.to_dict()["plan"])]
        got[k] = (retries, after - before, _rows(pipe.execute()))
    assert got["torch"] == got["jax"]
    assert sum(got["torch"][0]) == 1 and got["torch"][1] == 1


# every fixed-width dtype both packages hold as a column
SIG_DTYPES = ["bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
              "int64", "uint64", "float32", "float64"]


@pytest.mark.parametrize("dtype", SIG_DTYPES)
def test_partition_signature_numpy_names(pkgs, dtype):
    """The co-partitioning witness spells the key dtypes by their numpy
    names in both packages (the port once stored ``str(torch.dtype)``,
    "torch.int32", which no plan type string equals)."""
    x = (np.arange(12) % 2).astype(dtype)
    sigs = {}
    for k, P in pkgs.items():
        t = P.ct.Table.from_pydict(P.ctx[4], {"a": x, "b": x})
        mod = tshard if k == "torch" else jshard
        sigs[k] = mod.partition_signature(
            [t._columns[1], t._columns[0]], (1, 0), 4)
    assert sigs["torch"] == sigs["jax"] == ((1, 0), (dtype, dtype), 4)


@pytest.mark.parametrize("world", [0, 4])
def test_f18_statistics_record_capacity_as_the_reference(pkgs, world):
    """F18 (a reference behaviour, pinned and left alone): the executor's
    statistics feed records each node's output capacity as ``rows_out``
    and ``Table.nbytes`` as ``bytes_out``, not its live rows, in both
    packages (the port's plan/executor.py ``_stamp_stats``, as
    cylon_tpu/plan/executor.py's). The same 8,192-row planned join with 64
    matches records the same ``rows_out`` and ``bytes_out`` in both."""
    n = 1 << 13
    got = {}
    for k, P in pkgs.items():
        ctx = P.ctx[world]
        left = P.ct.Table.from_pydict(ctx, {
            "k": np.arange(n, dtype=np.int32),
            "v": np.arange(n, dtype=np.float32)})
        right = P.ct.Table.from_pydict(ctx, {
            "k": np.arange(n, dtype=np.int32) + n - 64,
            "w": np.arange(n, dtype=np.int64)})
        seen = []

        def sink(s, seen=seen):
            if "rows_out" in s.attrs and "stats_kind" in s.attrs:
                seen.append((s.attrs["stats_kind"], s.attrs["rows_out"],
                             s.attrs["bytes_out"]))

        P.tel.add_sink(sink)
        try:
            out = P.plan.scan(left).join(P.plan.scan(right),
                                         on="k").execute()
        finally:
            P.tel.remove_sink(sink)
        got[k] = (sorted(seen), out.row_count, out.capacity)
    assert got["torch"] == got["jax"]
    seen, live, capacity = got["torch"]
    assert live == 64
    # the join's rows_out is its output's capacity (its live rows on the
    # CPU's plan route at world 1; a whole expansion block on the card's
    # stream route)
    assert [r for kind, r, _b in seen if kind == "join"] == [capacity]
