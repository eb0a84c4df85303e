"""The union cell on the CPU at a tiny size: the plain reference against
a brute-force set of rows and against the port on both of its routes
(the stream route forced on, where K5 and K6 run their plain versions,
and dense ranks); planted faults coming out not correct; the cell run
whole, untraced and traced; and the new readers' arithmetic on a
fabricated reading."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import cylon_tpu_torch as ct
import cylon_tpu_torch.telemetry as telemetry
from cylon_tpu_torch.ops import setops
from portbench import (check, control, gen, harness, queries, reference,
                       testing, trace)

HERE = Path(__file__).resolve().parent
CELL = "cylon_union_200m.union"
SEEDS = [2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303]
ROUTES = {"stream": True, "dense": False}


def wl():
    return json.loads((HERE / "workloads" / f"{CELL}.json").read_text())


def tiny(rows, key_values=None):
    cfg = testing.shrink(json.loads(
        (HERE / "configs" / "cylon_union_200m.json").read_text()), rows)
    if key_values:
        for t in cfg["tables"].values():
            t["columns"]["k"]["high"] = key_values
    return cfg


def with_repeats(tables, neg_zero=True):
    """The drawn tables with repeated rows planted: the right table's
    first quarter copies the left's, the left's second quarter repeats
    its first, every tenth left payload is 0.0 and every twentieth right
    one -0.0 (+0.0 where ``neg_zero`` is False: the dense-ranks route
    keeps a first row's own bits, -0.0 too, where the stream route and
    the reference give +0.0; the cell's payloads have no -0.0)."""
    (kl, l), (vl, lv) = tables["left"]
    (kr, r), (vr, rv) = tables["right"]
    q = len(l) // 4
    r[:q], rv[:q] = l[:q], lv[:q]
    l[q:2 * q], lv[q:2 * q] = l[:q], lv[:q]
    lv[::10] = 0.0
    rv[::20] = -0.0 if neg_zero else 0.0
    return tables


def brute_force(tables):
    rows = set()
    for side in ("left", "right"):
        (_k, k), (_v, v) = tables[side]
        rows |= set(zip(k.tolist(), (v + 0.0).tolist()))
    return rows


def as_rows(cols):
    return sorted(zip(cols[0].tolist(), cols[1].tolist()))


def port_union(t, route, monkeypatch):
    monkeypatch.setattr(setops, "STREAM_SETOP", ROUTES[route])
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(1),
                                          device="cpu")
    tables = harness.ingest(ct, ctx, t, 1)
    return harness.live_columns(queries.module("union").run(tables,
                                                            wl()["query"]))


def test_reference_against_brute_force():
    t = with_repeats(gen.make_tables(tiny(4000, 300), 31, "cpu"))
    cols, scales, stats = reference.module("union").compute(t, wl()["query"])
    want = brute_force(t)
    got = as_rows(cols)
    assert got == sorted(want) and stats["out_rows"] == len(want)
    assert len(want) < 8000 - 1000
    assert scales == [None, None]
    # -0.0 comes out as +0.0, its bits those of 0.0
    v = cols[1][cols[1] == 0]
    assert len(v) and not torch.signbit(v).any()
    assert stats["query_bytes"] == 8000 * 16 + len(want) * 16


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_port_agrees_with_the_reference(monkeypatch, route, seed):
    w = wl()
    for t in (gen.make_tables(tiny(6000), seed, "cpu"),
              with_repeats(gen.make_tables(tiny(6000, 500), seed, "cpu"),
                           neg_zero=route == "stream")):
        ref, scales, stats = reference.module("union").compute(
            t, w["query"])
        prog = port_union(t, route, monkeypatch)
        nums = check.numbers(check.local_numbers(prog, ref, scales,
                                                 w["check"]),
                             stats["out_rows"], w["check"])
        assert nums == {"rows_gap": 0.0, "mismatched": 0.0}, (route, nums)
        assert check.verdict(nums, w["limits"])


def test_the_stream_route_runs_k5_when_forced(monkeypatch):
    from cylon_tpu_torch.ops import kernels

    seen = []
    real = kernels.setop_stream

    def spy(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(kernels, "setop_stream", spy)
    port_union(gen.make_tables(tiny(2000), 7, "cpu"), "stream", monkeypatch)
    assert seen == [1]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.tiny_checkout(tmp_path_factory.mktemp("c"), rows=8192)


def test_control_fails_and_the_program_passes(root):
    for r in control.readings(CELL, SEEDS, device="cpu", root=root):
        assert check.verdict(r["program"], r["limits"]), r
        assert not check.verdict(r["control"], r["limits"]), r


STREAM = "from cylon_tpu_torch.ops import setops\nsetops.STREAM_SETOP = True\n"

FAULTS = {
    # the result's last live row dropped
    "dropped": """
from portbench.queries import union as Q
import torch
_orig = Q.run
def run(tables, q):
    out = _orig(tables, q)
    mask = out.emit_mask().clone()
    mask[torch.nonzero(mask).flatten()[-1]] = False
    out._row_mask = mask
    return out
Q.run = run
""",
    # the result's first live row written over its last one
    "duplicated": """
from portbench.queries import union as Q
import torch
_orig = Q.run
def run(tables, q):
    out = _orig(tables, q)
    live = torch.nonzero(out.emit_mask()).flatten()
    for c in out.columns():
        c.data[live[-1]] = c.data[live[0]]
    return out
Q.run = run
""",
    # the lowest bit of one payload flipped
    "flipped": """
from portbench.queries import union as Q
import torch
_orig = Q.run
def run(tables, q):
    out = _orig(tables, q)
    i = int(torch.nonzero(out.emit_mask())[0])
    bits = out.columns()[1].data.view(torch.int64)
    bits[i] ^= 1
    return out
Q.run = run
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(root, fault):
    res = testing.result(testing.run_cpu(
        root, ["--workload", CELL, "--seed", str(SEEDS[0]), "--seconds",
               "0.3"], prelude=STREAM + FAULTS[fault]))
    assert res["correct"] is False, res
    assert res["checks"]["mismatched"]["value"] > 0 or \
        res["checks"]["rows_gap"]["value"] > 0, res


@pytest.mark.parametrize("traced", [0, 1])
def test_the_cell_runs_whole(root, traced):
    res = testing.result(testing.run_cpu(
        root, ["--workload", CELL, "--seed", str(SEEDS[2]), "--seconds",
               "0.3", "--trace", str(traced)], prelude=STREAM))
    assert res["correct"] is True and res["failed"] == 0, res
    assert res["checks"] == {"rows_gap": {"value": 0.0, "limit": 0.0},
                             "mismatched": {"value": 0.0, "limit": 0.0}}
    if traced:
        # on the CPU no span is timed and no kernel runs on a device
        assert res["metrics"] == {}
        assert "busy_s" in res["device"]
    else:
        assert set(res["metrics"]) == {"input_rows_per_s", "query_p90_ms",
                                       "setup_s"}


# ---------------------------------------------------------------------------
# the readers on a fabricated reading
# ---------------------------------------------------------------------------

SETOP = {"setop": (2000.0, 10), "setop.prepare": (20.0, 10),
         "setop.hash": (1200.0, 10), "setop.sort": (600.0, 10),
         "setop.stream": (60.0, 10), "setop.materialize": (80.0, 10)}
READS = {"setop_hash_ms": 120.0, "setop_sort_ms": 60.0,
         "setop_stream_ms": 6.0, "setop_materialize_ms": 8.0}


def union_stats(op="union"):
    cols = {"k": 8, "v": 8}
    return {"op": op, "query": {"op": op, "left": "l", "right": "r"},
            "tables": {s: {"rows": 1000, "columns": cols,
                           "float_columns": ["v"]} for s in ("l", "r")},
            "out_rows": 1900, "query_bytes": 2000 * 16 + 1900 * 16}


def reading(stats_, queries=10, tr=None):
    tr = tr or trace.Trace((0.0, 1e6))
    return harness.Reading(queries, tr.window_s, [], 0.0, 0, 0, stats_,
                           harness.load_json(HERE / "peaks.json"), tr,
                           harness.roofline_modules(),
                           harness.kernel_symbols())


def read(name, r):
    return harness.load_module(HERE / "metrics" / f"{name}.py").read(r)


@pytest.fixture
def fake(monkeypatch):
    got = dict(SETOP)
    monkeypatch.setattr(telemetry, "span_device_times", lambda: got)
    return got


def test_stage_readers_and_cover(fake):
    for name, want in READS.items():
        assert read(name, reading(union_stats())) == pytest.approx(want)
    assert read("setop_cover_pct", reading(union_stats())) == \
        pytest.approx(100 * 1960 / 2000)
    # the dense route's stage counts as a leaf
    fake["setop.dense"] = (30.0, 10)
    assert read("setop_cover_pct", reading(union_stats())) == \
        pytest.approx(100 * 1990 / 2000)


def test_stage_readers_read_nothing_where_they_must_not(fake):
    for name in list(READS) + ["setop_cover_pct"]:
        assert read(name, reading(union_stats(), queries=11)) is None
        r = reading(union_stats())
        r.trace = None
        assert read(name, r) is None
    fake.pop("setop")
    for name in list(READS) + ["setop_cover_pct"]:
        assert read(name, reading(union_stats())) is None


def test_stage_readers_on_a_program_without_set_op_spans(monkeypatch):
    monkeypatch.setattr(telemetry, "span_device_times",
                        lambda: {"join": (5.0, 10)})
    for name in list(READS) + ["setop_cover_pct"]:
        assert read(name, reading(union_stats())) is None


def test_rooflines_on_a_synthetic_trace():
    # K5 10 us, K6 5 us in the window; 2000 rows in, 1900 kept, 4 lanes
    tr = trace.Trace((0.0, 100.0), [
        ("(anonymous namespace)::setop_stream_kernel(unsigned int const*)",
         10, 20),
        ("(anonymous namespace)::stream_compact_kernel(bool const*)",
         30, 35)])
    r = reading(union_stats(), queries=1, tr=tr)
    k5 = (12 * 2000 + 16 * 100 + 2000 / 8) / 3.35e12
    k6 = (2000 / 8 + 32 * 1900) / 3.35e12
    assert read("setop_stream_roofline", r) == pytest.approx(
        100 * k5 / 10e-6)
    assert read("stream_compact_roofline", r) == pytest.approx(
        100 * k6 / 5e-6)
    # another op's stage has neither: the join's and the group-by's
    # kernel shares stay as they were
    for name in ("setop_stream", "stream_compact"):
        mod = harness.roofline_modules()[name]
        assert mod.stage_bytes({"op": "join"}) is None
        assert mod.stage_bytes({"op": "groupby"}) is None
