"""The per-stage readers (``spans.py`` and the metrics that call it) on a
faked ``span_device_times``: their arithmetic, and None where the run
was untraced, where the op span's count is not the window's query
count, and where the program has no span timing at all."""
import pytest

import cylon_tpu_torch.telemetry as telemetry
from portbench import harness, spans, trace

JOIN = {"join": (2600.0, 10), "join.prepare": (100.0, 10),
        "join.plan": (1500.0, 10), "join.plan.hash": (1200.0, 10),
        "join.plan.sort": (250.0, 10), "join.plan.stream": (40.0, 10),
        "join.materialize": (600.0, 10), "join.rebuild": (300.0, 10)}
GROUPBY = {"groupby": (450.0, 10), "groupby.keys": (10.0, 10),
           "groupby.sort": (100.0, 10), "groupby.gather": (200.0, 10),
           "groupby.aggregate": (90.0, 10), "groupby.rebuild": (30.0, 10)}
READS = {"join_prepare_ms": 10.0, "join_hash_ms": 120.0,
         "join_sort_ms": 25.0, "join_materialize_ms": 60.0,
         "join_rebuild_ms": 30.0, "groupby_sort_ms": 10.0,
         "groupby_gather_ms": 20.0, "groupby_aggregate_ms": 9.0,
         "groupby_rebuild_ms": 3.0}


def reading(op, queries=10, traced=True):
    tr = trace.Trace((0.0, 1e6)) if traced else None
    return harness.Reading(queries, 1.0, [], 0.0, 0, 0, {"op": op}, {}, tr)


def read(name, r):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py"
                               ).read(r)


@pytest.fixture
def fake(monkeypatch):
    calls = []

    def span_device_times():
        calls.append(1)
        return {**JOIN, **GROUPBY}
    monkeypatch.setattr(telemetry, "span_device_times", span_device_times)
    return calls


def test_stage_readers_divide_by_the_query_count(fake):
    for name, want in READS.items():
        op = name.split("_")[0]
        assert read(name, reading(op)) == pytest.approx(want), name


def test_stage_cover_over_the_op_span(fake):
    # join: (100 + 1200 + 250 + 40 + 600 + 300) / 2600
    assert read("stage_cover_pct", reading("join")) == \
        pytest.approx(100 * 2490 / 2600)
    assert read("stage_cover_pct", reading("groupby")) == \
        pytest.approx(100 * 430 / 450)


def test_one_read_of_the_program_a_reading(fake):
    r = reading("join")
    for name in ("join_sort_ms", "join_hash_ms", "stage_cover_pct"):
        read(name, r)
    assert len(fake) == 1
    read("join_sort_ms", reading("join"))
    assert len(fake) == 2


def test_nothing_untraced_or_on_a_count_mismatch(fake):
    for name in list(READS) + ["stage_cover_pct"]:
        op = name.split("_")[0]
        assert read(name, reading(op, traced=False)) is None, name
    assert not fake
    for name in list(READS) + ["stage_cover_pct"]:
        op = name.split("_")[0]
        assert read(name, reading(op, queries=11)) is None, name


def test_nothing_from_a_program_without_span_timing(monkeypatch):
    monkeypatch.delattr(telemetry, "span_device_times")
    for name in ("join_sort_ms", "stage_cover_pct"):
        assert read(name, reading("join")) is None


def test_a_stage_that_never_ran_reads_nothing_and_counts_zero(
        monkeypatch):
    got = {k: v for k, v in JOIN.items() if k != "join.rebuild"}
    monkeypatch.setattr(telemetry, "span_device_times", lambda: got)
    assert read("join_rebuild_ms", reading("join")) is None
    assert read("stage_cover_pct", reading("join")) == \
        pytest.approx(100 * 2190 / 2600)
    assert spans.LEAVES["join"][-1] == "join.rebuild"
