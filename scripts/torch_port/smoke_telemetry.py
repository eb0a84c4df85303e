#!/usr/bin/env python
"""Telemetry smoke gate of the port (counterpart of
scripts/smoke_telemetry.py; run by scripts/torch_port/check.sh).

Runs a two-shuffle pipeline (join on k, then groupby on a DIFFERENT key,
so the groupby cannot aggregate in place) on a world of 4 shards and
checks the observability layer end to end:

* the JSONL span sink wrote a trace whose every line parses, whose tree
  links up, with both ``plan.shuffle*`` stages and skew attributes on
  every ``shuffle.exchange*`` span;
* the Prometheus dump carries a nonzero ``cylon_shuffle_bytes_total``,
  the per-shard shuffle histograms, host-sync counters and live-table
  gauges; on CUDA also ``cylon_kernel_compile_seconds`` from the compile
  profiler, and on the CPU, where no kernel library is loaded, neither
  that series nor a library load;
* ``explain(analyze=True)`` renders measured rows, skew columns and
  ``est=`` bytes, its shuffle count equals the phase labels', and the
  query leaks nothing;
* spans carry ``hbm_delta``/``hbm_peak`` (the allocator's bytes on CUDA,
  the ledger's on the CPU) with a nonzero peak;
* a deliberately failing query writes one crash dump to
  ``CYLON_FLIGHT_DIR`` with the in-flight ``plan.shuffle*`` span, a
  nonzero pool watermark, the metrics and the ledger's outstanding set.

    python scripts/torch_port/smoke_telemetry.py [--device cuda|cpu]

Exit 0 on success, 1 with the offending artifact on stderr otherwise.
The last stdout line is the drill's JSON summary.
"""
import json
import os
import sys
import tempfile

import drill_common


def fail(msg: str) -> None:
    print(f"telemetry smoke: FAIL — {msg}", file=sys.stderr)
    sys.exit(1)


def main(device: str) -> None:
    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import plan, telemetry
    from cylon_tpu_torch.telemetry import profiler

    out = drill_common.Summary("smoke_telemetry", device)
    # the profiler records libraries loaded after it is enabled
    profiler.enable()
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                          device=device)
    rng = np.random.default_rng(0)
    n = 4096
    left = ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "v": rng.normal(size=n).astype(np.float32),
        "z": rng.integers(0, 50, n).astype(np.int32)})
    right = ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "w": rng.normal(size=n).astype(np.float32)})

    # join on k, group by z: TWO exchange stages even optimized
    pipe = plan.scan(left).join(plan.scan(right), on="k") \
        .groupby("lt-2", ["rt-4"], ["sum"])

    trace_path = os.path.join(tempfile.mkdtemp(), "trace.jsonl")
    with telemetry.JsonlSpanSink(trace_path) as sink:
        with telemetry.collect_phases() as cp:
            txt = pipe.explain(analyze=True)

    # -- JSONL trace: parseable, linked, carrying both exchanges ------
    lines = open(trace_path, encoding="utf-8").read().splitlines()
    if not lines:
        fail("empty JSONL trace")
    try:
        recs = [json.loads(l) for l in lines]
    except json.JSONDecodeError as e:
        fail(f"unparseable JSONL line: {e}")
    if len(recs) != sink.spans_written:
        fail(f"sink wrote {sink.spans_written} spans, file has "
             f"{len(recs)} lines")
    ids = {r["span_id"] for r in recs}
    dangling = [r for r in recs
                if r["parent_id"] and r["parent_id"] not in ids]
    if dangling:
        fail(f"dangling parent_id in trace: {dangling[:3]}")
    shuffle_spans = [r for r in recs
                     if r["name"].startswith("plan.shuffle")]
    if len(shuffle_spans) != 2:
        fail(f"expected 2 plan.shuffle* spans in the trace, got "
             f"{[r['name'] for r in shuffle_spans]}")
    ex_spans = [r for r in recs
                if r["name"].startswith("shuffle.exchange")]
    if not ex_spans:
        fail("no shuffle.exchange* spans in the trace")
    for r in ex_spans:
        missing = [k for k in ("skew_imbalance", "shard_rows_min",
                               "shard_rows_med", "shard_rows_max")
                   if k not in r["attrs"]]
        if missing:
            fail(f"exchange span {r['name']} lacks skew attrs "
                 f"{missing}: {r['attrs']}")
    out.ok("trace")

    # -- EXPLAIN ANALYZE: measured + label-consistent -----------------
    rep = pipe.last_report
    if "rows=" not in txt or "actual time=" not in txt:
        fail(f"explain(analyze=True) missing measurements:\n{txt}")
    if "skew(imb=" not in txt:
        fail(f"explain(analyze=True) missing skew columns:\n{txt}")
    if "est=" not in txt:
        fail(f"explain(analyze=True) missing pre-flight est= bytes:\n"
             f"{txt}")
    if rep.shuffle_count != cp.count("plan.shuffle"):
        fail(f"report shuffle_count {rep.shuffle_count} != "
             f"collect_phases {cp.count('plan.shuffle')}")
    if rep.shuffle_count != 2:
        fail(f"two-shuffle pipeline reported {rep.shuffle_count} "
             f"exchanges:\n{txt}")
    if rep.leaks:
        fail(f"clean pipeline reported ledger leaks: {rep.leaks}")
    out.ok("explain_analyze")

    # -- memory observatory: per-span memory attrs ride the trace -----
    hbm_spans = [r for r in recs if "hbm_delta" in r["attrs"]
                 and "hbm_peak" in r["attrs"]]
    if not hbm_spans:
        fail("no span in the trace carries hbm_delta/hbm_peak attrs "
             "(pool not registered, or ledger fallback dead)")
    if max(r["attrs"]["hbm_peak"] for r in hbm_spans) <= 0:
        fail("hbm_peak is zero across the whole trace — the pool "
             "(allocator stats, or the ledger fallback) is not "
             "accounting")
    out.ok("hbm_attrs")

    # -- Prometheus dump: renders, counters wired ---------------------
    prom = telemetry.prometheus_text()
    bytes_lines = [l for l in prom.splitlines()
                   if l.startswith("cylon_shuffle_bytes_total ")]
    if not bytes_lines:
        fail("cylon_shuffle_bytes_total missing from Prometheus dump")
    if not float(bytes_lines[0].split()[1]) > 0:
        fail(f"cylon_shuffle_bytes_total is zero: {bytes_lines[0]}")
    if "cylon_phase_latency_ms_bucket" not in prom:
        fail("phase latency histogram missing from Prometheus dump")
    for series in ("cylon_shuffle_shard_rows_bucket",
                   "cylon_shuffle_shard_bytes_bucket",
                   "cylon_shuffle_imbalance_factor_bucket",
                   "cylon_host_syncs_total",
                   "cylon_live_table_bytes"):
        if series not in prom:
            fail(f"{series} missing from Prometheus dump")
    out.ok("prometheus")
    n_compiles = len(profiler.records())
    loads = telemetry.metrics_snapshot().get(
        'cylon_kernel_factory_builds_total{factory="load_library"}', 0)
    if ctx.device.type == "cuda":
        if "cylon_kernel_compile_seconds_bucket" not in prom:
            fail("cylon_kernel_compile_seconds missing from Prometheus "
                 "dump")
        if n_compiles == 0:
            fail("compile-cost profiler recorded no kernel library")
    elif n_compiles or loads or \
            "cylon_kernel_compile_seconds_bucket" in prom:
        fail(f"the CPU loaded a kernel library: {n_compiles} profiled, "
             f"{loads} load(s)")
    out.ok("compile_profile")

    # -- flight recorder: a failing query leaves a crash dump ---------
    dump, watermark = crash_dump_smoke(plan, left)
    out.ok("crash_dump")

    print(f"telemetry smoke: OK — {len(recs)} spans traced, "
          f"{rep.shuffle_count} exchanges measured, "
          f"{bytes_lines[0].split()[1]} shuffle bytes counted, "
          f"{len(ex_spans)} exchange span(s) with skew attrs, "
          f"{len(hbm_spans)} span(s) with hbm attrs, "
          f"{n_compiles} kernel librar{'y' if n_compiles == 1 else 'ies'}"
          f" profiled, crash dump at {dump}")
    out.emit(spans=len(recs), compiles=n_compiles, library_loads=loads,
             hbm_peak=max(r["attrs"]["hbm_peak"] for r in hbm_spans),
             dump_bytes_in_use=watermark)


def crash_dump_smoke(plan, left):
    """Force a failing query under the flight recorder: an exchange
    failure injected into an explicit Shuffle plan must leave one crash
    dump in CYLON_FLIGHT_DIR that parses and carries the in-flight
    plan.shuffle span, a nonzero pool watermark, the metrics snapshot
    and the ledger's outstanding set."""
    from cylon_tpu_torch.parallel import dist_ops

    flight_dir = tempfile.mkdtemp()
    os.environ["CYLON_FLIGHT_DIR"] = flight_dir

    orig = dist_ops.shuffle

    def boom(*a, **kw):
        raise RuntimeError("injected exchange failure (smoke)")

    dist_ops.shuffle = boom
    try:
        try:
            plan.scan(left).shuffle("k").execute(analyze=True)
        except RuntimeError:
            pass
        else:
            fail("injected exchange failure did not raise")
    finally:
        dist_ops.shuffle = orig
        os.environ.pop("CYLON_FLIGHT_DIR", None)

    dumps = [f for f in os.listdir(flight_dir) if f.endswith(".json")]
    if len(dumps) != 1:
        fail(f"expected exactly one crash dump in {flight_dir}, "
             f"found {dumps}")
    path = os.path.join(flight_dir, dumps[0])
    try:
        doc = json.load(open(path, encoding="utf-8"))
    except json.JSONDecodeError as e:
        fail(f"crash dump does not parse as JSON: {e}")
    for key in ("query", "error_path", "metrics", "pool",
                "ledger_outstanding", "environment"):
        if key not in doc:
            fail(f"crash dump lacks {key!r}: {sorted(doc)}")
    names = [s["name"] for s in doc["error_path"]]
    if not any(n.startswith("plan.shuffle") for n in names):
        fail(f"crash dump error path lacks the in-flight plan.shuffle "
             f"span: {names}")
    if not doc["pool"].get("bytes_in_use", 0) > 0:
        fail(f"crash dump pool watermark is zero (ledger fallback "
             f"dead): {doc['pool']}")
    if not doc["ledger_outstanding"]:
        fail("crash dump has an empty ledger outstanding set — the "
             "in-flight scan inputs should be live")
    return path, doc["pool"]["bytes_in_use"]


if __name__ == "__main__":
    main(drill_common.parse_device(description=__doc__.split("\n")[0]))
