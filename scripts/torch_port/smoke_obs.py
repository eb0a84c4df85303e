#!/usr/bin/env python
"""Observability-endpoint smoke gate of the port (counterpart of
scripts/smoke_obs.py; run by scripts/torch_port/check.sh).

Drives the live service observatory end to end on a world of 4 shards:
two tenants x 8 queries a phase through a QueryService with the HTTP
endpoint armed (CYLON_OBS_PORT, an ephemeral port from a bound-and-
released socket, so two runs on one machine do not collide). It checks:

* **live scrape**: /metrics returns Prometheus text with the per-tenant
  query counters and ``cylon_slo_latency_p95_ms`` series; /healthz
  reports a live worker (HTTP 200); /queries returns the digest ring;
  /slo returns per-tenant quantiles and error budget;
* **the query log is complete**: one parseable JSONL line per completed
  query, each naming tenant, plan fingerprint, cache fate, admission
  decision and wait;
* **sampling bounds traces, not signals**: at
  ``CYLON_TRACE_SAMPLE_RATE=0.5`` the span-sink line count drops against
  the fully sampled phase while the query log and ``cylon_queries_total``
  stay complete, and each digest's ``sampled`` flag equals
  ``sampling.decide(query_id)``;
* **clean shutdown**: after ``svc.close()`` no ``cylon-obs`` thread is
  left and the ledger holds no new entry.

    python scripts/torch_port/smoke_obs.py [--device cuda|cpu]

Exit 0 on success, 1 with the offending artifact on stderr otherwise.
The last stdout line is the drill's JSON summary.
"""
import json
import os
import socket
import sys

import drill_common

os.environ["CYLON_TPU_VERIFY_PLANS"] = "1"
# a generous objective: the SLO machinery must be LIVE (budget gauges,
# /slo payload) without this smoke's wall clock deciding pass/fail
os.environ["CYLON_SLO_P95_MS"] = "60000"

N_PER_PHASE = 16  # 2 tenants x 8 queries
TENANTS = ("tenant-a", "tenant-b")


def fail(msg: str) -> None:
    print(f"obs smoke: FAIL — {msg}", file=sys.stderr)
    sys.exit(1)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(device: str) -> None:
    import gc
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import plan, telemetry
    from cylon_tpu_torch.service import QueryService
    from cylon_tpu_torch.telemetry import ledger, querylog, sampling

    out = drill_common.Summary("smoke_obs", device)
    leaks0 = ledger.leak_count()
    port = free_port()
    os.environ["CYLON_OBS_PORT"] = str(port)

    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                          device=device)
    n = 2048

    def tables(seed):
        r = np.random.default_rng(seed)
        left = ct.Table.from_pydict(ctx, {
            "k": r.integers(0, n // 4, n).astype(np.int32),
            "v": r.normal(size=n).astype(np.float32)})
        right = ct.Table.from_pydict(ctx, {
            "k": r.integers(0, n // 4, n).astype(np.int32),
            "w": r.normal(size=n).astype(np.float32)})
        return left, right

    tabs = {t: tables(100 + i) for i, t in enumerate(TENANTS)}

    def pipe(t):
        left, right = tabs[t]
        return plan.scan(left).join(plan.scan(right), on="k") \
            .groupby("lt-1", ["rt-2"], ["sum"])

    def get(route):
        url = f"http://127.0.0.1:{port}{route}"
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode("utf-8")

    def counter_sum(prefix):
        return sum(v for k, v in telemetry.metrics_snapshot().items()
                   if k.startswith(prefix) and isinstance(v, int))

    # warm the kernel memos + plan cache so both phases are steady-state
    pipe(TENANTS[0]).execute()

    tmp = tempfile.mkdtemp(prefix="cylon-obs-smoke-")
    qlog_path = os.path.join(tmp, "querylog.jsonl")
    querylog.enable(qlog_path)

    def run_phase(svc, trace_path):
        tickets = []
        with telemetry.JsonlSpanSink(trace_path) as sink:
            for i in range(N_PER_PHASE):
                t = TENANTS[i % 2]
                tickets.append(svc.submit(pipe(t), tenant=t))
            svc.drain(timeout=600)
            for tk in tickets:
                if tk.outcome != "ok":
                    fail(f"query {tk.query_id} outcome {tk.outcome!r}")
                tk.result(timeout=60)
        return tickets, sink.spans_written

    svc = QueryService(name="obs-smoke")

    # -- phase A: fully sampled -------------------------------------------
    os.environ["CYLON_TRACE_SAMPLE_RATE"] = "1.0"
    ok0 = counter_sum("cylon_queries_total")
    lines0 = querylog.lines_written()
    tickets_a, trace_lines_a = run_phase(
        svc, os.path.join(tmp, "trace_full.jsonl"))
    if querylog.lines_written() - lines0 != N_PER_PHASE:
        fail(f"querylog wrote {querylog.lines_written() - lines0} "
             f"lines for {N_PER_PHASE} completed queries (phase A)")
    out.ok("phase_a")

    # -- live scrape against the running service --------------------------
    status, prom = get("/metrics")
    if status != 200:
        fail(f"/metrics status {status}")
    for t in TENANTS:
        if not any(l.startswith("cylon_queries_total") and
                   f'tenant="{t}"' in l and 'outcome="ok"' in l
                   for l in prom.splitlines()):
            fail(f"cylon_queries_total{{tenant={t},outcome=ok}} "
                 f"missing from /metrics")
        if not any(l.startswith("cylon_slo_latency_p95_ms") and
                   f'tenant="{t}"' in l for l in prom.splitlines()):
            fail(f"cylon_slo_latency_p95_ms{{tenant={t}}} missing "
                 f"from /metrics")
    if "cylon_trace_sampled_total" not in prom:
        fail("cylon_trace_sampled_total missing from /metrics")

    status, hz = get("/healthz")
    hz = json.loads(hz)
    if status != 200 or not hz["ok"] or not \
            hz["service"]["worker_alive"]:
        fail(f"/healthz not live: {status} {hz}")

    status, q = get("/queries")
    digests = json.loads(q)
    if status != 200 or len(digests) < N_PER_PHASE:
        fail(f"/queries returned {len(digests)} digests "
             f"(want >= {N_PER_PHASE})")
    d = digests[-1]
    for field in ("query_id", "tenant", "plan_fp", "plan_cache",
                  "outcome", "exec_ms", "wait_s", "admission",
                  "shuffle_bytes"):
        if d.get(field) is None:
            fail(f"digest field {field!r} missing/None: {d}")

    status, slo_doc = get("/slo")
    slo_doc = json.loads(slo_doc)
    for t in TENANTS:
        st = slo_doc.get(t)
        if status != 200 or st is None:
            fail(f"/slo missing tenant {t}: {slo_doc}")
        if st["p95_ms"] is None or st["error_budget_remaining"] is None:
            fail(f"/slo incomplete for {t}: {st}")
    out.ok("live_scrape")

    # -- phase B: half sampled — traces drop, signals stay complete -------
    os.environ["CYLON_TRACE_SAMPLE_RATE"] = "0.5"
    lines1 = querylog.lines_written()
    tickets_b, trace_lines_b = run_phase(
        svc, os.path.join(tmp, "trace_half.jsonl"))
    if querylog.lines_written() - lines1 != N_PER_PHASE:
        fail(f"querylog incomplete under sampling: "
             f"{querylog.lines_written() - lines1} != {N_PER_PHASE}")
    if counter_sum("cylon_queries_total") - ok0 != 2 * N_PER_PHASE:
        fail("cylon_queries_total incomplete under sampling")
    if trace_lines_b >= trace_lines_a:
        fail(f"span-sink line count did not drop under 0.5 sampling: "
             f"{trace_lines_b} >= {trace_lines_a}")
    # the head decision is deterministic and replayable: the digests'
    # sampled flags must match sampling.decide(query_id) exactly
    want = {tk.query_id: sampling.decide(tk.query_id, 0.5)
            for tk in tickets_b}
    got = {d["query_id"]: d["sampled"]
           for d in querylog.recent() if d["query_id"] in want}
    if got != want:
        fail(f"sampling decisions diverge from decide(query_id): "
             f"want {want}, got {got}")
    if all(want.values()):
        fail("degenerate phase B: every query sampled in — "
             "line-drop assertion proved nothing")
    out.ok("sampling")

    # every query-log line is independently parseable
    with open(qlog_path, encoding="utf-8") as f:
        parsed = [json.loads(line) for line in f]
    if len(parsed) != 2 * N_PER_PHASE:
        fail(f"querylog file has {len(parsed)} lines, want "
             f"{2 * N_PER_PHASE}")
    out.ok("querylog")

    # -- clean shutdown ---------------------------------------------------
    svc.close()
    querylog.disable()
    if any(th.name == "cylon-obs" for th in threading.enumerate()):
        fail("obs endpoint thread leaked past svc.close()")
    try:
        get("/healthz")
    except OSError:
        pass
    else:
        fail("endpoint still serving after close()")

    del tickets_a, tickets_b, d, digests
    gc.collect()
    if ledger.leak_count() != leaks0:
        fail(f"ledger leaks: "
             f"{ledger.outstanding(include_borrowed=False)}")
    out.ok("clean_shutdown")

    sampled_out = sum(1 for v in want.values() if not v)
    print(f"obs smoke: OK — {2 * N_PER_PHASE} queries over "
          f"{len(TENANTS)} tenants, scraped /metrics /healthz "
          f"/queries /slo live, querylog complete "
          f"({2 * N_PER_PHASE} lines), trace lines "
          f"{trace_lines_a} -> {trace_lines_b} at rate 0.5 "
          f"({sampled_out}/{N_PER_PHASE} sampled out), "
          f"endpoint shut down clean, zero leaks")
    out.emit(trace_lines=[trace_lines_a, trace_lines_b],
             sampled_out=sampled_out)


if __name__ == "__main__":
    main(drill_common.parse_device(description=__doc__.split("\n")[0]))
