#!/usr/bin/env python
"""Service-layer smoke gate of the port (counterpart of
scripts/smoke_service.py; run by scripts/torch_port/check.sh).

Drives the query service end to end on a world of 4 shards: two tenants,
the same query shape submitted 8 times. It checks:

* **the plan cache is live**: ``cylon_plan_cache_hits_total`` moves by
  at least 7 for the 8 equal-shape submissions, and the kernel-library
  build counter (``cylon_kernel_factory_builds_total``) does not move
  after the first service query. ``CYLON_TPU_VERIFY_PLANS=1`` is forced,
  so every cache hit re-runs the witness verifier. On CUDA the process's
  first query must also have moved the counter by at least 1 (it loads
  the kernel libraries); on the CPU no library is ever loaded, so both
  counts are 0 there;
* **results bit-identical to sequential execution** ticket by ticket:
  the group keys and the float sums, as the JAX smoke promises. The
  port's float group sums add each group in row order (K7,
  ``kernels.segment_sum``), so they are bit-reproducible on the card
  too;
* **per-tenant accounting**: ``cylon_queries_total{outcome="ok",
  tenant=...}`` for both tenants, the wait histogram counted every
  query, the plan-cache counters render, the queue-depth gauges are 0;
* **tenant forensics**: an ``analyze=True`` submission's root span
  carries the tenant label;
* **nothing leaks** once results are dropped.

    python scripts/torch_port/smoke_service.py [--device cuda|cpu]

Exit 0 on success, 1 with the offending artifact on stderr otherwise.
The last stdout line is the drill's JSON summary.
"""
import os
import sys

import drill_common

# cached plans must still pass witness verification on every hit
os.environ["CYLON_TPU_VERIFY_PLANS"] = "1"

N_QUERIES = 8
TENANTS = ("tenant-a", "tenant-b")


def fail(msg: str) -> None:
    print(f"service smoke: FAIL — {msg}", file=sys.stderr)
    sys.exit(1)


def main(device: str) -> None:
    import gc

    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import plan, telemetry
    from cylon_tpu_torch.service import QueryService
    from cylon_tpu_torch.telemetry import ledger

    out = drill_common.Summary("smoke_service", device)
    # the ledger is per process: the drill checks the change across it
    leaks0 = ledger.leak_count()
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                          device=device)
    n = 4096

    def tables(seed):
        r = np.random.default_rng(seed)
        left = ct.Table.from_pydict(ctx, {
            "k": r.integers(0, n // 4, n).astype(np.int32),
            "v": r.normal(size=n).astype(np.float32),
            "z": r.integers(0, 50, n).astype(np.int32)})
        right = ct.Table.from_pydict(ctx, {
            "k": r.integers(0, n // 4, n).astype(np.int32),
            "w": r.normal(size=n).astype(np.float32)})
        return left, right

    tabs = {t: tables(100 + i) for i, t in enumerate(TENANTS)}

    def pipe(t):
        left, right = tabs[t]
        return plan.scan(left).join(plan.scan(right), on="k") \
            .groupby("lt-2", ["rt-4"], ["sum"])

    def rows(table):
        d = table.to_pydict()
        ks = sorted(d)
        return ks, sorted(zip(*(np.asarray(d[k]).tolist()
                                for k in ks)))

    def counter_sum(prefix):
        return sum(v for k, v in telemetry.metrics_snapshot().items()
                   if k.startswith(prefix) and isinstance(v, int))

    # sequential reference results, one per tenant (also loads the
    # kernel libraries AND inserts the shape into the plan cache). The
    # process's first query loads the libraries on CUDA.
    builds0 = counter_sum("cylon_kernel_factory_builds_total")
    seq = {TENANTS[0]: rows(pipe(TENANTS[0]).execute())}
    first_query_builds = counter_sum(
        "cylon_kernel_factory_builds_total") - builds0
    if ctx.device.type == "cuda" and first_query_builds < 1:
        fail("the process's first query on CUDA loaded no kernel "
             "library (cylon_kernel_factory_builds_total did not move)")
    if ctx.device.type == "cpu" and first_query_builds != 0:
        fail(f"the CPU loaded {first_query_builds} kernel librar(ies)")
    out.ok("first_query_builds")
    seq.update({t: rows(pipe(t).execute()) for t in TENANTS[1:]})

    hits0 = counter_sum("cylon_plan_cache_hits_total")
    svc = QueryService()
    # first service query ALONE: wait for it, then snapshot the build
    # counter while the worker is idle
    first_tenant = TENANTS[0]
    first = svc.submit(pipe(first_tenant), tenant=first_tenant,
                       analyze=True)
    first.result(timeout=600)
    builds_after_first = counter_sum("cylon_kernel_factory_builds_total")
    tickets = [(first_tenant, first)]
    for i in range(1, N_QUERIES):
        t = TENANTS[i % 2]
        tickets.append((t, svc.submit(pipe(t), tenant=t)))
    svc.drain(timeout=600)

    # -- results equal sequential execution ---------------------------
    for t, tk in tickets:
        if tk.outcome != "ok":
            fail(f"ticket {tk.query_id} ({t}) outcome {tk.outcome!r}: "
                 f"{tk}")
        got = rows(tk.result(timeout=60))
        if got != seq[t]:  # names and rows, every float exact
            fail(f"service result for {t} diverges from sequential "
                 f"execution")
    svc.close()
    out.ok("results")

    # -- plan cache proven live ---------------------------------------
    hits = counter_sum("cylon_plan_cache_hits_total") - hits0
    if hits < N_QUERIES - 1:
        fail(f"plan cache hits {hits} < {N_QUERIES - 1} for "
             f"{N_QUERIES} equal-shape submissions")
    builds_delta = counter_sum("cylon_kernel_factory_builds_total") \
        - builds_after_first
    if builds_delta != 0:
        fail(f"{builds_delta} kernel library build(s) AFTER the first "
             f"service query — the warm cache is not amortizing "
             f"compilation")
    out.ok("plan_cache")

    # -- tenant label on the analyzed query's root span ---------------
    rep = first.report()
    if rep is None:
        fail("analyze=True submission produced no PlanReport")
    if rep.span.attrs.get("tenant") != first_tenant:
        fail(f"EXPLAIN ANALYZE root span lacks the tenant label: "
             f"{rep.span.attrs}")
    out.ok("tenant_label")

    # -- Prometheus dump: per-tenant series wired ---------------------
    prom = telemetry.prometheus_text()
    for t in TENANTS:
        want = 4  # N_QUERIES split evenly
        line = [l for l in prom.splitlines()
                if l.startswith("cylon_queries_total")
                and f'tenant="{t}"' in l and 'outcome="ok"' in l]
        if not line:
            fail(f"cylon_queries_total{{tenant={t},outcome=ok}} "
                 f"missing from the Prometheus dump")
        if float(line[0].split()[-1]) != want:
            fail(f"per-tenant ok counter off: {line[0]} (want {want})")
        depth = [l for l in prom.splitlines()
                 if l.startswith("cylon_service_queue_depth")
                 and f'tenant="{t}"' in l]
        if not depth or float(depth[0].split()[-1]) != 0:
            fail(f"queue depth gauge not drained: {depth}")
    for series in ("cylon_service_wait_seconds_bucket",
                   "cylon_plan_cache_hits_total",
                   "cylon_plan_cache_misses_total"):
        if series not in prom:
            fail(f"{series} missing from the Prometheus dump")
    wait_count = [l for l in prom.splitlines()
                  if l.startswith("cylon_service_wait_seconds_count")]
    if not wait_count or float(wait_count[0].split()[-1]) < N_QUERIES:
        fail(f"wait histogram counted fewer than {N_QUERIES} "
             f"queries: {wait_count}")
    out.ok("prometheus")

    # -- nothing leaks ------------------------------------------------
    mean_wait = sum(w.wait_s for _t, w in tickets) / len(tickets)
    del tickets, first, rep, seq, tk  # tk: the comparison loop var
    gc.collect()
    if ledger.leak_count() != leaks0:
        fail(f"ledger leaks after dropping service results: "
             f"{ledger.outstanding(include_borrowed=False)}")
    out.ok("no_leaks")

    print(f"service smoke: OK — {N_QUERIES} queries over "
          f"{len(TENANTS)} tenants, {hits} plan-cache hits, "
          f"{first_query_builds} kernel library build(s) in the first "
          f"query, 0 after the first service query, "
          f"mean wait {mean_wait * 1e3:.2f} ms, zero leaks")
    out.emit(plan_cache_hits=hits, first_query_builds=first_query_builds,
             builds_after_first_service_query=builds_delta)


if __name__ == "__main__":
    main(drill_common.parse_device(description=__doc__.split("\n")[0]))
