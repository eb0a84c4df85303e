#!/usr/bin/env python
"""Statistics-warehouse smoke gate of the port (counterpart of
scripts/smoke_stats.py; run by scripts/torch_port/check.sh).

Drives the estimate-accuracy closed loop end to end through a live
QueryService with the HTTP observatory armed (an ephemeral port):

* **the loop closes**: a query whose stat-free width x row estimate is
  ~100x its measured output or more is SHED at first sight under a clamped
  budget; once the shape is learned unclamped (CYLON_STATS_MIN_OBS
  successful runs) the same query under the same clamp is ADMITTED with
  ``est_source=measured`` in the query-log digest and the flight
  admission ring;
* **soundness**: a fresh shape under the same clamp still sheds on its
  static estimate, and the measured estimate never exceeds the static
  bound;
* **observatory live**: ``cylon_estimate_qerror{kind=}`` series in the
  scraped /metrics, /stats serves fingerprints with observation counts,
  EWMAs and per-kind q-error quantiles, and
  ``cylon_admission_est_source_total{source="measured"}`` moved;
* **hygiene**: one query-log line per completed query, a clean close,
  no new ledger entry.

The clamp comes from the ``pool`` fault site. On CUDA the real comm
budget (a quarter of the card's free memory) is far above it and
``admission.effective_budget`` decides on the clamp; on the CPU there is
no budget and the clamp decides alone. Both devices reach the same
shed/admit/shed decisions, which the drill reports.

    python scripts/torch_port/smoke_stats.py [--device cuda|cpu]

Exit 0 on success, 1 with the offending artifact on stderr otherwise.
The last stdout line is the drill's JSON summary.
"""
import json
import os
import socket
import sys

import drill_common

os.environ["CYLON_TPU_VERIFY_PLANS"] = "1"
os.environ["CYLON_STATS_MIN_OBS"] = "2"


def fail(msg: str) -> None:
    print(f"stats smoke: FAIL — {msg}", file=sys.stderr)
    sys.exit(1)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(device: str) -> None:
    import gc
    import threading
    import urllib.request

    import numpy as np

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import plan, telemetry
    from cylon_tpu_torch.resilience import inject
    from cylon_tpu_torch.service import QueryService
    from cylon_tpu_torch.telemetry import flight, ledger, querylog

    out = drill_common.Summary("smoke_stats", device)
    leaks0 = ledger.leak_count()
    decisions = []
    port = free_port()
    os.environ["CYLON_OBS_PORT"] = str(port)

    # world=1: the plan is scan/join/groupby with no folded-shuffle
    # markers, so the worst allocating node is exactly the one the
    # warehouse calibrates — the loop's effect on admission is pure
    ctx = ct.CylonContext.Init(device)
    # 65,536 rows (the JAX script's 8,192 x 8): the card's stream route
    # sizes a join's output in whole 1,024-row expansion blocks, so 64
    # matches measure above the static estimate / 16 at 8,192 rows
    n = 1 << 16
    rng = np.random.default_rng(3)
    # near-disjoint key ranges: the static join estimate (left+right
    # rows) over-estimates the measured output ~120x on the card, ~1000x
    # on the CPU
    left = ct.Table.from_pydict(ctx, {
        "k": np.arange(n, dtype=np.int32),
        "v": rng.normal(size=n).astype(np.float32)})
    right = ct.Table.from_pydict(ctx, {
        "k": (np.arange(n, dtype=np.int32) + n - 64),
        "w": rng.normal(size=n).astype(np.float32)})

    def pipe():
        # the closed-loop demonstration shape: scan/scan/join only, so
        # the worst allocating node IS the join the warehouse
        # calibrates (a groupby would make the optimizer insert a
        # pruning Project whose static estimate — an uncalibrated
        # view, conservatively costed — muddies the clamp window)
        return plan.scan(left).join(plan.scan(right), on="k")

    def groupby_pipe():
        # observatory-diversity shape (run unclamped): populates the
        # groupby q-error series beside the join one
        return plan.scan(left).join(plan.scan(right), on="k") \
            .groupby("lt-1", ["rt-2"], ["sum"])

    def fresh_shape():
        # identity project: same work, different structural
        # fingerprints — a first-sight query by construction
        return plan.scan(left).project([0, 1]) \
            .join(plan.scan(right), on="k")

    def get(route):
        url = f"http://127.0.0.1:{port}{route}"
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, resp.read().decode("utf-8")

    def measured_admits():
        return telemetry.metrics_snapshot().get(
            'cylon_admission_est_source_total{source="measured"}', 0)

    # static estimate of the worst allocating node (the join), read
    # from one analyzed run — sizes the clamp below
    warm = pipe()
    warm.execute(analyze=True)

    def walk(m):
        yield m
        for c in m.get("children", []):
            yield from walk(c)

    rep = warm.last_report.to_dict()
    join = next(m for m in walk(rep["plan"]) if m["kind"] == "join")
    static_b, meas_b = join["est_bytes"], join["bytes"]
    if not meas_b or meas_b > static_b / 16:
        fail(f"workload not selective enough: measured {meas_b} vs "
             f"static {static_b}")
    clamp = meas_b * 3
    if static_b / clamp <= 8:
        fail(f"clamp {clamp} would not shed the static estimate "
             f"{static_b}")

    svc = QueryService(name="stats-smoke")

    # -- first sight under the clamp: SHED on the static estimate ------
    inject.arm(f"pool:{clamp}:oom")
    try:
        tk = svc.submit(pipe(), tenant="loop")
        svc.drain(timeout=600)
        if tk.outcome != "shed":
            fail(f"first-sight query outcome {tk.outcome!r}, wanted "
                 f"shed (clamp {clamp}, static {static_b})")
        shed = [a for a in flight.admissions()
                if a.get("action") == "shed"][-1]
        if shed.get("est_source") != "static":
            fail(f"first-sight shed not static-sourced: {shed}")
        decisions.append(tk.outcome)
    finally:
        inject.disarm()
    out.ok("first_sight_shed")

    # -- learn the shape unclamped (>= CYLON_STATS_MIN_OBS runs), plus
    # the groupby shape for q-error kind diversity ----------------------
    lines0 = len(querylog.recent())
    tickets = [svc.submit(pipe(), tenant="loop") for _ in range(2)]
    tickets += [svc.submit(groupby_pipe(), tenant="loop")
                for _ in range(2)]
    svc.drain(timeout=600)
    for tk in tickets:
        if tk.outcome != "ok":
            fail(f"learning query outcome {tk.outcome!r}")
        tk.result(timeout=60)
    if len(querylog.recent()) - lines0 != 4:
        fail("querylog incomplete during the learning phase")

    # -- repeat under the SAME clamp: ADMITTED on measured stats -------
    m0 = measured_admits()
    inject.arm(f"pool:{clamp}:oom")
    try:
        tk = svc.submit(pipe(), tenant="loop")
        fresh = svc.submit(fresh_shape(), tenant="loop")
        svc.drain(timeout=600)
        if tk.outcome != "ok":
            fail(f"learned repeat outcome {tk.outcome!r}, wanted ok — "
                 f"the loop did not close")
        tk.result(timeout=60)
        if fresh.outcome != "shed":
            fail(f"fresh-shape outcome {fresh.outcome!r}, wanted shed "
                 f"— static soundness broken")
        d = [q for q in querylog.recent()
             if q["query_id"] == tk.query_id][-1]
        if d["est_source"] != "measured" or d["admission"] != "admit":
            fail(f"repeat digest not measured-admitted: {d}")
        if d["est_bytes"] is None or d["est_bytes"] > static_b:
            fail(f"measured estimate above the static bound: "
                 f"{d['est_bytes']} vs {static_b}")
        admit_bytes = d["est_bytes"]
        if measured_admits() <= m0:
            fail("cylon_admission_est_source_total{source=measured} "
                 "did not move")
        decisions += [tk.outcome, fresh.outcome]
    finally:
        inject.disarm()
    out.ok("learned_admit")
    out.ok("fresh_shape_sheds")

    # -- observatory: q-error series + /stats route --------------------
    status, prom = get("/metrics")
    if status != 200:
        fail(f"/metrics status {status}")
    for kind in ("join", "groupby"):
        if f'cylon_estimate_qerror_bucket{{kind="{kind}"' not in prom:
            fail(f"cylon_estimate_qerror{{kind={kind}}} missing from "
                 f"/metrics")
    status, st = get("/stats")
    if status != 200:
        fail(f"/stats status {status}")
    st = json.loads(st)
    if st["plan_count"] < 1 or st["node_count"] < 2:
        fail(f"/stats payload too empty: {st['plan_count']} plans, "
             f"{st['node_count']} nodes")
    kinds = {e["kind"] for e in st["nodes"]}
    if not kinds >= {"join", "groupby"}:
        fail(f"/stats node kinds incomplete: {kinds}")
    if "join" not in st["qerror"] or "p95" not in st["qerror"]["join"]:
        fail(f"/stats q-error summary incomplete: {st.get('qerror')}")
    top = st["nodes"][0]
    if top["obs"] < 2 or top["metrics"]["bytes"]["ewma"] is None:
        fail(f"/stats top node lacks observations/EWMA: {top}")
    out.ok("observatory")

    # -- clean shutdown -----------------------------------------------
    svc.close()
    if any(th.name == "cylon-obs" for th in threading.enumerate()):
        fail("obs endpoint thread leaked past svc.close()")
    del tickets, tk, fresh, warm, rep, join, d
    gc.collect()
    if ledger.leak_count() != leaks0:
        fail(f"ledger leaks: "
             f"{ledger.outstanding(include_borrowed=False)}")
    out.ok("clean_shutdown")

    print(f"stats smoke: OK — first-sight shed (static "
          f"{static_b} B vs clamp {clamp} B), learned in 2 runs, "
          f"repeat admitted measured ({admit_bytes} B), fresh "
          f"shape still sheds, q-error series live for {kinds}, "
          f"/stats served {st['node_count']} node fingerprints, "
          f"zero leaks")
    # the same decisions on both devices: the clamp binds on each
    out.emit(decisions=decisions, clamp=clamp, static_bytes=static_b,
             measured_bytes=admit_bytes,
             comm_budget=ctx.memory_pool.comm_budget_bytes())


if __name__ == "__main__":
    main(drill_common.parse_device(description=__doc__.split("\n")[0]))
