#!/usr/bin/env python
"""Chaos drill of the port: seeded fault plans swept through the join ->
groupby pipeline on a world of 4 shards (counterpart of
scripts/chaos.py; run by scripts/torch_port/check.sh).

Proves the resilience layer end to end, deterministically:

* ``compile``    — an injected transient fault at the first kernel-
  library load (``ops/kernels.load_library``, a ``counted_cache``: a
  load from the ``_build/`` cache on disk is a build arrival too) is
  retried to success by the retry scope around the first exchange count
  (``lru_cache`` never caches the exception, so the retry loads again);
  the result equals the clean run. On the CPU no kernel library is ever
  loaded, so the scenario reports ``{"skipped": ...}`` there, the only
  skip the drill has;
* ``transient``  — an injected transient exchange fault (arrival index
  varied by seed) is retried to success: ``cylon_retries_total`` > 0,
  ``[RETRY×n]`` in EXPLAIN ANALYZE, result equal to the clean run;
* ``overlap``    — a transient fault in the middle of a chunked
  exchange (``CYLON_EXCHANGE_CHUNK_BYTES=4096``): chunks > 0, a retry
  recorded, a result equal to the single-shot baseline. (The port's
  chunks run one after another, so it records no overlap measure.);
* ``persistent`` — a persistent exchange fault exhausts the retry budget
  and surfaces as a typed ``CylonTransientError`` plus one parseable
  crash dump whose ``faults`` section names the injected site;
* ``shed``       — a chaos-clamped budget (the ``pool`` fault site) makes
  the admission controller shed the query with
  ``CylonResourceExhausted`` before any device work;
* ``degrade``    — a moderately clamped budget on a one-shard plan
  degrades the join to the blocked path; the result equals the clean
  run;
* ``deadline``   — a ~zero ``CYLON_QUERY_DEADLINE_S`` surfaces as a typed
  ``CylonTimeoutError`` with a crash dump;
* ``stats``      — a corrupt statistics snapshot at service start-up is
  quarantined; an injected ~10x-rows drift on a learned fingerprint
  fires ``cylon_stats_drift_total``, evicts the plan-cache entry and
  sends the next admission back to static estimates, with results
  equal to an uncached baseline;
* ``mislearn``   — a statistics store poisoned with a 100x-understated
  build side makes the optimizer pick a broadcast join; the run measures
  the true sizes, drift fires, the cache entry is evicted and the next
  optimize reverts to the shuffle join, results equal throughout;
* ``service``    — 6 queries over two tenants plus one over-budget query
  through a paused-then-drained ``QueryService`` while a transient
  exchange fault is armed and the budget clamped: the faulted query
  retries to success, the over-budget one is shed typed, every other
  ticket equals its sequential baseline, the per-tenant counters
  balance.

On CUDA the real comm budget (a quarter of the card's free memory) is
far above the chaos clamps, so ``admission.effective_budget`` decides on
the clamp; on the CPU the budget is None and the clamp decides alone.
Both devices reach the same shed/degrade/admit decisions. Every scenario
checks that the ledger holds no new entry after its results are dropped.

Usage::

    python scripts/torch_port/chaos.py --seeds 3 [--device cuda|cpu]
    python scripts/torch_port/chaos.py --seed 1             # one seed
    python scripts/torch_port/chaos.py --seed 1 --scenario persistent

Each seed runs in a fresh subprocess (a cold in-process library cache
keeps the ``compile`` arrival index deterministic); a failure prints the
fault plan and the one-command replay line. The last stdout line is one
JSON object: the scenarios each seed ran, the wall time and the kernel
launches (``ops/kernels.LAUNCHES``) by kernel.
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import drill_common

# fast, deterministic backoff for the drill
os.environ.setdefault("CYLON_RETRY_BACKOFF_S", "0.001")

SCENARIOS = ("compile", "transient", "overlap", "persistent", "shed",
             "degrade", "deadline", "stats", "mislearn", "service")


class ChaosFailure(AssertionError):
    pass


def _check(ok, msg, scenario, seed, plan):
    if not ok:
        raise ChaosFailure(
            f"[{scenario}] {msg}\n"
            f"  fault plan: {plan!r}\n"
            f"  replay: CYLON_FAULT_PLAN={plan or ''!r} python "
            f"scripts/torch_port/chaos.py --seed {seed} --scenario "
            f"{scenario} --device {_DEVICE}")


# the device of this process's run (the replay line names it)
_DEVICE = "cuda"


# ---------------------------------------------------------------------------
# child: one seed, fresh process
# ---------------------------------------------------------------------------


def _tables(ct, ctx, n, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    left = ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "v": rng.normal(size=n).astype(np.float32),
        "z": rng.integers(0, 50, n).astype(np.int32)})
    right = ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "w": rng.normal(size=n).astype(np.float32)})
    return left, right


def _pipe(plan, left, right):
    return plan.scan(left).join(plan.scan(right), on="k") \
        .groupby("lt-2", ["rt-4"], ["sum"])


def _result_rows(table):
    import numpy as np

    d = table.to_pydict()
    ks = sorted(d)
    rows = sorted(zip(*(np.asarray(d[k]).tolist() for k in ks)))
    return ks, rows


def _same_result(a, b) -> bool:
    import numpy as np

    (ka, ra), (kb, rb) = _result_rows(a), _result_rows(b)
    if ka != kb or len(ra) != len(rb):
        return False
    return all(np.allclose(x, y, rtol=1e-5, atol=1e-5)
               for x, y in zip(np.asarray(ra, dtype=np.float64).T,
                               np.asarray(rb, dtype=np.float64).T))


def _retries(telemetry) -> int:
    snap = telemetry.metrics_snapshot()
    return sum(v for k, v in snap.items()
               if k.startswith("cylon_retries_total"))


def _outcomes(telemetry, tenant: str, outcome: str) -> int:
    key = (f'cylon_queries_total{{outcome="{outcome}",'
           f'tenant="{tenant}"}}')
    return telemetry.metrics_snapshot().get(key, 0)


def _leak_check(ledger, held, scenario, seed, plan):
    """Zero NEW leaks: after a scenario drops its results, the live
    non-borrowed entry count must return to ``held`` (the deliberately
    held baseline result)."""
    gc.collect()
    _check(ledger.leak_count() == held,
           f"ledger leaks after scenario (expected {held} held "
           f"entries): {ledger.outstanding()}",
           scenario, seed, plan)


def run_seed(seed: int, only=None, device: str = "cuda") -> dict:
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import plan, telemetry
    from cylon_tpu_torch.resilience import inject
    from cylon_tpu_torch.telemetry import flight, ledger

    global _DEVICE
    _DEVICE = device
    n = 2048 + 256 * (seed % 4)
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4),
                                          device=device)
    left, right = _tables(ct, ctx, n, seed)
    ran = {}

    def wants(name):
        return only is None or name == only

    # -- compile: first kernel-library load faults, retried -----------
    # MUST run first: arrival 1 is only the first load while the
    # process's library cache is cold. The CPU loads no library.
    if wants("compile") and ctx.device.type != "cuda":
        ran["compile"] = {"skipped": "no kernel library is loaded on "
                                     "the CPU"}
    elif wants("compile"):
        fp = "compile:1:transient"
        inject.arm(fp)
        r0 = _retries(telemetry)
        try:
            txt = _pipe(plan, left, right).explain(analyze=True)
        finally:
            inject.disarm()
        _check(_retries(telemetry) > r0,
               "no retry recorded for the injected compile fault",
               "compile", seed, fp)
        _check("[RETRY" in txt,
               f"no [RETRY marker in EXPLAIN ANALYZE:\n{txt}",
               "compile", seed, fp)
        loads = telemetry.metrics_snapshot().get(
            'cylon_kernel_factory_builds_total{factory="load_library"}', 0)
        _check(loads >= 1, "the faulted run loaded no kernel library",
               "compile", seed, fp)
        ran["compile"] = {"retries": _retries(telemetry) - r0,
                          "library_loads": loads}

    # clean baseline (after `compile` so its arrival index stays cold)
    baseline = _pipe(plan, left, right).execute()

    if "retries" in ran.get("compile", {}):
        # the faulted-and-retried run must have produced honest output
        redo = _pipe(plan, left, right).execute()
        _check(_same_result(redo, baseline),
               "post-compile-fault execution diverges from baseline",
               "compile", seed, "compile:1:transient")
        del redo

    # every tracked entry live PAST this point that is not the held
    # baseline result is a leak
    gc.collect()
    held = ledger.leak_count()

    # -- transient: Nth exchange launch faults, retried ---------------
    if wants("transient"):
        nth = 1 + seed % 2
        fp = f"exchange:{nth}:transient"
        inject.arm(fp)
        r0 = _retries(telemetry)
        p = _pipe(plan, left, right)
        try:
            txt = p.explain(analyze=True)
            result = p.execute()
        finally:
            inject.disarm()
        _check(_retries(telemetry) > r0,
               "no retry recorded for the injected exchange fault",
               "transient", seed, fp)
        _check("[RETRY" in txt,
               f"no [RETRY marker in EXPLAIN ANALYZE:\n{txt}",
               "transient", seed, fp)
        _check(_same_result(result, baseline),
               "retried run diverges from clean baseline",
               "transient", seed, fp)
        del result
        _leak_check(ledger, held, "transient", seed, fp)
        ran["transient"] = {"retries": _retries(telemetry) - r0,
                            "nth": nth}

    # -- overlap: transient fault mid-chunk-stream of the chunked
    # (double-buffered) exchange pipeline — the faulted chunk retries
    # idempotently and the result bit-matches the single-shot baseline
    if wants("overlap"):
        nth = 2 + seed % 3
        fp = f"exchange:{nth}:transient"
        os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = "4096"
        inject.arm(fp)
        r0 = _retries(telemetry)
        c0 = telemetry.metrics_snapshot().get(
            "cylon_exchange_chunks_total", 0)
        p = _pipe(plan, left, right)
        try:
            txt = p.explain(analyze=True)
            result = p.execute()
        finally:
            inject.disarm()
            os.environ.pop("CYLON_EXCHANGE_CHUNK_BYTES", None)
        chunks_moved = telemetry.metrics_snapshot().get(
            "cylon_exchange_chunks_total", 0) - c0
        _check(chunks_moved > 0,
               "forced chunk plan did not engage the chunked pipeline",
               "overlap", seed, fp)
        _check(_retries(telemetry) > r0,
               "no retry recorded for the fault mid-chunk-stream",
               "overlap", seed, fp)
        _check("[RETRY" in txt,
               f"no [RETRY marker in EXPLAIN ANALYZE:\n{txt}",
               "overlap", seed, fp)
        _check(_same_result(result, baseline),
               "chunked pipeline result diverges from the single-shot "
               "baseline after mid-stream retry", "overlap", seed, fp)
        del result
        _leak_check(ledger, held, "overlap", seed, fp)
        ran["overlap"] = {"retries": _retries(telemetry) - r0,
                          "nth": nth, "chunks": chunks_moved}

    # -- persistent: every exchange attempt faults -> typed + dump ----
    if wants("persistent"):
        fp = "exchange:1+:transient"
        dump_dir = tempfile.mkdtemp(prefix="cylon-chaos-")
        os.environ["CYLON_FLIGHT_DIR"] = dump_dir
        inject.arm(fp)
        err_text = None
        try:
            # capture TEXT, never the exception object: its traceback
            # would pin the executor frames (and their intermediate
            # tables) past the leak check below
            try:
                _pipe(plan, left, right).explain(analyze=True)
            except ct.CylonTransientError as e:
                err_text = str(e)
                err_class = type(e).__name__
            except Exception as e:  # noqa: BLE001 - asserted below
                _check(False, f"expected CylonTransientError, got "
                       f"{type(e).__name__}: {e}", "persistent", seed,
                       fp)
            else:
                _check(False, "persistent fault did not fail the query",
                       "persistent", seed, fp)
        finally:
            fault_state = inject.state()
            inject.disarm()
            os.environ.pop("CYLON_FLIGHT_DIR", None)
        _check("injected transient fault at exchange" in err_text,
               f"error does not name the fault: {err_text}",
               "persistent", seed, fp)
        dumps = [f for f in os.listdir(dump_dir) if f.endswith(".json")]
        _check(len(dumps) == 1, f"expected one crash dump, found "
               f"{dumps}", "persistent", seed, fp)
        doc = json.load(open(os.path.join(dump_dir, dumps[0])))
        faults = doc.get("sections", {}).get("faults", {})
        _check(any(f.get("site") == "exchange"
                   for f in faults.get("fired", [])),
               f"crash dump faults section does not name the exchange "
               f"site: {faults}", "persistent", seed, fp)
        _check(any(s["name"].startswith("plan.")
                   for s in doc.get("error_path", [])),
               f"crash dump error path has no plan span: "
               f"{[s['name'] for s in doc.get('error_path', [])]}",
               "persistent", seed, fp)
        _leak_check(ledger, held, "persistent", seed, fp)
        ran["persistent"] = {
            "fired": len(fault_state["fired"]), "dump": dumps[0],
            "error": err_class,
            "dump_sites": sorted({f.get("site")
                                  for f in faults.get("fired", [])})}

    # -- shed: clamped budget -> admission sheds before device work ---
    if wants("shed"):
        fp = "pool:4096:oom"
        inject.arm(fp)
        err_text = None
        try:
            try:
                _pipe(plan, left, right).execute(analyze=True)
            except ct.CylonResourceExhausted as e:
                err_text = str(e)
            else:
                _check(False, "over-budget query was not shed", "shed",
                       seed, fp)
        finally:
            inject.disarm()
        _check("shed by admission controller" in err_text,
               f"unexpected shed error text: {err_text}", "shed", seed,
               fp)
        last = flight.admissions()[-1] if flight.admissions() else {}
        _check(last.get("action") == "shed",
               f"admission ring does not record the shed: {last}",
               "shed", seed, fp)
        _leak_check(ledger, held, "shed", seed, fp)
        ran["shed"] = {"decision": last,
                       "comm_budget": ctx.memory_pool.comm_budget_bytes()}

    # -- degrade: single-shard join over budget -> blocked path -------
    if wants("degrade"):
        fp = "pool:32768:oom"
        lctx = ct.CylonContext.Init(device)
        l2, r2 = _tables(ct, lctx, n, seed + 100)
        lpipe = plan.scan(l2).join(plan.scan(r2), on="k")
        clean = lpipe.execute()
        inject.arm(fp)
        try:
            p = plan.scan(l2).join(plan.scan(r2), on="k")
            degraded = p.execute(analyze=True)
            rep = p.last_report
        finally:
            inject.disarm()
        _check(rep.admission is not None
               and rep.admission.get("action") == "degrade",
               f"admission did not degrade: {rep.admission}",
               "degrade", seed, fp)
        _check(_same_result(degraded, clean),
               "degraded (blocked) join diverges from clean join",
               "degrade", seed, fp)
        last = flight.admissions()[-1] if flight.admissions() else {}
        _check(last.get("action") == "degrade",
               f"admission ring does not record the degrade: {last}",
               "degrade", seed, fp)
        del degraded, clean
        _leak_check(ledger, held, "degrade", seed, fp)
        ran["degrade"] = {"decision": last}

    # -- deadline: ~zero budget -> typed timeout + dump ---------------
    if wants("deadline"):
        dump_dir = tempfile.mkdtemp(prefix="cylon-chaos-")
        os.environ["CYLON_FLIGHT_DIR"] = dump_dir
        os.environ["CYLON_QUERY_DEADLINE_S"] = "0.000001"
        err_text = None
        try:
            try:
                _pipe(plan, left, right).execute(analyze=True)
            except ct.CylonTimeoutError as e:
                err_text = str(e)
            else:
                _check(False, "zero deadline did not time the query "
                       "out", "deadline", seed, None)
        finally:
            os.environ.pop("CYLON_QUERY_DEADLINE_S", None)
            os.environ.pop("CYLON_FLIGHT_DIR", None)
        _check("deadline exceeded" in err_text,
               f"unexpected timeout text: {err_text}", "deadline",
               seed, None)
        dumps = [f for f in os.listdir(dump_dir) if f.endswith(".json")]
        _check(len(dumps) == 1,
               f"expected one crash dump, found {dumps}", "deadline",
               seed, None)
        _leak_check(ledger, held, "deadline", seed, None)
        ran["deadline"] = {"dump": dumps[0]}

    # -- stats: corrupt snapshot quarantined; drift evicts + reverts --
    if wants("stats"):
        from cylon_tpu_torch.service import QueryService, plancache
        from cylon_tpu_torch.telemetry import querylog

        def snap_counter(name):
            return telemetry.metrics_snapshot().get(name, 0)

        # (a) corrupted stats file at startup -> quarantine + clean
        # start through the REAL startup path (QueryService.start)
        sdir = tempfile.mkdtemp(prefix="cylon-chaos-stats-")
        spath = os.path.join(sdir, "stats.jsonl")
        with open(spath, "w") as f:
            f.write("{corrupt" + "}" * (seed + 1) + "\n")
        os.environ["CYLON_STATS_PATH"] = spath
        q0 = snap_counter("cylon_stats_quarantine_total")
        try:
            svc = QueryService(name=f"chaos-stats-{seed}")
            svc.close()
        finally:
            os.environ.pop("CYLON_STATS_PATH", None)
        _check(snap_counter("cylon_stats_quarantine_total") == q0 + 1,
               "corrupt stats snapshot was not quarantined", "stats",
               seed, None)
        _check(os.path.exists(spath + ".quarantine"),
               "quarantined snapshot not preserved on disk", "stats",
               seed, None)
        quarantines = [d for d in flight.admissions()
                       if d.get("action") == "stats_quarantine"]
        _check(quarantines and
               "CylonDataError" in quarantines[-1].get("error", ""),
               f"no typed quarantine event in the admission ring: "
               f"{quarantines[-1:]}", "stats", seed, None)

        # (b) drift: learn a shape, then hit it with ~10x the rows
        os.environ["CYLON_STATS_MIN_OBS"] = "2"
        try:
            sl, sr = _tables(ct, ctx, n, seed + 200)

            def spipe(l, r):
                return plan.scan(l).join(plan.scan(r), on="k") \
                    .groupby("lt-2", ["rt-4"], ["min"])

            for _ in range(2):
                spipe(sl, sr).execute()
            learned = querylog.recent()[-1]
            _check(learned.get("est_source") == "measured",
                   f"learned shape not measured-calibrated: "
                   f"{learned.get('est_source')}", "stats", seed, None)
            d0 = snap_counter("cylon_stats_drift_total")
            m0 = snap_counter("cylon_plan_cache_misses_total")
            bl, br = _tables(ct, ctx, n * 10, seed + 201)
            drifted = spipe(bl, br).execute()
            _check(snap_counter("cylon_stats_drift_total") > d0,
                   "10x-rows run did not fire drift detection",
                   "stats", seed, None)
            drifts = [d for d in flight.admissions()
                      if d.get("action") == "stats_drift"]
            _check(bool(drifts), "no stats_drift event in the "
                   "admission ring", "stats", seed, None)
            # eviction: the next optimize of the learned shape MISSES
            spipe(sl, sr).optimized()
            _check(snap_counter("cylon_plan_cache_misses_total")
                   == m0 + 1,
                   "drift did not evict the cached plan template",
                   "stats", seed, None)
            # fallback: the next decision runs on static estimates
            after = spipe(bl, br)
            redo = after.execute()
            _check(querylog.recent()[-1].get("est_source") == "static",
                   f"post-drift admission did not fall back to static "
                   f"estimates: {querylog.recent()[-1]}", "stats",
                   seed, None)
            # ...and none of it perturbs data: bit-identical to an
            # uncached fresh execution
            with plancache.disabled():
                clean10 = spipe(bl, br).execute()
            _check(_same_result(drifted, clean10)
                   and _same_result(redo, clean10),
                   "drifted/post-drift results diverge from the "
                   "uncached baseline", "stats", seed, None)
            del drifted, redo, clean10, sl, sr, bl, br
        finally:
            os.environ.pop("CYLON_STATS_MIN_OBS", None)
        _leak_check(ledger, held, "stats", seed, None)
        ran["stats"] = {"quarantine": quarantines[-1]["error"][:60],
                        "drift": drifts[-1]["metric"]}

    # -- mislearn: poisoned stats -> unsound-by-stats broadcast choice
    # self-corrects via drift eviction, zero wrong results throughout
    if wants("mislearn"):
        from cylon_tpu_torch.plan.fingerprint import \
            join_decision_fingerprint
        from cylon_tpu_torch.plan.optimizer import BROADCAST_MIN_RATIO
        from cylon_tpu_torch.service import plancache
        from cylon_tpu_torch.telemetry import stats as stats_mod

        stats_mod.reset()
        ml, mr = _tables(ct, ctx, n, seed + 300)

        def mpipe():
            return plan.scan(ml).join(plan.scan(mr), on="k")

        with plancache.disabled():
            mbase = mpipe().execute()
        world = ctx.get_world_size()
        # poison: REPLACE the learned evidence with a build (right)
        # side measured at ~1/100 of its true size, the probe
        # comfortably past the ratio guard — the mis-learned state a
        # corrupted snapshot or a regime change could leave behind
        # (the baseline's own genuine observation is dropped first:
        # poisoning means the store's memory IS the lie)
        stats_mod.reset()
        real = float(mr.nbytes)
        assert float(ml.nbytes) >= BROADCAST_MIN_RATIO * real / 100.0
        fp = join_decision_fingerprint(mpipe()._node, world)
        for i in range(stats_mod.min_obs()):
            stats_mod.STORE._observe_node(
                "poisoned", fp, "join_input",
                {"left_bytes": float(ml.nbytes),
                 "right_bytes": max(real / 100.0, 1.0)},
                ("left_bytes", "right_bytes"), None, float(i))
        txt = mpipe().explain()
        _check("algo=broadcast" in txt,
               f"poisoned stats did not fire the broadcast rewrite:\n"
               f"{txt}", "mislearn", seed, None)
        d0 = telemetry.metrics_snapshot().get(
            "cylon_stats_drift_total", 0)
        bad_run = mpipe().execute()    # broadcast runs, measures truth
        _check(_same_result(bad_run, mbase),
               "mis-learned broadcast run diverges from the uncached "
               "baseline", "mislearn", seed, None)
        _check(telemetry.metrics_snapshot().get(
            "cylon_stats_drift_total", 0) > d0,
               "true input sizes did not fire drift on the poisoned "
               "fingerprint", "mislearn", seed, None)
        drifts = [d for d in flight.admissions()
                  if d.get("action") == "stats_drift"]
        _check(bool(drifts), "no stats_drift event in the admission "
               "ring", "mislearn", seed, None)
        txt2 = mpipe().explain()
        _check("algo=broadcast" not in txt2,
               f"drift did not revert the shape to shuffle:\n{txt2}",
               "mislearn", seed, None)
        good_run = mpipe().execute()
        _check(_same_result(good_run, mbase),
               "post-revert shuffle run diverges from the uncached "
               "baseline", "mislearn", seed, None)
        del bad_run, good_run, mbase, ml, mr
        stats_mod.reset()
        _leak_check(ledger, held, "mislearn", seed, None)
        ran["mislearn"] = {"drift": drifts[-1]["metric"],
                           "reverted": True}

    # -- service: concurrent submissions, fault + shed among them -----
    if wants("service"):
        from cylon_tpu_torch.service import QueryService

        clamp = 256 * 1024          # normal queries ~0.5x, big ~26x
        nth = 3 + seed % 3          # exchange arrival hit mid-stream
        fp = f"pool:{clamp}:oom,exchange:{nth}:transient"
        tenants = ("tenant-a", "tenant-b")
        tabs = {t: _tables(ct, ctx, n, seed + 10 + i)
                for i, t in enumerate(tenants)}
        big_l, big_r = _tables(ct, ctx, 1 << 16, seed + 50)
        # clean sequential baselines, BEFORE arming (the acceptance
        # bar: concurrent results bit-match sequential execution)
        baselines = {t: _pipe(plan, l, r).execute()
                     for t, (l, r) in tabs.items()}
        svc = QueryService(start=False)   # paused: dispatch order is a
        #                                   pure function of submission
        inject.arm(fp)
        r0 = _retries(telemetry)
        ok0 = {t: _outcomes(telemetry, t, "ok") for t in tenants}
        tickets = []
        try:
            for _ in range(3):
                for t, (l, r) in tabs.items():
                    tickets.append((t, svc.submit(_pipe(plan, l, r),
                                                  tenant=t)))
            big = svc.submit(
                plan.scan(big_l).join(plan.scan(big_r), on="k"),
                tenant="tenant-a")
            svc.drain(timeout=600)
        finally:
            inject.disarm()
            svc.close()
        _check(_retries(telemetry) > r0,
               "no retry recorded for the injected exchange fault "
               "during the service drill", "service", seed, fp)
        for t, tk in tickets:
            res = tk.result(timeout=60)
            _check(tk.outcome == "ok",
                   f"ticket {tk.query_id} ({t}) outcome "
                   f"{tk.outcome!r}, wanted ok", "service", seed, fp)
            _check(_same_result(res, baselines[t]),
                   f"concurrent result for {t} diverges from the "
                   f"sequential baseline", "service", seed, fp)
            del res
        err_text = None
        try:
            big.result(timeout=60)
        except ct.CylonResourceExhausted as e:
            err_text = str(e)
        else:
            _check(False, "over-budget service query was not shed",
                   "service", seed, fp)
        _check("shed by admission controller" in err_text,
               f"unexpected shed error text: {err_text}", "service",
               seed, fp)
        _check(big.outcome == "shed",
               f"shed ticket outcome {big.outcome!r}", "service",
               seed, fp)
        sheds = [d for d in flight.admissions()
                 if d.get("action") == "shed"]
        _check(sheds and sheds[-1].get("tenant") == "tenant-a",
               f"admission ring does not name the shed tenant: "
               f"{sheds[-1:]}", "service", seed, fp)
        for t in tenants:
            got = _outcomes(telemetry, t, "ok") - ok0[t]
            _check(got == 3,
                   f"cylon_queries_total{{tenant={t},outcome=ok}} "
                   f"moved by {got}, wanted 3", "service", seed, fp)
        n_retried = _retries(telemetry) - r0
        # drop every result reference (incl. the comparison loop vars)
        # before the zero-new-leaks assertion
        del big, tickets, baselines, tabs, big_l, big_r, svc, t, tk, l, r
        _leak_check(ledger, held, "service", seed, fp)
        ran["service"] = {"retries": n_retried, "nth": nth,
                          "shed": sheds[-1]}

    del baseline
    gc.collect()
    return ran


# ---------------------------------------------------------------------------
# parent: sweep seeds in fresh subprocesses
# ---------------------------------------------------------------------------


def sweep(seeds: int, scenario=None, device: str = "cuda") -> int:
    t0 = time.perf_counter()
    per_seed = {}
    launches = {}
    for seed in range(seeds):
        cmd = [sys.executable, os.path.abspath(__file__),
               "--seed", str(seed), "--device", device]
        if scenario:
            cmd += ["--scenario", scenario]
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            sys.stderr.write(r.stdout)
            sys.stderr.write(r.stderr)
            print(f"chaos: FAIL at seed {seed} — replay with: "
                  f"python scripts/torch_port/chaos.py --seed {seed} "
                  f"--device {device}"
                  + (f" --scenario {scenario}" if scenario else ""),
                  file=sys.stderr)
            return 1
        # last stdout line is the child's JSON summary
        child = drill_common.last_json(r.stdout)
        print(f"chaos: seed {seed} OK — {json.dumps(child['scenarios'])}")
        per_seed[seed] = child["scenarios"]
        for k, v in child["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"chaos: OK — {seeds} seed(s), all scenarios deterministic")
    print(json.dumps({"drill": "chaos", "device": device,
                      "checks": sorted({s for ran in per_seed.values()
                                        for s, v in ran.items()
                                        if "skipped" not in v}),
                      "seeds": per_seed,
                      "wall_s": round(time.perf_counter() - t0, 3),
                      "launches": launches}, default=str), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python scripts/torch_port/chaos.py",
        description="seeded chaos drill over the port's resilience "
                    "layer")
    p.add_argument("--seeds", type=int,
                   help="sweep seeds 0..N-1, one fresh subprocess each")
    p.add_argument("--seed", type=int,
                   help="run ONE seed in this process (the child/"
                        "replay mode)")
    p.add_argument("--scenario", choices=SCENARIOS,
                   help="restrict to one scenario")
    drill_common.add_device_arg(p)
    args = p.parse_args(argv)
    if args.seed is not None:
        t0 = time.perf_counter()
        before = drill_common.launches()
        ran = run_seed(args.seed, only=args.scenario, device=args.device)
        print(json.dumps({"drill": "chaos", "device": args.device,
                          "seed": args.seed, "scenarios": ran,
                          "checks": sorted(s for s, v in ran.items()
                                           if "skipped" not in v),
                          "wall_s": round(time.perf_counter() - t0, 3),
                          "launches": drill_common.launch_delta(before)},
                         default=str))
        return 0
    return sweep(args.seeds or 3, scenario=args.scenario,
                 device=args.device)


if __name__ == "__main__":
    sys.exit(main())
