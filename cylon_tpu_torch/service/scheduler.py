"""Concurrent query scheduler: multi-tenant fair-share queueing over
LazyTable queries (counterpart of cylon_tpu.service.scheduler).

Everything below this module runs ONE blocking ``collect()`` at a time;
this is the tier that turns the library into a service. Submitted
queries enter per-tenant FIFO queues; a **deficit-round-robin** sweep
over tenants picks the next query (cost = the planner's pre-flight byte
estimate, so one tenant's huge joins cannot starve another's cheap
lookups); a single executor worker thread drains the pick.

Pipelining discipline: **device execution stays serialized** on one
worker thread. Two queries interleaving their exchanges would corrupt
the virtual world's send stacks (every shard's blocks of one exchange
are staged in shared per-call tensors and one op-sequence) and the
kernel launch counters (``ops/kernels.LAUNCHES``), and on a process
group two interleaved queries would issue their collectives in
different orders on different processes and deadlock. The expensive
HOST work pipelines around it: ``submit()`` runs optimization (through
the plan/fingerprint cache, service/plancache) and the pre-flight
estimates on the CALLER's thread, concurrently with whatever the worker
is executing. Admission is decided by the worker at DISPATCH time, so
it sees the device memory the queries before it still hold (the pool's
``comm_budget_bytes`` reads the CUDA caching allocator's live bytes),
not a static snapshot from submit time.

The card: the worker launches on its own thread, on the current stream
of that thread, which is the device's default stream (no side stream
is ever set), so a result handed to a submitter is ordered after the
kernels that produced it. A ticket's ``outcome = "ok"`` means the query
was launched, not that the card finished it (as the JAX package's
asynchronous dispatch does): a caller that times a query synchronizes
the device itself. The context's device carries its index
(``context.resolve_device``), so the worker's first CUDA call needs no
``torch.cuda.set_device``.

Backpressure before queueing: once the total queue depth reaches
``CYLON_SERVICE_QUEUE_MAX`` (default 256), ``submit()`` raises a typed
:class:`CylonResourceExhausted` BEFORE enqueue and records the
rejection — with its tenant — in the flight recorder's admission ring,
so a load-shedding service leaves the same forensic trail as an
admission-controller shed.

Every query's fate is observable:

* ``cylon_service_queue_depth{tenant=}``   live queue depth gauges
* ``cylon_service_wait_seconds``           submit→dispatch histogram
* ``cylon_queries_total{tenant=,outcome=}`` ok / shed / error / timeout
* the tenant (+ query id + service name) rides every ROOT span the
  query opens (``telemetry.root_attrs``), so EXPLAIN ANALYZE trees,
  flight-ring entries and crash dumps all say whose query it was;
* admission decisions are recorded with the tenant label
  (``resilience.admission.record(decision, tenant=)``).

Env knobs: ``CYLON_SERVICE_QUEUE_MAX`` (queue bound),
``CYLON_SERVICE_QUANTUM_BYTES`` (DRR quantum, default 1 MiB). See
docs/service.md for the full catalog and semantics.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, Optional

from ..plan import ir
from ..plan.executor import (execute as _execute,
                             execute_analyzed as _execute_analyzed)
from ..plan.report import calibrate_estimates, preflight_estimates
from ..resilience import admission as _admission
from ..resilience import retry as _retry
from ..status import (Code, CylonPlanError, CylonResourceExhausted,
                      CylonTimeoutError)
from ..telemetry import flight as _flight
from ..telemetry import knobs as _knobs
from ..telemetry import logger as _logger
from ..telemetry import metrics as _metrics
from ..telemetry import root_attrs as _root_attrs
from ..telemetry import stats as _stats
from . import plancache as _plancache

DEFAULT_QUEUE_MAX = _knobs.default("CYLON_SERVICE_QUEUE_MAX")
DEFAULT_QUANTUM_BYTES = _knobs.default("CYLON_SERVICE_QUANTUM_BYTES")

# submit→dispatch wait histogram bounds, in SECONDS (the default
# bucket set is ms-scaled for span latencies; queue waits span
# sub-millisecond drains to multi-second backlogs)
WAIT_BUCKETS_S = (0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
                  5.0, 30.0, 120.0)

OUTCOMES = ("ok", "shed", "error", "timeout")

_query_ids = itertools.count(1)


def queue_max() -> int:
    return _knobs.get("CYLON_SERVICE_QUEUE_MAX")


def quantum_bytes() -> int:
    return _knobs.get("CYLON_SERVICE_QUANTUM_BYTES")


class QueryTicket:
    """Future-style handle for one submitted query.

    ``result()`` blocks until the worker finishes the query and either
    returns its Table or re-raises the query's TYPED error (a shed
    raises :class:`CylonResourceExhausted`, a deadline expiry
    :class:`CylonTimeoutError` — the same taxonomy a direct
    ``collect()`` surfaces). ``outcome`` is one of ``ok | shed |
    error | timeout`` once done; ``wait_s`` the measured submit→
    dispatch queue wait; ``dispatch_seq`` the service-wide dispatch
    order (the scheduler-fairness observable the DRR tests pin)."""

    def __init__(self, query_id: int, tenant: str):
        self.query_id = query_id
        self.tenant = tenant
        self.outcome: Optional[str] = None
        self.wait_s: Optional[float] = None
        self.dispatch_seq: Optional[int] = None
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._report = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise CylonTimeoutError(
                f"query {self.query_id} (tenant {self.tenant!r}) not "
                f"finished within {timeout} s")
        if self._error is not None:
            raise self._error
        return self._result

    def report(self, timeout: Optional[float] = None):
        """The EXPLAIN ANALYZE ``PlanReport`` (``analyze=True``
        submissions only; None otherwise). Blocks like ``result`` but
        never raises the query error — forensics stay readable for
        failed queries too."""
        self._done.wait(timeout)
        return self._report

    def _finish(self, outcome: str, result=None, error=None,
                report=None) -> None:
        self.outcome = outcome
        self._result = result
        self._error = error
        self._report = report
        self._done.set()

    def __repr__(self):
        state = self.outcome or ("queued" if not self._done.is_set()
                                 else "done")
        return (f"QueryTicket(id={self.query_id}, "
                f"tenant={self.tenant!r}, {state})")


class _Job:
    __slots__ = ("ticket", "tenant", "root", "stats", "est", "cost",
                 "ctx", "analyze", "deadline_s", "t_submit",
                 "cache_doc")

    def __init__(self, ticket, tenant, root, stats, est, cost, ctx,
                 analyze, deadline_s, cache_doc=None):
        self.ticket = ticket
        self.tenant = tenant
        self.root = root
        self.stats = stats
        self.est = est
        self.cost = cost
        self.ctx = ctx
        self.analyze = analyze
        self.deadline_s = deadline_s
        self.t_submit = time.monotonic()
        # plan-cache fate from the submit thread's optimize() —
        # {"plan_fp", "plan_cache"} — stamped onto the query's root
        # span for the structured query log
        self.cache_doc = cache_doc or {}


def _job_cost(est: dict, root: ir.PlanNode) -> int:
    """A query's DRR cost: the sum of its ALLOCATING node estimates
    (Scans excluded — borrowed inputs are history, not work), floored
    at 1 so estimate-free plans still round-robin."""
    total = 0
    for n in ir.walk(root):
        if n.kind == "scan":
            continue
        b = est.get(id(n), {}).get("bytes")
        if b:
            total += int(b)
    return max(total, 1)


class QueryService:
    """The concurrent query service: submit many LazyTable queries,
    get :class:`QueryTicket` futures back; one worker thread drains
    the per-tenant queues under deficit round-robin.

    ``start=False`` builds the service paused (submissions queue but
    nothing executes) — the chaos drill uses it to make dispatch order
    a pure function of the submission sequence. ``close()`` drains the
    remaining queue and joins the worker; the service is also a
    context manager (``with QueryService() as svc: ...``)."""

    def __init__(self, name: str = "cylon", start: bool = True):
        self.name = name
        self._cv = threading.Condition()
        self._queues: "OrderedDict[str, Deque[_Job]]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._last_served: Optional[str] = None
        self._depth = 0
        self._dispatched = 0
        self._active: Optional[_Job] = None
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        self._obs = None               # obs_http.ObsServer when armed
        if start:
            self.start()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Start the executor worker (idempotent) — and, when
        ``CYLON_OBS_PORT`` is nonzero, the observability HTTP endpoint
        (``service/obs_http.py``) serving this service's /metrics,
        /healthz, /queries, /slo and /stats on a daemon thread. When
        ``CYLON_STATS_PATH`` names a saved statistics snapshot, the
        warehouse warm-starts from it BEFORE the first dispatch, so a
        fresh replica's repeat-shape queries get measured-calibrated
        admission from query 1 (a corrupt snapshot is quarantined —
        never blocks startup)."""
        with self._cv:
            if self._worker is not None or self._closed:
                return
        # warm-start outside the lock (file IO must not block
        # submitters); the worker is not running yet, so no dispatch
        # precedes the load — and load() merges via setdefault, so a
        # racing second start() loading again is harmless
        _stats.load()
        obs = None
        with self._cv:
            if self._worker is not None or self._closed:
                return
            self._worker = threading.Thread(
                target=self._run, name=f"cylon-service-{self.name}",
                daemon=True)
            self._worker.start()
            port = _knobs.get("CYLON_OBS_PORT")
            if port and self._obs is None:
                from . import obs_http as _obs_http

                obs = self._obs = _obs_http.ObsServer(service=self,
                                                      port=port)
        if obs is not None:
            # bind+serve OUTSIDE the lock: a bad port must not wedge
            # the scheduler, and the obs thread scrapes health() which
            # takes this same lock
            try:
                obs.start()
            except OSError:
                _logger.exception(
                    "service %s: observability endpoint failed to "
                    "bind port %s — continuing without it",
                    self.name, obs.requested_port)
                with self._cv:
                    self._obs = None
                return
            # a close() may have raced this start() and discarded the
            # handle before the bind — it had nothing to stop then, so
            # stop the now-live endpoint here or it outlives close()
            with self._cv:
                leaked = obs if self._closed or self._obs is not obs \
                    else None
            if leaked is not None:
                leaked.close()

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the remaining queue, stop the worker, reject further
        submissions. Closing a PAUSED service (built with
        ``start=False``, never started) has no worker to drain the
        queue — its still-queued tickets finish typed
        (:class:`CylonPlanError`, outcome ``error``) instead of
        hanging their waiters forever."""
        orphans = []
        with self._cv:
            already_closed = self._closed
            self._closed = True
            worker = self._worker
            obs, self._obs = self._obs, None
            if worker is None:
                for t, q in self._queues.items():
                    orphans.extend(q)
                    q.clear()
                    self._depth_gauge(t).set(0)
                self._depth = 0
            self._cv.notify_all()
        for job in orphans:
            self._count_outcome(job.tenant, "error")
            job.ticket._finish("error", error=CylonPlanError(
                f"service {self.name!r} closed before query "
                f"{job.ticket.query_id} (tenant {job.tenant!r}) was "
                f"dispatched", code=Code.Invalid))
        if worker is not None:
            worker.join(timeout)
        if obs is not None:
            # after the worker: the endpoint stays scrapeable while
            # the drain finishes, then shuts down with its thread
            # joined (no leaked obs thread past close())
            obs.close(timeout)
        # snapshot the statistics warehouse AFTER the drain: every
        # query this service ran has fed its digest by now, so the
        # file the next replica warm-starts from carries the full run
        # (no-op unless CYLON_STATS_PATH is set; never raises). Only
        # a STARTED service saves — start() is what merged the
        # existing snapshot into the store, so a never-started (or
        # re-)close() must not rotate a learned warm-start file aside
        # and replace it with a near-empty one
        if worker is not None and not already_closed:
            _stats.save()

    def __enter__(self) -> "QueryService":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission -----------------------------------------------------

    def submit(self, query, tenant: str = "default",
               analyze: bool = False,
               deadline_s: Optional[float] = None) -> QueryTicket:
        """Queue one LazyTable query for the ``tenant``; returns its
        ticket immediately.

        The host-side heavy lifting happens HERE, on the caller's
        thread — optimization through the plan/fingerprint cache and
        the pre-flight byte estimates — pipelined against whatever the
        worker is executing. Raises :class:`CylonResourceExhausted`
        (typed backpressure) when the service queue is full, BEFORE
        the query is queued or any device work happens."""
        if not hasattr(query, "optimized"):
            raise CylonPlanError(
                f"submit() takes a LazyTable-style query (got "
                f"{type(query).__name__})")
        with self._cv:
            if self._closed:
                raise CylonPlanError(
                    f"service {self.name!r} is closed",
                    code=Code.Invalid)
        qid = next(_query_ids)
        ticket = QueryTicket(qid, tenant)
        # host-side prepare (no lock, no device work): optimize via the
        # fingerprint cache + pre-flight estimates over the result.
        # The cache fate (fp, hit/miss) is read back thread-locally —
        # this thread's optimize, not a racing submitter's — and rides
        # the job into the query-log digest.
        _plancache.clear_last_event()
        root, stats = query.optimized()
        cache_doc = dict(_plancache.last_event() or {})
        if not cache_doc.get("plan_fp"):
            # cache disabled/bypassed: derive the LOGICAL-plan
            # fingerprint directly so the digest and the statistics
            # warehouse still key this query (same key space as the
            # cache — drift eviction must match it)
            fp_fn = getattr(query, "plan_fingerprint", None)
            if fp_fn is not None:
                cache_doc["plan_fp"] = fp_fn()
        est = preflight_estimates(root)
        cost = _job_cost(est, root)
        ctx = getattr(query, "context", None)
        job = _Job(ticket, tenant, root, stats, est, cost, ctx,
                   analyze, deadline_s, cache_doc=cache_doc)
        with self._cv:
            if self._closed:
                raise CylonPlanError(
                    f"service {self.name!r} is closed",
                    code=Code.Invalid)
            cap = queue_max()
            if self._depth >= cap:
                # typed backpressure BEFORE enqueue — and the same
                # forensic trail as an admission shed, tenant included
                _flight.record_admission({
                    "action": "shed", "tenant": tenant,
                    "query_id": qid, "est_bytes": cost,
                    "budget": None,
                    "reason": f"service queue full (depth "
                              f"{self._depth} >= "
                              f"CYLON_SERVICE_QUEUE_MAX {cap})"})
                self._count_outcome(tenant, "shed")
                raise CylonResourceExhausted(
                    f"service {self.name!r} queue full: depth "
                    f"{self._depth} >= CYLON_SERVICE_QUEUE_MAX {cap} "
                    f"(tenant {tenant!r}, query {qid})")
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._deficit.setdefault(tenant, 0.0)
            q.append(job)
            self._depth += 1
            self._depth_gauge(tenant).set(len(q))
            self._cv.notify_all()
        return ticket

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every queued query has been dispatched AND
        finished; raises :class:`CylonTimeoutError` on timeout. Starts
        the worker if the service was built paused."""
        self.start()
        deadline = None if timeout is None else \
            time.monotonic() + timeout
        with self._cv:
            while self._depth > 0 or self._active is not None:
                rem = None if deadline is None else \
                    deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    raise CylonTimeoutError(
                        f"service drain timed out with {self._depth} "
                        f"queued + "
                        f"{1 if self._active is not None else 0} "
                        f"running")
                self._cv.wait(rem)

    def depth(self, tenant: Optional[str] = None) -> int:
        with self._cv:
            if tenant is None:
                return self._depth
            q = self._queues.get(tenant)
            return len(q) if q is not None else 0

    def health(self) -> dict:
        """One lock-consistent liveness snapshot — the observability
        endpoint's ``/healthz`` payload: worker liveness, total and
        per-tenant queue depths, the in-flight query, dispatch
        count."""
        with self._cv:
            worker = self._worker
            active = self._active
            doc = {
                "service": self.name,
                "closed": self._closed,
                "worker_alive": worker is not None and
                worker.is_alive(),
                "queue_depth": self._depth,
                "queue_depth_by_tenant": {
                    t: len(q) for t, q in self._queues.items()},
                "dispatched": self._dispatched,
                "active": None if active is None else {
                    "query_id": active.ticket.query_id,
                    "tenant": active.tenant},
            }
        return doc

    # -- scheduling (deficit round-robin) -------------------------------

    def _depth_gauge(self, tenant: str):
        return _metrics.REGISTRY.gauge("cylon_service_queue_depth",
                                       {"tenant": tenant})

    def _count_outcome(self, tenant: str, outcome: str) -> None:
        _metrics.REGISTRY.counter(
            "cylon_queries_total",
            {"tenant": tenant, "outcome": outcome}).inc()

    def _pick_locked(self) -> Optional[_Job]:
        """One DRR pick (caller holds the lock): sweep active tenants
        cyclically starting after the last-served one; each visit adds
        a quantum to the tenant's deficit; the first tenant whose
        deficit covers its head query's cost is served. Computed in
        closed form (no per-round loop), so a pathological byte
        estimate cannot spin the scheduler. An emptied queue forfeits
        its residual deficit — the classic DRR anti-hoarding rule."""
        active = [t for t, q in self._queues.items() if q]
        if not active:
            return None
        # rotation: continue AFTER the tenant served last
        if self._last_served in active:
            i = active.index(self._last_served) + 1
            active = active[i:] + active[:i]
        q = float(quantum_bytes())
        best = None  # ((rounds, order_idx), tenant)
        for idx, t in enumerate(active):
            need = self._queues[t][0].cost - self._deficit[t]
            rounds = 1 if need <= q else -int(-need // q)  # ceil, >= 1
            key = (rounds, idx)
            if best is None or key < best[0]:
                best = (key, t)
        (r_serve, i_serve), serve = best
        # fast-forward every tenant's deficit by the visits it received
        # before the serving visit in the cyclic sweep
        for idx, t in enumerate(active):
            visits = r_serve if idx <= i_serve else r_serve - 1
            if visits > 0:
                self._deficit[t] += visits * q
        job = self._queues[serve].popleft()
        self._deficit[serve] = max(
            self._deficit[serve] - job.cost, 0.0)
        if not self._queues[serve]:
            self._deficit[serve] = 0.0
        self._last_served = serve
        self._depth -= 1
        self._depth_gauge(serve).set(len(self._queues[serve]))
        return job

    # -- the executor worker --------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cv:
                job = self._pick_locked()
                while job is None:
                    if self._closed:
                        return
                    self._cv.wait()
                    job = self._pick_locked()
                self._active = job
                self._dispatched += 1
                job.ticket.dispatch_seq = self._dispatched
            try:
                self._dispatch(job)
            finally:
                with self._cv:
                    self._active = None
                    self._cv.notify_all()

    def _dispatch(self, job: _Job) -> None:
        """Admit, then execute, one query; deliver its fate to the
        ticket. Never raises — the worker must survive every query."""
        ticket = job.ticket
        wait_s = time.monotonic() - job.t_submit
        ticket.wait_s = wait_s
        _metrics.REGISTRY.histogram(
            "cylon_service_wait_seconds",
            buckets=WAIT_BUCKETS_S).observe(wait_s)
        # dispatch-time admission: the budget reads the allocator's live
        # bytes, so queries admitted now see the memory the PREVIOUS
        # queries' held results still pin
        pool = getattr(job.ctx, "memory_pool", None) \
            if job.ctx is not None else None
        budget = _admission.effective_budget(pool)
        world = job.ctx.get_world_size() \
            if job.ctx is not None and job.ctx.is_distributed() else 1
        # calibrate at DISPATCH time, not submit time: a queued query
        # admitted now sees the statistics the queries ahead of it
        # just taught the warehouse (idempotent — the executor's
        # _preflight skips nodes already calibrated)
        calibrate_estimates(job.root, job.est, world)
        decision = _admission.decide(list(ir.walk(job.root)), job.est,
                                     budget, world)
        outcome, result, report, error = "error", None, None, None
        try:
            with _root_attrs(tenant=job.tenant,
                             query_id=ticket.query_id,
                             service=self.name,
                             wait_s=round(wait_s, 6),
                             admission=decision.action,
                             est_bytes=decision.est_bytes,
                             est_source=decision.est_source,
                             **job.cache_doc):
                # inside root_attrs so the non-admit plan.admission
                # marker span record() emits carries the tenant label
                _admission.record(decision, tenant=job.tenant)
                _admission.enforce(decision)
                with _retry.query_deadline(job.deadline_s):
                    if job.analyze:
                        result, report = _execute_analyzed(
                            job.root, job.ctx, stats=job.stats,
                            decision=decision, est=job.est)
                    else:
                        result = _execute(job.root, job.ctx,
                                          decision=decision,
                                          est=job.est)
            outcome = "ok"
        except CylonTimeoutError as e:
            outcome, error = "timeout", e
            _logger.warning("service %s: query %d (tenant %s) timed "
                            "out: %s", self.name, ticket.query_id,
                            job.tenant, e)
        except CylonResourceExhausted as e:
            outcome, error = "shed", e
            _logger.warning("service %s: query %d (tenant %s) shed: "
                            "%s", self.name, ticket.query_id,
                            job.tenant, e)
        except Exception as e:
            outcome, error = "error", e
            _logger.warning("service %s: query %d (tenant %s) failed: "
                            "%s: %s", self.name, ticket.query_id,
                            job.tenant, type(e).__name__, e)
        self._count_outcome(job.tenant, outcome)
        ticket._finish(outcome, result=result, error=error,
                       report=report)
