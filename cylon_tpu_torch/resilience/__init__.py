"""Resilient query execution: fault injection, retry, admission
(counterpart of cylon_tpu.resilience; same sites, labels and knobs).

The reference Cylon has no resilience story at all — an MPI rank
failure aborts the whole job (reference: any `MPI_Abort` path). Every
distributed op is partition + all-to-all + local kernel (PAPER.md layer
map), and each stage can fail transiently: a lost collective, a kernel
build failure, device memory exhaustion. This package
makes those failures survivable AND provable:

* ``inject``    — deterministic fault injection: seeded, env-driven
  fault plans (``CYLON_FAULT_PLAN="exchange:2:transient"``) fire typed
  errors at named choke points (exchange launch, kernel-factory build,
  admission budget, ingest), so every chaos run replays by seed.
* ``retry``     — bounded retry-with-backoff around retryable stages
  (``cylon_retries_total{site=}`` counter, ``retries`` span attr so
  EXPLAIN ANALYZE renders ``[RETRY×n]``) and the per-query deadline
  (``CYLON_QUERY_DEADLINE_S`` → :class:`CylonTimeoutError`).
* ``admission`` — the admission controller: before execution, the
  planner's pre-flight estimate is compared against the pool's budget
  (chaos-clampable) and the query is
  admitted, degraded to the blocked/chunked join path, or shed with
  :class:`CylonResourceExhausted`. Every decision lands in the flight
  recorder's admission ring.

Retryability itself is a property of the error (status.py taxonomy:
``CylonTransientError`` et al.), never a guess at the catch site.

Layering: resilience sits between the base leaves (status/telemetry)
and the execution layers — ``parallel/``, ``plan/`` and ``io/`` call
into it; it never imports them (``layering/resilience-below-exec``).
"""
from __future__ import annotations

from . import admission, inject, retry
from .retry import check_deadline, query_deadline, run_retryable

__all__ = ["admission", "inject", "retry", "run_retryable",
           "query_deadline", "check_deadline"]
