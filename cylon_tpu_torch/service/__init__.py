"""The concurrent query service tier, the top of the cylon_tpu_torch
stack (counterpart of cylon_tpu.service).

Many LazyTable queries submitted at once, per-tenant fair-share
queueing (deficit round-robin), dispatch-time admission against the
card's live device memory, typed backpressure before enqueue, and a
plan/fingerprint cache so repeated query shapes skip optimization.

* ``scheduler`` — :class:`QueryService` / :class:`QueryTicket`: the
  async submission surface and the single executor worker (device
  execution stays serialized; host-side optimize/preflight pipelines
  on the submitters' threads).
* ``plancache`` — the structural plan fingerprint and the bounded LRU
  of optimized plans, shared between the service and library mode.
* ``obs_http`` — the live operational surface: a stdlib HTTP endpoint
  (``CYLON_OBS_PORT``) serving /metrics, /healthz, /queries, /slo and
  /stats.

Importing this package wires the plan cache into ``plan.lazy``'s
late-bound optimize memo (the hook keeps plan/ from importing
service/), so even plain ``LazyTable.collect()`` loops skip
re-optimizing repeated shapes. This package imports only plan/,
resilience/, telemetry/ and status; execution goes through plan/'s
executor.
"""
from __future__ import annotations

from . import obs_http, plancache, scheduler
from .obs_http import ObsServer
from .plancache import PlanCache, fingerprint, global_cache
from .scheduler import QueryService, QueryTicket

# library-mode wiring: LazyTable.optimized()/execute() memoize through
# the global fingerprint cache from the moment the package imports
plancache.install()

__all__ = [
    "ObsServer", "PlanCache", "QueryService", "QueryTicket",
    "fingerprint", "global_cache", "obs_http", "plancache",
    "scheduler",
]
