"""Bounded retry-with-backoff + the per-query deadline.

Counterpart of cylon_tpu.resilience.retry: the same sites, labels and
knobs.

Every retryable stage in the engine funnels through
:func:`run_retryable`: the exchange dispatch in `parallel/shuffle.py`
(which transitively covers the kernel-factory builds the dispatch
triggers — `functools.lru_cache` does not cache exceptions, so a
failed build rebuilds on retry) and the io ingest readers. Stages are
pure functions of their device inputs (eager torch launches), so re-
dispatching a failed program is always safe.

Policy, all env-tunable (docs/resilience.md):

* ``CYLON_RETRY_MAX``        total attempts per stage (default 3);
* ``CYLON_RETRY_BACKOFF_S``  base backoff before attempt 2 (default
  0.05 s), doubling per retry — deterministic, no jitter: two chaos
  replays of the same seed take the same path;
* ``CYLON_QUERY_DEADLINE_S`` per-query wall-clock budget. The plan
  executor opens :func:`query_deadline` around each query; retry
  loops, backoff sleeps and node boundaries all check it, raising
  :class:`CylonTimeoutError` — which crosses the query's root span and
  triggers the flight recorder's crash dump like any other failure.

Observability: each retry increments ``cylon_retries_total{site=}``
and, on eventual success, the enclosing span gains a ``retries`` attr
— EXPLAIN ANALYZE renders it as ``[RETRY×n]`` (plan/report.py). Only
:func:`status.is_retryable` errors retry; raw backend errors are first
mapped through ``status.classify`` so retryability is decided by type.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Callable, Iterator, Optional, TypeVar

from ..status import CylonTimeoutError, classify
from ..telemetry import annotate as _annotate
from ..telemetry import current_span as _current_span
from ..telemetry import knobs as _knobs
from ..telemetry import logger as _logger
from ..telemetry import metrics as _metrics

T = TypeVar("T")

DEFAULT_MAX_ATTEMPTS = _knobs.default("CYLON_RETRY_MAX")
DEFAULT_BACKOFF_S = _knobs.default("CYLON_RETRY_BACKOFF_S")


def max_attempts() -> int:
    return _knobs.get("CYLON_RETRY_MAX")


def backoff_base_s() -> float:
    return _knobs.get("CYLON_RETRY_BACKOFF_S")


# ---------------------------------------------------------------------------
# per-query deadline
# ---------------------------------------------------------------------------

# absolute time.monotonic() deadline of the enclosing query, or None
_deadline: ContextVar[Optional[float]] = ContextVar(
    "cylon_tpu_torch_query_deadline", default=None)


def _env_deadline_s() -> Optional[float]:
    s = _knobs.get("CYLON_QUERY_DEADLINE_S")
    return s if s is not None and s > 0 else None


@contextmanager
def query_deadline(seconds: Optional[float] = None) -> Iterator[None]:
    """Scope a wall-clock budget over a query (``seconds`` default:
    ``CYLON_QUERY_DEADLINE_S``; no-op when neither is set). Nested
    scopes keep the TIGHTER deadline — an outer budget can never be
    extended by an inner one."""
    s = seconds if seconds is not None else _env_deadline_s()
    if s is None:
        yield
        return
    new = time.monotonic() + s
    outer = _deadline.get()
    token = _deadline.set(min(new, outer) if outer is not None else new)
    try:
        yield
    finally:
        _deadline.reset(token)


def remaining_s() -> Optional[float]:
    """Seconds left on the enclosing query's deadline, or None."""
    d = _deadline.get()
    return None if d is None else d - time.monotonic()


def check_deadline(site: str = "") -> None:
    """Raise :class:`CylonTimeoutError` when the enclosing query's
    deadline has passed. Called at stage boundaries (executor node
    lowerings) and inside every retry loop."""
    rem = remaining_s()
    if rem is not None and rem <= 0:
        _metrics.REGISTRY.counter("cylon_deadline_exceeded_total").inc()
        raise CylonTimeoutError(
            f"query deadline exceeded ({-rem:.3f} s past budget"
            f"{', at ' + site if site else ''})")


# ---------------------------------------------------------------------------
# retry loop
# ---------------------------------------------------------------------------


def run_retryable(site: str, fn: Callable[[], T]) -> T:
    """Run ``fn`` with bounded retry-with-backoff on transient errors.

    Non-retryable failures re-raise immediately — mapped onto the typed
    taxonomy when ``classify`` recognizes them, so a raw CUDA
    RESOURCE_EXHAUSTED leaves this function as
    :class:`CylonResourceExhausted`. On success after n retries the
    current span gains ``retries=n`` and a warning is logged (a stage
    that needed retries is worth a human's glance even when it
    recovered)."""
    attempts = max_attempts()
    base = backoff_base_s()
    retries = 0
    while True:
        check_deadline(site)
        try:
            out = fn()
        except Exception as e:
            typed = classify(e)   # the one classification per failure
            retryable = typed is not None and typed.retryable
            if not retryable or retries + 1 >= attempts:
                if typed is not None and typed is not e:
                    raise typed from e
                raise
            retries += 1
            _metrics.REGISTRY.counter("cylon_retries_total",
                                      {"site": site}).inc()
            delay = base * (2 ** (retries - 1))
            rem = remaining_s()
            if rem is not None:
                delay = min(delay, max(rem, 0.0))
            _logger.warning(
                "retry %d/%d at %s after %s (backoff %.3f s)",
                retries, attempts - 1, site, e, delay)
            if delay > 0:
                time.sleep(delay)
            continue
        if retries:
            # ACCUMULATE into the enclosing span: two retried stages
            # under one node span (count + dispatch) must sum, so the
            # [RETRY×n] marker agrees with cylon_retries_total
            cur = _current_span()
            prior = int(cur.attrs.get("retries", 0)) \
                if cur is not None else 0
            _annotate(retries=prior + retries)
            _logger.warning("stage %s succeeded after %d retr%s",
                            site, retries,
                            "y" if retries == 1 else "ies")
        return out
