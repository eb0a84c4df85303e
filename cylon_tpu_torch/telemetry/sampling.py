"""Overhead-bounded head sampling for root query spans.

Counterpart of cylon_tpu.telemetry.sampling: the same names, labels, keys
and knobs.

At high QPS the span TREE dominates observability cost — every child
span serializes one JSONL line, annotates the device trace, and logs.
Counters and histograms are O(1) per event and stay cheap forever;
traces are O(spans) per query. Head sampling keeps the aggregate
signals complete while bounding the per-query trace cost:

* the sampling decision is made ONCE, when a ROOT span opens
  (``CYLON_TRACE_SAMPLE_RATE``, default 1.0 = record everything), and
  every child span inherits it;
* it is a **pure function of the query id** — sha256 of the stamped
  ``query_id`` root attribute (the service scheduler's monotonic id;
  the root's own span_id outside the service) mapped to [0, 1) and
  compared against the rate. No RNG: the same query id samples the
  same way in every process, so a drill or a bug report replays
  byte-identically (``decide(query_id)`` answers "was this recorded?"
  offline);
* a sampled-out query still FEEDS everything aggregate — phase-latency
  histograms, counters, the query-log digest, the SLO tracker, the
  flight ring — but its spans skip the trace sinks (JSONL lines) and
  the ``record_function`` / NVTX carrier;
* **errored queries are always promoted to fully recorded**: the span
  tree is kept in memory until the root closes (it must be — the
  flight recorder's crash dump serializes it), so when a sampled-out
  root closes errored, spans.span walks the completed tree through the
  sinks post-hoc (children before parents, the JSONL invariant) and
  the crash dump never degrades. ``cylon_trace_promotions_total``
  counts those late recordings.

What stays ON for sampled-out queries, by design: span objects are
still constructed and linked (the crash-dump/promotion contract and
the EXPLAIN ANALYZE recorder depend on the tree), per-span HBM attrs
follow their own knob (``CYLON_HBM_SPAN_ATTRS``), and INFO logging
follows the logger level. What sampling bounds is the per-span EXPORT
work — serialization and device-trace annotation — which is where the
volume cost lives.
"""
from __future__ import annotations

import hashlib
from typing import Optional

from . import knobs as _knobs
from . import metrics as _metrics

DEFAULT_RATE = _knobs.default("CYLON_TRACE_SAMPLE_RATE")


def rate() -> float:
    """The live sampling rate, clamped to [0, 1]."""
    return min(float(_knobs.get("CYLON_TRACE_SAMPLE_RATE")), 1.0)


def fraction(key) -> float:
    """Map a query id to a stable fraction in [0, 1): the first 8
    bytes of sha256(str(key)) as a big-endian integer over 2**64.
    Pure — no process seed, no RNG state — so the same id lands on
    the same side of any rate everywhere, forever."""
    digest = hashlib.sha256(str(key).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


def decide(key, sample_rate: Optional[float] = None) -> bool:
    """True when the query identified by ``key`` is head-sampled into
    full trace recording at ``sample_rate`` (default: the live knob)."""
    r = rate() if sample_rate is None else min(float(sample_rate), 1.0)
    if r >= 1.0:
        return True
    if r <= 0.0:
        return False
    return fraction(key) < r


# the decision counters, resolved once — record_decision runs on every
# root span, and reset_metrics() zeroes in place so the references
# stay live across test resets
_recorded = _metrics.REGISTRY.counter(
    "cylon_trace_sampled_total", {"decision": "recorded"})
_sampled_out = _metrics.REGISTRY.counter(
    "cylon_trace_sampled_total", {"decision": "sampled_out"})
_promotions = _metrics.REGISTRY.counter("cylon_trace_promotions_total")


def record_decision(sampled: bool) -> None:
    """Count one root-span head decision —
    ``cylon_trace_sampled_total{decision=recorded|sampled_out}``."""
    (_recorded if sampled else _sampled_out).inc()


def record_promotion() -> None:
    """Count one errored sampled-out root promoted to fully recorded
    (``cylon_trace_promotions_total``)."""
    _promotions.inc()
