"""Structured tracing + metrics of the port (counterpart of
cylon_tpu.telemetry; same span labels, series names, attribute keys and
knobs).

* ``spans``   — hierarchical, contextvar-nested spans with typed
  attributes; ``phase``/``collect_phases`` are thin wrappers over it.
  The profiler carrier is ``torch.profiler.record_function`` plus an
  NVTX range on CUDA. While a torch profiler runs on CUDA (no knob), a
  span also times itself on the device with a pair of pooled CUDA
  events, enter to exit on the current stream (its children and the
  device's idle time inside it included), folded without blocking into
  ``cylon_span_device_ms_total{span=}`` and ``cylon_span_timed_total
  {span=}``; ``span_device_times()`` synchronizes once and returns
  ``{name: (ms, count)}``. With no profiler, and on the CPU, no event is
  recorded and neither counter moves.
* ``metrics`` — process-local counters (shuffle bytes, rows exchanged,
  collective launches, kernel-library builds), per-phase latency
  histograms, and device-memory gauges sampled from
  ``memory.MemoryPool`` (duck-typed).
* ``export``  — JSONL span sink and Prometheus text dump.
* ``skew``    — skew stats reduced from the exchange count matrices the
  host already holds (no extra sync).
* ``ledger``  — buffer lifetime ledger (``cylon_live_table_bytes
  {owner=}``, leak reports).
* ``flight``  — flight recorder: ring of recent root span trees, crash
  dumps to ``CYLON_FLIGHT_DIR``.
* ``querylog``, ``slo``, ``stats``, ``sampling`` — per-query digests,
  per-tenant latency objectives, the statistics warehouse that feeds
  the optimizer's adaptive rewrites and admission, head sampling.

* ``profiler`` — the compile-cost profiler: each kernel library's nvcc
  seconds and its kernels' ptxas resources (registers, shared memory,
  spills), the CUDA counterpart of the JAX package's XLA cost analysis.
"""
from __future__ import annotations

from .spans import (Span, annotate, collect_phases, current_span,
                    log_to_stderr, logger, phase, root_attrs, span,
                    add_sink, remove_sink, add_root_hook,
                    remove_root_hook, span_device_times)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      REGISTRY, counted_cache, counter, gauge, histogram,
                      metrics_snapshot, record_host_sync, reset_metrics,
                      sample_memory, set_memory_pool, get_memory_pool)
from .export import JsonlSpanSink, prometheus_text, span_to_json
from . import knobs, ledger, profiler, sampling, skew
from . import flight
from . import stats
from . import querylog, slo
from .skew import SkewStats

__all__ = [
    # spans
    "Span", "annotate", "collect_phases", "current_span", "log_to_stderr",
    "logger", "phase", "root_attrs", "span", "add_sink", "remove_sink",
    "add_root_hook", "remove_root_hook", "span_device_times",
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counted_cache", "counter", "gauge", "histogram", "metrics_snapshot",
    "record_host_sync", "reset_metrics", "sample_memory",
    "set_memory_pool", "get_memory_pool",
    # exporters
    "JsonlSpanSink", "prometheus_text", "span_to_json",
    # skew + memory-lifetime + failure observability
    "skew", "SkewStats", "ledger", "flight",
    "querylog", "slo", "sampling",
    "stats",
    "knobs", "profiler",
]
