"""The declared ``CYLON_*`` environment-knob registry (counterpart of
cylon_tpu.telemetry.knobs, with the same parse policy, names, defaults
and floors).

Every knob the port reads is declared here and read through :func:`get`.
Reads are live (each :func:`get` consults ``os.environ``), so a knob may
be flipped at any time; nothing is latched at import. The catalog holds
the JAX package's thirty knobs under the same names, kinds, defaults and
floors; the service tier's knobs (queue, quantum, plan cache, endpoint)
are declared for that tier, which is not ported yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def parse_number(raw: Optional[str], default, lo=None,
                 as_int: bool = False):
    """The numeric parse policy: ``None`` or malformed reads as
    ``default``, ``lo`` floors the result."""
    if raw is None:
        return default
    try:
        v = int(raw) if as_int else float(raw)
    except ValueError:
        return default
    return max(v, lo) if lo is not None else v


def env_number(name: str, default, lo=None, as_int: bool = False):
    """:func:`parse_number` over a live ``os.environ`` read, for a caller
    that needs the raw policy; the port reads its knobs through a
    declared :class:`Knob` and :func:`get`."""
    return parse_number(os.environ.get(name), default, lo=lo,
                        as_int=as_int)


@dataclass(frozen=True)
class Knob:
    """One declared environment knob: ``kind`` is ``int`` / ``float`` /
    ``bool`` / ``str``; unset or malformed values read as ``default``;
    ``lo`` floors numeric values."""

    name: str
    default: object
    kind: str
    doc: str
    lo: Optional[float] = None

    def parse(self, raw: Optional[str]):
        if raw is None:
            return self.default
        if self.kind == "str":
            return raw
        if self.kind == "bool":
            v = raw.strip().lower()
            if v in _TRUTHY:
                return True
            if v in _FALSY:
                return False
            return self.default
        return parse_number(raw, self.default, lo=self.lo,
                            as_int=self.kind == "int")

    def get(self):
        return self.parse(os.environ.get(self.name))

    def default_str(self) -> str:
        if self.default is None:
            return "unset"
        if self.kind == "bool":
            return "1" if self.default else "0"
        return str(self.default)


# name -> Knob, in declaration order
KNOBS: "Dict[str, Knob]" = {}


def declare(name: str, default, kind: str, doc: str,
            lo: Optional[float] = None) -> Knob:
    """Register one knob; declaring a name twice is an error."""
    if kind not in ("int", "float", "bool", "str"):
        raise ValueError(f"knob {name!r}: unknown kind {kind!r}")
    if name in KNOBS:
        raise ValueError(f"knob {name!r} already declared")
    k = Knob(name, default, kind, doc, lo)
    KNOBS[name] = k
    return k


def _require(name: str) -> Knob:
    k = KNOBS.get(name)
    if k is None:
        raise KeyError(f"{name!r} is not a declared knob; declared: "
                       f"{sorted(KNOBS)}")
    return k


def get(name: str):
    """The current value of a declared knob (a live ``os.environ`` read;
    unset or malformed -> the declared default)."""
    return _require(name).get()


def default(name: str):
    """A declared knob's default."""
    return _require(name).default


def render_table() -> str:
    """The markdown knob-reference table, one row a declared knob
    (``python -m cylon_tpu_torch.telemetry.knobs`` prints it)."""
    lines = ["| knob | type | default | description |",
             "|---|---|---|---|"]
    for k in KNOBS.values():
        lines.append(f"| `{k.name}` | {k.kind} | `{k.default_str()}` "
                     f"| {k.doc} |")
    return "\n".join(lines)


# memory.py (a TPU runtime that hides its stats; CUDA always has them)
declare("CYLON_HBM_BYTES", 16 * (1 << 30), "int",
        "per-device memory fallback when the runtime hides its memory "
        "statistics; the port's pool reads the CUDA allocator and does "
        "not consult it", lo=1)

# telemetry/
declare("CYLON_TRACE_SAMPLE_RATE", 1.0, "float",
        "head-sampling rate for root query spans (0..1), decided "
        "deterministically from the query_id hash; sampled-out queries "
        "keep counters/histograms/querylog but skip trace-sink writes, "
        "and errored queries are always promoted to fully recorded",
        lo=0.0)
declare("CYLON_SPAN_LOG_MAX_BYTES", 0, "int",
        "size bound for file-backed JSONL sinks (span trace and query "
        "log): past it the file rotates (keep-3 .1/.2/.3 suffixes); "
        "0 = unbounded", lo=0)
declare("CYLON_HBM_SPAN_ATTRS", True, "bool",
        "sample the registered MemoryPool at span enter/exit for "
        "hbm_delta/hbm_peak attrs; 0 skips the two per-span snapshots "
        "on latency-critical runs")
declare("CYLON_SKEW_WARN_FACTOR", 2.0, "float",
        "exchange imbalance factor (max/mean destination rows) beyond "
        "which spans gain skew_warn, EXPLAIN ANALYZE marks [SKEW] and "
        "the salted shuffle treats a destination as hot", lo=1.0)
declare("CYLON_FLIGHT_RING", 16, "int",
        "completed root-span trees (and admission decisions) the "
        "flight recorder keeps in memory", lo=1)
declare("CYLON_FLIGHT_DIR", None, "str",
        "directory for crash dumps when a root span closes errored; "
        "unset disables dumps (the ring stays on)")
declare("CYLON_FLIGHT_MAX_DUMPS", 32, "int",
        "crash-dump files kept in CYLON_FLIGHT_DIR before oldest-first "
        "rotation", lo=1)

# parallel/shuffle.py (the chunked exchange)
declare("CYLON_EXCHANGE_OVERLAP", True, "bool",
        "chunk the padded-mode exchange into CYLON_EXCHANGE_CHUNK_BYTES "
        "pieces; 0 runs the single-shot exchange")
declare("CYLON_EXCHANGE_CHUNK_BYTES", 1 << 26, "int",
        "target payload bytes per exchange chunk and per shard (across "
        "all destinations); the chunk block is pow2-floored from it and "
        "the chunk count is capped at MAX_CHUNKS per exchange",
        lo=1 << 12)
declare("CYLON_PARTITION_KERNEL", "auto", "str",
        "the JAX package's partition-path knob (auto, sort, pallas); "
        "the port selects its route with shuffle.PARTITION_KERNEL "
        "(K1/K2 on CUDA, the stable sort on the CPU) and does not "
        "read it")

# plan/
declare("CYLON_TPU_VERIFY_PLANS", False, "bool",
        "debug assert: re-derive partitioning witnesses over every "
        "optimized plan via plan/verify.py, raising on unjustified "
        "elisions")

# resilience/
declare("CYLON_RETRY_MAX", 3, "int",
        "total attempts per retryable stage (exchange dispatch, "
        "ingest reads)", lo=1)
declare("CYLON_RETRY_BACKOFF_S", 0.05, "float",
        "base backoff before attempt 2, doubling per retry — "
        "deterministic, no jitter", lo=0.0)
declare("CYLON_QUERY_DEADLINE_S", None, "float",
        "per-query wall-clock budget; expiry raises CylonTimeoutError "
        "at the next node/retry boundary")
declare("CYLON_SHED_FACTOR", 8.0, "float",
        "admission controller sheds when the worst node estimate "
        "exceeds this multiple of the byte budget", lo=1.0)
declare("CYLON_FAULT_PLAN", None, "str",
        "armed chaos fault plan (site:trigger:kind[,...]) — see "
        "resilience/inject.py for the grammar")

# service/ (not ported yet; declared so the catalog matches)
declare("CYLON_SERVICE_QUEUE_MAX", 256, "int",
        "total service queue bound; beyond it submit() raises typed "
        "backpressure before enqueue", lo=1)
declare("CYLON_SERVICE_QUANTUM_BYTES", 1 << 20, "int",
        "deficit-round-robin quantum added per sweep visit (the "
        "fair-share byte unit)", lo=1)
declare("CYLON_PLAN_CACHE_MAX", 64, "int",
        "plan/fingerprint cache entries (0 disables the cache)", lo=0)
declare("CYLON_OBS_PORT", 0, "int",
        "TCP port for the observability HTTP endpoint (/metrics, "
        "/healthz, /queries, /slo, /stats); 0 disables it", lo=0)

# telemetry/slo.py (per-tenant service-level objectives)
declare("CYLON_SLO_P95_MS", None, "float",
        "declared per-tenant latency objective: the p95 query latency "
        "(ms) promised; unset = no objective, SLO evaluation reports "
        "latency quantiles only", lo=0.0)
declare("CYLON_SLO_TARGET", 0.99, "float",
        "fraction of queries that must meet the latency objective "
        "(the SLO target); the error budget is the allowed 1-target "
        "violation share, and burn events land in the flight "
        "admission ring", lo=0.0)

# telemetry/stats.py (the query statistics warehouse)
declare("CYLON_STATS_MIN_OBS", 3, "int",
        "successful observations a fingerprint needs before its "
        "measured EWMA informs admission estimates (below it the "
        "static upper bound rules); also the drift-detection floor",
        lo=1)
declare("CYLON_STATS_SAFETY", 1.5, "float",
        "headroom multiplier on the measured EWMA when it replaces a "
        "static estimate: effective = min(static, ewma x safety) — "
        "never above the static bound", lo=1.0)
declare("CYLON_STATS_DRIFT_FACTOR", 4.0, "float",
        "a new measurement deviating beyond this ratio from the EWMA "
        "(either direction) fires cylon_stats_drift_total, records a "
        "flight-ring event, evicts the plan-cache entry and resets "
        "the learned stats to re-learn from the new regime", lo=1.0)
declare("CYLON_STATS_PATH", None, "str",
        "JSONL persistence path for the statistics warehouse "
        "(stats.save / stats.load); a corrupt file is quarantined "
        "(renamed aside), never fatal")

# plan/optimizer.py (adaptive join execution — stats-driven rewrites)
declare("CYLON_JOIN_ALGORITHM", "auto", "str",
        "distributed-join algorithm policy: auto lets the optimizer "
        "rewrite shuffle joins to broadcast-hash joins from measured "
        "build-side statistics; shuffle disables every adaptive "
        "rewrite; broadcast forces the broadcast path on every "
        "eligible join shape")
declare("CYLON_BROADCAST_MAX_BYTES", 1 << 22, "int",
        "broadcast-hash-join budget: a join side whose MEASURED size "
        "(EWMA x CYLON_STATS_SAFETY) fits under this many bytes may "
        "be replicated to every shard instead of hash-exchanged "
        "(requires CYLON_STATS_MIN_OBS successful observations and a "
        "probe side measured at least BROADCAST_MIN_RATIO x larger); "
        "0 disables the rewrite", lo=0)
declare("CYLON_SALT_FACTOR", 4, "int",
        "hot-key salting spread of the salted shuffle: each hot "
        "destination's rows split across this many consecutive shards "
        "(pow2-floored); 0 or 1 disables salting", lo=0)


if __name__ == "__main__":  # pragma: no cover - doc regeneration
    print(render_table())
