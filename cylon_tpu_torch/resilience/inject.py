"""Deterministic fault injection at named choke points.

Counterpart of cylon_tpu.resilience.inject: the same sites, labels and
knobs.

Chaos testing only proves anything when the chaos is REPLAYABLE: a
fault that fires "sometimes" produces unreproducible red builds, so
every fault here is a pure function of the armed plan and the arrival
counter — run the same plan against the same pipeline and the same
attempt fails, every time.

Fault-plan grammar (``CYLON_FAULT_PLAN`` or ``arm(plan)``)::

    plan    := spec ("," spec)*
    spec    := site ":" trigger ":" kind
    site    := "exchange" | "compile" | "ingest" | "pool"
    trigger := N        fire on the Nth arrival only (1-based)
             | N "+"    fire on every arrival from the Nth on
                        (a PERSISTENT fault — retries keep failing)
             | "*"      fire on every arrival (same as "1+")
    kind    := "transient"  -> CylonTransientError  (retryable)
             | "oom"        -> CylonResourceExhausted
             | "data"       -> CylonDataError

    exchange:2:transient      second exchange launch fails once
    exchange:1+:transient     every exchange launch fails (persistent)
    compile:1:oom             first kernel-factory build OOMs
    ingest:1:data             first file read returns garbage

The ``pool`` site is different: it does not raise — it CLAMPS the
budget the admission controller sees (``budget_clamp()``), simulating
HBM exhaustion deterministically. Its trigger field is the clamp in
BYTES: ``pool:4096:oom`` makes every admission decision run against a
4 KiB budget, driving the shed/degrade paths.

Choke points call :func:`fire` (a near-free no-op when nothing is
armed); arming happens explicitly via :func:`arm` or lazily from the
environment on first fire. ``state()`` (armed plan, per-site arrival
counts, fired events) is registered as a crash-dump section, so a
chaos failure's dump names the fault that caused it.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..status import (CylonDataError, CylonPlanError,
                      CylonResourceExhausted, CylonTransientError)
from ..telemetry import flight as _flight
from ..telemetry import knobs as _knobs
from ..telemetry import metrics as _metrics

PLAN_ENV = "CYLON_FAULT_PLAN"

SITES = ("exchange", "compile", "ingest", "pool")

_KINDS = {
    "transient": CylonTransientError,
    "oom": CylonResourceExhausted,
    "data": CylonDataError,
}


@dataclass(frozen=True)
class FaultSpec:
    """One armed fault: fire ``kind`` at ``site`` per ``trigger``."""

    site: str
    nth: int            # 1-based arrival index (pool: clamp bytes)
    persistent: bool    # fire on every arrival >= nth
    kind: str

    def matches(self, arrival: int) -> bool:
        return arrival >= self.nth if self.persistent \
            else arrival == self.nth

    def spec_str(self) -> str:
        trig = f"{self.nth}+" if self.persistent else str(self.nth)
        return f"{self.site}:{trig}:{self.kind}"


def parse_plan(text: str) -> List[FaultSpec]:
    """Parse the fault-plan grammar; a malformed plan is a
    :class:`CylonPlanError` (a typo'd chaos config must fail loudly,
    not silently arm nothing)."""
    specs: List[FaultSpec] = []
    for raw in text.split(","):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        if len(parts) != 3:
            raise CylonPlanError(
                f"fault spec {raw!r} is not site:trigger:kind")
        site, trig, kind = (p.strip() for p in parts)
        if site not in SITES:
            raise CylonPlanError(
                f"unknown fault site {site!r} (one of {SITES})")
        if kind not in _KINDS:
            raise CylonPlanError(
                f"unknown fault kind {kind!r} "
                f"(one of {tuple(_KINDS)})")
        persistent = trig == "*" or trig.endswith("+")
        num = "1" if trig == "*" else trig.rstrip("+")
        try:
            nth = int(num)
        except ValueError:
            raise CylonPlanError(
                f"fault trigger {trig!r} is not N, N+ or *")
        if nth < 1:
            raise CylonPlanError(
                f"fault trigger {trig!r} must be >= 1")
        specs.append(FaultSpec(site, nth, persistent, kind))
    return specs


@dataclass
class _State:
    plan_str: str
    specs: List[FaultSpec]
    arrivals: Dict[str, int] = field(default_factory=dict)
    fired: List[dict] = field(default_factory=list)


_lock = threading.Lock()
_state: Optional[_State] = None
_env_checked = False


def arm(plan: Optional[str] = None) -> List[FaultSpec]:
    """Arm a fault plan (default: ``CYLON_FAULT_PLAN``); resets arrival
    counters. Returns the parsed specs (empty when nothing to arm)."""
    global _state, _env_checked
    text = plan if plan is not None else \
        (_knobs.get(PLAN_ENV) or "")
    with _lock:
        _env_checked = True
        if not text:
            _state = None
            _metrics.set_factory_fault_hook(None)
            return []
        # publish via a local so the return below never re-reads the
        # global outside the lock (a concurrent disarm() between the
        # critical section and the return would None it out from under
        # us — the concurrency checker's lock-discipline rule)
        st = _State(text, parse_plan(text))
        _state = st
        if any(s.site == "compile" for s in st.specs):
            _metrics.set_factory_fault_hook(_compile_fault_hook)
        else:
            _metrics.set_factory_fault_hook(None)
    return list(st.specs)


def disarm() -> None:
    """Drop the armed plan and counters (test isolation)."""
    global _state, _env_checked
    with _lock:
        _state = None
        _env_checked = True
        _metrics.set_factory_fault_hook(None)


def active() -> bool:
    return _current() is not None


def _current() -> Optional[_State]:
    """The armed state, lazily arming from the environment exactly once
    (so env-driven chaos needs no import-order ceremony)."""
    global _env_checked
    if _state is None and not _env_checked:  # cylint: disable=concurrency/lock-discipline — double-checked lazy arm: reference reads are GIL-atomic; two racers at worst both run arm(), which is locked and idempotent
        if _knobs.get(PLAN_ENV):
            arm()
        else:
            with _lock:
                _env_checked = True
    return _state  # cylint: disable=concurrency/lock-discipline — GIL-atomic reference read is the fire() fast path; all mutation of the returned _State happens under _lock


def fire(site: str, detail: str = "") -> None:
    """One arrival at a choke point: increments the site counter and
    raises the armed typed error when a spec matches this arrival.
    Near-free when nothing is armed."""
    st = _current()
    if st is None:
        return
    with _lock:
        arrival = st.arrivals.get(site, 0) + 1
        st.arrivals[site] = arrival
        spec = next((s for s in st.specs
                     if s.site == site and s.matches(arrival)), None)
        if spec is None:
            return
        st.fired.append({"site": site, "arrival": arrival,
                         "kind": spec.kind, "spec": spec.spec_str(),
                         "detail": detail})
        _metrics.REGISTRY.counter("cylon_faults_injected_total",
                                  {"site": site}).inc()
    raise _KINDS[spec.kind](
        f"injected {spec.kind} fault at {site} "
        f"(arrival {arrival}, spec {spec.spec_str()}"
        f"{', ' + detail if detail else ''})")


def _compile_fault_hook(factory_name: str) -> None:
    """Installed as the counted_cache fault hook while a ``compile``
    spec is armed — every kernel-factory build is one arrival."""
    fire("compile", detail=f"factory {factory_name}")


def budget_clamp() -> Optional[int]:
    """The armed ``pool`` clamp in bytes, or None. The admission
    controller takes ``min(real budget, clamp)`` — a deterministic
    stand-in for a pod whose HBM is already spoken for."""
    st = _current()
    if st is None:
        return None
    clamps = [s.nth for s in st.specs if s.site == "pool"]
    return min(clamps) if clamps else None


def state() -> dict:
    """Armed plan + arrival counters + fired events — the crash dump's
    ``faults`` section, so a chaos dump names its own cause."""
    st = _state  # cylint: disable=concurrency/lock-discipline — GIL-atomic snapshot; the lock below guards the captured state's fields, a racing disarm just yields a stale (consistent) report
    if st is None:
        return {"armed": None, "arrivals": {}, "fired": []}
    with _lock:
        return {"armed": st.plan_str,
                "specs": [s.spec_str() for s in st.specs],
                "arrivals": dict(st.arrivals),
                "fired": [dict(f) for f in st.fired]}


# a chaos failure's crash dump must name the fault that caused it
_flight.add_dump_section("faults", state)
