"""Device time of the program's own spans in the traced window, for the
per-stage readers (``metrics/join_*_ms.py``, ``metrics/groupby_*_ms.py``,
``metrics/stage_cover_pct.py``).

While a torch profiler runs on the card, each of the port's spans times
itself with a pair of CUDA events, enter to exit on the current stream,
and adds the time to ``cylon_span_device_ms_total{span=}`` and a count to
``cylon_span_timed_total{span=}``; ``cylon_tpu_torch.telemetry.
span_device_times()`` reads both as ``{name: (ms, count)}``. The traced
window is the only profiled part of a run (warm-up queries run before
it, the reference after it), so the counters hold the window alone. A
span's time includes its children's and the device's idle time inside
it.

Every reader gets None where the run was not traced, where the program
has no such spans (a program older than them), or where the op's own
span (``join``, ``groupby``) was not timed once for every query of the
window.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

# each op's leaf stages on the cells' routes (the hash-stream join, the
# short-group group-by), which between them should hold the op's time
LEAVES = {
    "join": ("join.prepare", "join.plan.hash", "join.plan.sort",
             "join.plan.stream", "join.materialize", "join.rebuild"),
    "groupby": ("groupby.keys", "groupby.sort", "groupby.gather",
                "groupby.aggregate", "groupby.rebuild"),
}

# the last reading and its times: one synchronizing read a reading
_last: list = [None, None]


def times(r) -> Optional[Dict[str, Tuple[float, int]]]:
    """``{span: (device ms, count)}`` of the traced window, or None."""
    if r.trace is None:
        return None
    if _last[0] is r:
        return _last[1]
    try:
        from cylon_tpu_torch import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "span_device_times", None)
    got = read() if read is not None else None
    _last[:] = [r, got]
    return got


def op_times(r, op: str) -> Optional[Dict[str, Tuple[float, int]]]:
    """``times(r)`` where ``op``'s span was timed once a query, else
    None."""
    t = times(r)
    if not t or op not in t or t[op][1] != r.queries or not r.queries:
        return None
    return t


def ms_per_query(r, name: str) -> Optional[float]:
    """Device ms a query in span ``name`` (its op is the name's first
    part: ``join`` for ``join.plan.sort``)."""
    t = op_times(r, name.split(".")[0])
    if t is None or name not in t:
        return None
    return t[name][0] / r.queries


def cover_pct(r) -> Optional[float]:
    """100 x the device ms of the op's leaf stages over the op span's;
    a leaf that never ran counts 0."""
    op = r.stats.get("op")
    t = op_times(r, op) if op in LEAVES else None
    if t is None or t[op][0] <= 0:
        return None
    return 100.0 * sum(t[s][0] for s in LEAVES[op] if s in t) / t[op][0]
