"""From a ``torch.profiler`` trace of the measured window to the plain
lists the per-layer readers use, and the arithmetic on those lists.

An event is ``(name, start_us, end_us)``. ``Trace`` holds the device's
operations (kernels, copies, sets), the host's CUDA runtime calls, the
host's other operations, and the window's bounds, all on the
profiler's clock. Ranges the program or the harness open
(``cylon:``/``portbench:`` labels) enclose device work and are not
device work themselves, so they are kept apart.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

Event = Tuple[str, float, float]
WINDOW_LABEL = "portbench:window"
QUERY_LABEL = "portbench:query"
RANGE_PREFIXES = ("cylon:", "portbench:")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Event] = field(default_factory=list)
    runtime: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def from_profiler(prof) -> Trace:
    """Split a finished ``torch.profiler.profile``'s events."""
    window = None
    dev, rt, host = [], [], []
    for e in prof.events():
        name = e.name
        t = (name, float(e.time_range.start), float(e.time_range.end))
        on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
        if name == WINDOW_LABEL and not on_device:
            window = (t[1], t[2])
        elif name.startswith(RANGE_PREFIXES) or \
                getattr(e, "is_user_annotation", False):
            if not on_device:
                host.append(t)
        elif on_device:
            dev.append(t)
        elif name.startswith("cuda"):
            rt.append(t)
        else:
            host.append(t)
    if window is None:
        raise RuntimeError("the trace has no window range")
    return Trace(window, dev, rt, host)


def clip(events: Sequence[Event], lo: float, hi: float) -> List[Event]:
    return [(n, max(s, lo), min(e, hi)) for n, s, e in events
            if e > lo and s < hi]


def union(events: Sequence[Event]) -> List[Tuple[float, float]]:
    """The merged intervals the events cover."""
    out: List[List[float]] = []
    for _n, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    iv = union(clip(tr.device, *tr.window))
    return sum(e - s for s, e in iv) / 1e6


def gaps(tr: Trace) -> List[Tuple[float, float]]:
    """The window's idle intervals, longest first."""
    lo, hi = tr.window
    out, t = [], lo
    for s, e in union(clip(tr.device, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def matches(name: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, name) for p in patterns)


def device_seconds(tr: Trace, patterns: Optional[Sequence[str]] = None,
                   exclude: Sequence[str] = ()) -> float:
    """Summed device seconds in the window of the operations whose name
    matches one of ``patterns`` (every one where None) and none of
    ``exclude``."""
    tot = 0.0
    for n, s, e in clip(tr.device, *tr.window):
        if (patterns is None or matches(n, patterns)) \
                and not matches(n, exclude):
            tot += e - s
    return tot / 1e6


def sync_calls(tr: Trace) -> int:
    """The host's blocking CUDA runtime calls in the window."""
    lo, hi = tr.window
    return sum(1 for n, s, _e in tr.runtime
               if lo <= s <= hi and n in SYNC_CALLS)


def top_device_ops(tr: Trace, k: int = 10) -> List[List]:
    tot: Dict[str, float] = {}
    for n, s, e in clip(tr.device, *tr.window):
        tot[n] = tot.get(n, 0.0) + (e - s) / 1e6
    return [[n[:200], v] for n, v in
            sorted(tot.items(), key=lambda x: -x[1])[:k]]


def _span_label(name: str) -> str:
    return name.split("#")[0]


def gap_owners(tr: Trace, k: int = 10, longest: int = 400) -> List[List]:
    """The ``longest`` idle gaps named by what the host was doing at
    their middle (the innermost host operation there, under the
    innermost ``cylon:`` range; where none, whether a query was under
    way), summed by name, the ``k`` largest."""
    import numpy as np

    host = tr.host + tr.runtime
    if not host:
        return []
    names = [n for n, _s, _e in host]
    st = np.array([s for _n, s, _e in host])
    en = np.array([e for _n, _s, e in host])
    dur = en - st
    span = np.array([n.startswith("cylon:") for n in names])
    mine = np.array([n.startswith("portbench:") for n in names])
    query = np.array([n == QUERY_LABEL for n in names])
    tot: Dict[str, float] = {}
    for a, b in gaps(tr)[:longest]:
        mid = (a + b) / 2
        covers = (st <= mid) & (en >= mid)
        inside = covers & ~mine
        name = "host, in a query" if (covers & query).any() \
            else "host, between queries"
        op = inside & ~span
        if op.any():
            name = names[int(np.argmin(np.where(op, dur, np.inf)))]
        sp = inside & span
        if sp.any():
            label = names[int(np.argmin(np.where(sp, dur, np.inf)))]
            name = f"{_span_label(label)} > {name}"
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return [[n[:200], v] for n, v in
            sorted(tot.items(), key=lambda x: -x[1])[:k]]
