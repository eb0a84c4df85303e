"""Kernel compile-cost profiler: what the port's CUDA libraries cost
(counterpart of cylon_tpu.telemetry.profiler).

The port builds each of its four kernel libraries (``partition``,
``join_stream``, ``setop_stream``, ``stream_compact``) once with nvcc
and loads it once a process (``ops/kernels.load_library``, a
``counted_cache`` loader: ``cylon_kernel_factory_builds_total`` counts
the loads). So a "program" here is one CUDA library, not one jitted
signature, and there is no per-signature compile to intercept. When
enabled, this module records for each library the process loads:

* **compile wall time** — that library's nvcc wall in this process
  (taken by ``kernels.build()``, whichever caller built it), or 0.0 when
  it was loaded from an existing ``_build/``; it feeds
  ``cylon_kernel_compile_seconds{factory=<library>}``;
* **the counterpart of XLA's cost analysis** — the per-kernel resources
  ``nvcc -Xptxas -v`` wrote to ``_build/<library>.log`` when the library
  was built: registers, shared memory and spill bytes (stores plus
  loads) of every kernel function, as ``kernels: {function:
  {registers, smem_bytes, spill_bytes}}``. Nothing is compiled twice for
  it; a missing or unparseable log raises. ``flops`` and
  ``bytes_accessed`` are None: nvcc reports no cost analysis, and the
  ``cylon_kernel_compile_{flops,bytes_accessed}_total`` counters move
  only when a value exists.

Mechanics: ``enable()`` installs a build hook into
``metrics.counted_cache``. The hook reads what ``load_library`` leaves
on the library handle (``cylon_library``, ``cylon_build_s``,
``cylon_build_log``), duck-typed, so telemetry never imports ``ops``, and
returns the handle unchanged. Libraries loaded before ``enable()`` are
not recorded (the loader's memo holds them): enable the profiler before
the first kernel launch.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, List, Optional

from ..status import Code, CylonError
from . import metrics as _metrics

# compile wall-time buckets, seconds (a small library to a many-minute
# build)
COMPILE_SECONDS_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0,
                           60.0, 300.0)

_enabled = False
_records: List[dict] = []
_lock = threading.Lock()

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(text: str) -> Dict[str, dict]:
    """Per-kernel resources from an ``nvcc -Xptxas -v`` report:
    {function: {registers, smem_bytes, spill_bytes}} for every entry
    function it compiled. Raises when the report names none."""
    out: Dict[str, dict] = {}
    entry: Optional[str] = None
    props: Optional[str] = None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "smem_bytes": 0,
                          "spill_bytes": 0}
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILL.search(line)
        if m and props in out:
            out[props]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            continue
        m = _USED.search(line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            out[entry]["smem_bytes"] = int(m.group(2) or 0)
    out = {k: v for k, v in out.items() if v["registers"] is not None}
    if not out:
        raise CylonError(Code.ExecutionError,
                         "no kernel resources in the ptxas report")
    return out


def _read_log(path: str) -> Dict[str, dict]:
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise CylonError(Code.IOError,
                         f"ptxas report {path} unreadable: {e}") from e
    try:
        return parse_ptxas(text)
    except CylonError as e:
        raise CylonError(Code.ExecutionError, f"{path}: {e.msg}") from e


def _record(factory: str, seconds: float, flops, nbytes,
            kernels: Optional[Dict[str, dict]] = None) -> None:
    _metrics.REGISTRY.histogram(
        "cylon_kernel_compile_seconds", {"factory": factory},
        buckets=COMPILE_SECONDS_BUCKETS).observe(seconds)
    if flops is not None:
        _metrics.REGISTRY.counter(
            "cylon_kernel_compile_flops_total",
            {"factory": factory}).inc(int(flops))
    if nbytes is not None:
        _metrics.REGISTRY.counter(
            "cylon_kernel_compile_bytes_accessed_total",
            {"factory": factory}).inc(int(nbytes))
    rec = {"factory": factory, "compile_s": round(seconds, 6),
           "flops": flops, "bytes_accessed": nbytes}
    if kernels is not None:
        rec["kernels"] = kernels
    with _lock:
        _records.append(rec)


def _build_hook(factory: str, built):
    """The counted_cache hook: one record per loaded kernel library
    (``factory`` is the loader's name; the record names the library).
    Anything that is not a tagged library handle passes untouched."""
    name = getattr(built, "cylon_library", None)
    if name is None or not _enabled:
        return built
    _record(name, float(built.cylon_build_s), None, None,
            kernels=_read_log(built.cylon_build_log))
    return built


def enable() -> None:
    """Install the counted_cache build hook; libraries loaded from now
    on are recorded. Idempotent."""
    global _enabled
    _enabled = True
    _metrics.set_factory_build_hook(_build_hook)


def disable() -> None:
    """Stop recording. Libraries already loaded stay loaded."""
    global _enabled
    _enabled = False
    _metrics.set_factory_build_hook(None)


def enabled() -> bool:
    return _enabled


def records() -> List[dict]:
    """Every recorded library load, in order: {factory, compile_s, flops,
    bytes_accessed, kernels} (``kernels`` only where a ptxas report was
    read; flops and bytes_accessed None: nvcc reports no cost
    analysis)."""
    with _lock:
        return [dict(r) for r in _records]


def reset() -> None:
    with _lock:
        _records.clear()


def summary() -> dict:
    """Per-factory aggregate — the benchmark artifact form:
    {factory: {programs, compile_s, flops, bytes_accessed}} with cost
    totals None when no program reported them, plus ``kernels`` (the
    latest ptxas resources) for a kernel library."""
    out: dict = {}
    for r in records():
        agg = out.setdefault(r["factory"], {
            "programs": 0, "compile_s": 0.0,
            "flops": None, "bytes_accessed": None})
        agg["programs"] += 1
        agg["compile_s"] = round(agg["compile_s"] + r["compile_s"], 6)
        for k in ("flops", "bytes_accessed"):
            if r[k] is not None:
                agg[k] = (agg[k] or 0.0) + r[k]
        if "kernels" in r:
            agg["kernels"] = r["kernels"]
    return out
