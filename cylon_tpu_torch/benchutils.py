"""Benchmark helpers — pycylon.util parity surface (counterpart of
cylon_tpu.benchutils).

Reference: python/pycylon/util/benchutils.py:33-46
(`benchmark_with_repitions`) and python/pycylon/util/data/generator.py
(numeric CSV generation backing the demo pipelines). CUDA launches are
asynchronous, so the timer forces each result with one
``torch.cuda.synchronize`` of every card its tensors live on before it
reads the clock; CPU results need nothing.
"""
from __future__ import annotations

import math
import time
from typing import Sequence

import numpy as np
import torch

from .util import BUCKET_FLOOR, bucket_cap  # noqa: F401  (re-exported)

_DIV = {"ns": 1.0, "us": 1e3, "ms": 1e6, "s": 1e9}


def round_sig(x: float, sig: int = 6) -> float:
    """Round to ``sig`` SIGNIFICANT digits (not decimal places).

    Fixed-decimal rounding destroys sub-millisecond walls (a 23 ms wall
    rounded to 1 decimal reads 0.0 beside a nonzero rate).
    Significant-digit rounding keeps any nonzero measurement nonzero and
    self-consistent with the rates computed from the unrounded value, at
    any scale."""
    if not isinstance(x, float) or x == 0.0 or not math.isfinite(x):
        return x
    return round(x, sig - 1 - int(math.floor(math.log10(abs(x)))))


def _tensors(value):
    """Every tensor a result reaches: Table columns (data, validity,
    varbytes words), tensors, and tensors in nested lists, tuples and
    dicts."""
    from .data.table import Table

    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, Table):
        for c in value._columns:
            yield c.data
            if c.validity is not None:
                yield c.validity
            if c.is_varbytes:
                yield c.varbytes.words
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def _force(value) -> None:
    """Wait for every card a result's tensors live on (one
    ``torch.cuda.synchronize`` each); nothing on the CPU."""
    for dev in {x.device for x in _tensors(value) if x.is_cuda}:
        torch.cuda.synchronize(dev)


def benchmark_with_repetitions(repetitions: int = 10, time_type: str = "ms"):
    """Decorator: run ``f`` ``repetitions`` times, return
    (mean_time_in_time_type, last_result). API-compatible with the
    reference's ``benchmark_with_repitions`` [sic] decorator
    (benchutils.py:33-46), plus result forcing."""
    div = _DIV.get(time_type, 1e6)

    def wrap(f):
        def wrapped_f(*args, **kwargs):
            # perf_counter_ns: monotonic, full resolution; rates derive
            # from the unrounded integer-ns wall
            t1 = time.perf_counter_ns()
            for _ in range(repetitions):
                rets = f(*args, **kwargs)
                _force(rets)
            t2 = time.perf_counter_ns()
            return (t2 - t1) / div / float(repetitions), rets

        return wrapped_f

    return wrap


# reference spells it "repitions" — keep an alias so ported user code runs
benchmark_with_repitions = benchmark_with_repetitions


def generate_numeric_csv(rows: int, columns: int, file_path: str,
                         seed: int = 0) -> None:
    """Write a random numeric CSV (reference:
    util/data/generator.py:20-30)."""
    rng = np.random.default_rng(seed)
    a = rng.random((rows, columns))
    np.savetxt(file_path, a, delimiter=",")


def generate_keyed_csv(rows: int, n_keys: int, file_path: str,
                       seed: int = 0,
                       header: Sequence[str] = ("key", "value")) -> None:
    """Write a (key, value) CSV for join/groupby demos."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(n_keys, 1), rows)
    vals = rng.random(rows)
    with open(file_path, "w") as f:
        f.write(",".join(header) + "\n")
        for k, v in zip(keys, vals):
            f.write(f"{k},{v:.9f}\n")
