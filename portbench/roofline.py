"""A kernel's least time against its device time in the traced window."""
from __future__ import annotations

from typing import Optional, Tuple

from portbench import trace


def kernel_times(r, name: str) -> Optional[Tuple[float, float]]:
    """(least seconds, device seconds) of kernel ``name`` over the
    traced queries, or None where it did not run or has no byte count.
    A process of several is held to its share of the bytes."""
    mod = r.rooflines.get(name)
    if mod is None or r.trace is None or not r.queries:
        return None
    b = mod.stage_bytes(r.stats)
    spent = trace.device_seconds(r.trace, r.kernels.get(name, ()))
    if b is None or spent <= 0:
        return None
    share = r.stats.get("share", 1.0)
    return b * share * r.queries / r.peaks["hbm_bytes_per_s"], spent
