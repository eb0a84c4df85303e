"""Order statistics of raw samples."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(xs: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``th percentile: the smallest sample with at
    least p% of the samples at or below it."""
    s = sorted(xs)
    return s[max(math.ceil(p / 100.0 * len(s)), 1) - 1]

