"""Reference DISTINCT union: both tables' rows in one list, ordered
lexicographically by each column's bits (a float's -0.0 made +0.0 first,
so equal values have equal bits), the first row of each run of equal
rows kept; the columns are the left table's."""
from __future__ import annotations

import torch

from . import lowered


def _plus_zero(x):
    if not x.is_floating_point():
        return x
    return torch.where(x == 0, torch.zeros((), dtype=x.dtype,
                                           device=x.device), x)


def _bits(x):
    if x.is_floating_point():
        return x.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])
    return x


def compute(tables, q, low=None):
    left, right = tables[q["left"]], tables[q["right"]]
    cols = [_plus_zero(torch.cat([lowered(a, low), lowered(b, low)]))
            for (_c, a), (_d, b) in zip(left, right)]
    n = len(cols[0])
    dev = cols[0].device
    perm = torch.arange(n, device=dev)
    for x in reversed(cols):
        perm = perm[torch.sort(_bits(x)[perm], stable=True).indices]
    same = torch.ones(max(n - 1, 0), dtype=torch.bool, device=dev)
    for x in cols:
        b = _bits(x)[perm]
        same &= b[1:] == b[:-1]
        del b
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = ~same
    keep = perm[first]
    del perm, first, same
    out = [x[keep] for x in cols]
    width = sum(x.element_size() for x in cols)
    stats = {"out_rows": len(keep),
             "query_bytes": n * width + len(keep) * width}
    return out, [None] * len(out), stats
