"""Reference group-by: groups by ``torch.unique`` of one key column (in
key order), sums by ``index_add_`` in float64 or int64, counts by
``bincount``, means as float64 sum over count."""
from __future__ import annotations

import torch

from . import column, lowered


def compute(tables, q, low=None):
    t = tables[q["table"]]
    keys, inv = torch.unique(column(t, q["by"]), sorted=True,
                             return_inverse=True)
    g = len(keys)
    count = torch.bincount(inv, minlength=g)
    cols, scales = [keys], [None]
    n = len(inv)
    read = keys.element_size()
    write = keys.element_size()
    for name, op in zip(q["columns"], q["aggs"]):
        x = column(t, name)
        read += x.element_size()
        write += x.element_size() if op == "sum" else 8
        if op == "count":
            cols.append(count)
            scales.append(None)
            continue
        if op not in ("sum", "mean"):
            raise ValueError(f"the reference has no {op!r}")
        if x.is_floating_point():
            acc = torch.float64 if low is None else getattr(torch, low)
            s = torch.zeros(g, dtype=acc, device=x.device).index_add_(
                0, inv, x.to(acc)).to(torch.float64)
            scale = torch.zeros(g, dtype=torch.float64,
                                device=x.device).index_add_(
                0, inv, lowered(x, low).abs().to(torch.float64))
        else:
            s = torch.zeros(g, dtype=torch.int64, device=x.device) \
                .index_add_(0, inv, x.to(torch.int64))
            scale = None
        if op == "mean":
            s = s.to(torch.float64) / count
            scale = (scale if scale is not None
                     else s.abs() * count) / count
        cols.append(s)
        scales.append(scale)
    return cols, scales, {"out_rows": g,
                          "query_bytes": n * read + g * write}
