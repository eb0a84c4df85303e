"""Reference inner join by sort and binary search: every left row
meets every right row of its key; the columns are the left table's,
then the right table's."""
from __future__ import annotations

import torch

from . import column, lowered


def compute(tables, q, low=None):
    if q.get("how", "inner") != "inner":
        raise ValueError("the reference join is an inner join")
    left, right = tables[q["left"]], tables[q["right"]]
    lk, rk = column(left, q["on"]), column(right, q["on"])
    dev = lk.device
    rk_s, rperm = torch.sort(rk, stable=True)
    lo = torch.searchsorted(rk_s, lk, side="left")
    cnt = torch.searchsorted(rk_s, lk, side="right") - lo
    li = torch.repeat_interleave(torch.arange(len(lk), device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    off = torch.arange(len(li), device=dev) - first[li]
    ri = rperm[lo[li] + off]
    del rk_s, first, off
    cols = [lowered(x, low)[li] for _c, x in left] \
        + [lowered(x, low)[ri] for _c, x in right]
    width = sum(x.element_size() for _c, x in left + right)
    stats = {"out_rows": len(li),
             "query_bytes": sum(x.numel() * x.element_size()
                                for _c, x in left + right)
             + len(li) * width,
             "left_matched": int((cnt > 0).sum()),
             "right_matched": int(torch.isin(rk, lk).sum())}
    return cols, [None] * len(cols), stats
