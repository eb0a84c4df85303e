"""Group-by aggregation: sort-based segmented reduction (counterpart of
cylon_tpu.ops.groupby).

The rows are sorted into contiguous groups (dead rows last), each group
gets a dense id in key order, and every aggregate is one segment
reduction over those sorted ids: every float sum of a call in one K7
launch (``kernels.segment_sum``), which adds each group's rows in row
order as the JAX package's sorted ``segment_sum`` does, so they are
bit-reproducible on the card and equal the CPU's; first rows, counts and
integer sums from the group boundaries (the sort is stable, so a group's
first sorted row is its first original row; a count is the gap between
two starts, an integer sum a difference of int64 cumsums, which wraps as
the reference's sum does); MIN/MAX through ``scatter_reduce_`` on integer
order keys.

Everything runs batched over a leading shard dimension: 1-D inputs are
one shard, ``[W, n]`` inputs are W shards whose group ids are offset by
shard into one flat segment space, so one reduction covers every shard.

Distributed semantics: partial aggregates merge with the second-phase
op (COUNT partials are summed; MEAN travels as a float64 SUM and a
COUNT), as in the JAX package.
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import bits_container, movable, numpy_dtype
from . import kernels as _kernels
from .order import cumsum_rows, lexsort_indices, row_neq_sorted


class AggregationOp(enum.IntEnum):
    """Reference: groupby/groupby_aggregate_ops.hpp
    ``GroupByAggregationOp`` (SUM/COUNT/MIN/MAX), plus MEAN."""

    SUM = 0
    COUNT = 1
    MIN = 2
    MAX = 3
    MEAN = 4


def second_phase_op(op: AggregationOp) -> AggregationOp:
    """The op that merges per-shard partials (COUNT partials are summed)."""
    if op == AggregationOp.COUNT:
        return AggregationOp.SUM
    return op


def _max_of(dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        return np.inf
    if d.kind == "b":
        return True
    return np.iinfo(d).max


def _min_of(dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        return -np.inf
    if d.kind == "b":
        return False
    return np.iinfo(d).min


def _identity_for(op: AggregationOp, dtype: torch.dtype):
    """The reduction identity of ``op`` for a torch dtype, as a Python
    scalar."""
    if op in (AggregationOp.SUM, AggregationOp.COUNT, AggregationOp.MEAN):
        return 0
    nd = numpy_dtype(dtype)
    return _max_of(nd) if op == AggregationOp.MIN else _min_of(nd)


def float_order_key(x: torch.Tensor) -> torch.Tensor:
    """Float bits as a signed integer whose order is the float order with
    -0.0 below +0.0 (XLA's min/max order); the map is its own inverse
    (``float_order_key(k).view(float dtype)``). NaNs sort past +inf, so
    callers propagate them apart."""
    b = x.view(bits_container(x.dtype))
    return torch.where(b < 0, b ^ torch.iinfo(b.dtype).max, b)


def _minmax(reduce: Callable, x: torch.Tensor, how: str, ident,
            use: torch.Tensor) -> torch.Tensor:
    """Segment MIN/MAX of ``x`` (its unused rows already ``ident``). For
    floats, XLA's semantics: -0.0 < +0.0 and a NaN in a group's used rows
    makes the result NaN; torch's amin/amax treat the zeros as equal."""
    if not x.dtype.is_floating_point:
        return reduce(x, how, ident)
    ik = float_order_key(torch.full((), ident, dtype=x.dtype))
    k = reduce(float_order_key(x), how, int(ik))
    out = float_order_key(k).view(x.dtype)
    nan = reduce((use & torch.isnan(x)).to(torch.int32), "amax", 0) > 0
    return torch.where(nan, torch.full((), float("nan"), dtype=x.dtype,
                                       device=x.device), out)


def _batched(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return x if x is None or x.dim() == 2 else x.unsqueeze(0)


def presort_groups(keys: Sequence[torch.Tensor], emit: torch.Tensor,
                   values: Sequence[torch.Tensor],
                   valids: Sequence[Optional[torch.Tensor]]):
    """Sort rows into contiguous groups: one stable lexsort by (dead
    flag, key bits...), then one gather per operand. Inputs are ``[n]``
    or ``[W, n]`` (per shard); outputs are ``[W, n]``.

    ``valids`` entries may be None (an all-valid column); they stay None.

    Returns (values_s, valids_s, emit_s, iota_s, gid_s, n_groups): gid_s
    the dense group id of each sorted row (dead rows, all last, carry the
    id of the last live group or -1), iota_s the original row of each
    sorted row, n_groups int64 [W] on the device (the caller's only host
    sync)."""
    emit = _batched(emit)
    keys = [_batched(k) for k in keys]
    dead = (~emit).to(torch.uint8)
    perm = lexsort_indices([dead] + keys)

    def take(x):
        return movable(x).gather(-1, perm).view(x.dtype)

    values_s = tuple(take(_batched(v)) for v in values)
    valids_s = tuple(None if v is None else take(_batched(v))
                     for v in valids)
    emit_s = emit.gather(-1, perm)
    # dead rows are all last, so live rows form a prefix and the cumsum of
    # group starts numbers the groups 0, 1, ... in key order
    new_grp = row_neq_sorted([k.gather(-1, perm) for k in keys]) & emit_s
    gid_s = cumsum_rows(new_grp) - 1
    return (values_s, valids_s, emit_s, perm, gid_s,
            new_grp.sum(-1, dtype=torch.int64))


def _segment_reducer(gid_s: torch.Tensor, emit_s: torch.Tensor,
                     num_segments: int) -> Callable:
    """reduce(x, how, init) -> [W, num_segments]: the segment MIN or MAX
    (``how`` "amin" or "amax") of ``x`` [W, n] over the sorted group ids,
    by ``scatter_reduce_`` atomics, exact in any order. Callers give dead
    rows the identity, so a dead row may land in any slot: dead row i goes
    to slot ``i % (num_segments + 1)``, spread out, since one slot for all
    of them serialises the atomics (51 ms for the 33 M dead rows of the
    join -> groupby cell's partials on an H100,
    scripts/profile_port_groupby.py)."""
    w, n = gid_s.shape
    s1 = num_segments + 1
    pos = torch.arange(n, device=gid_s.device)
    off = torch.arange(w, device=gid_s.device).unsqueeze(-1) * s1
    seg = (torch.where(emit_s, gid_s, pos % s1) + off).reshape(-1)

    def reduce(x: torch.Tensor, how: str, init) -> torch.Tensor:
        out = torch.full((w * s1,), init, dtype=x.dtype, device=x.device)
        out.scatter_reduce_(0, seg, x.reshape(-1), how)
        return out.view(w, s1)[:, :num_segments]

    return reduce


# slots past the groups' (and one more) that a boundary scatter sends the
# other rows to, spread out: one slot for all of them would serialise the
# writes
_SPREAD_SLOTS = 4096


def _start_slots(gid_s: torch.Tensor, emit_s: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """int64 [W, n]: each group's first sorted row's slot (its gid), and
    for every other row a spread slot past num_segments + 1."""
    n = gid_s.shape[-1]
    start = emit_s.clone()
    start[:, 1:] &= gid_s[:, 1:] != gid_s[:, :-1]
    junk = torch.arange(n, device=gid_s.device) % _SPREAD_SLOTS \
        + (num_segments + 1)
    return torch.where(start, gid_s, junk)


def _scatter_starts(slots: torch.Tensor, values: torch.Tensor,
                    num_segments: int, fill) -> torch.Tensor:
    """[W, num_segments + 1]: ``values`` ([W, n] or [n]) at each group's
    first row in its slot (one write a slot), ``fill`` (a scalar or [W,
    1]) in the slots of groups that do not exist and in the last; one
    scatter."""
    w, n = slots.shape
    out = torch.empty((w, num_segments + 1 + min(n, _SPREAD_SLOTS)),
                      dtype=values.dtype, device=slots.device)
    if isinstance(fill, torch.Tensor):
        out.copy_(fill.expand_as(out))
    else:   # a Python scalar: no copy to the device, which would wait
        out.fill_(fill)
    out.scatter_(1, slots, values.expand(w, n))
    return out[:, :num_segments + 1]


def _group_bounds(slots: torch.Tensor, emit_s: torch.Tensor,
                  num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first, end) int64 [W, num_segments]: group g's sorted rows are
    [first, end): groups are dense and live rows a prefix, so group g
    ends where g + 1 starts and the last at the shard's live count, which
    also fills the slots of groups that do not exist (first = end)."""
    n = slots.shape[-1]
    starts = _scatter_starts(slots, torch.arange(n, device=slots.device),
                             num_segments, emit_s.sum(-1, keepdim=True))
    return starts[:, :-1], starts[:, 1:]


def _bounded_sum(x: torch.Tensor, first: torch.Tensor,
                 end: torch.Tensor) -> torch.Tensor:
    """int64 [W, S]: the sum of x [W, n] (integers, 0 where unused) over
    rows [first, end) of each slot, a difference of one exclusive int64
    cumsum over the rows of every shard in turn; it wraps modulo 2^64, so
    the sum wraps as any order of adds does."""
    w, n = x.shape
    c = torch.empty(w * n + 1, dtype=torch.int64, device=x.device)
    c[:1].zero_()
    torch.cumsum(x.reshape(-1), 0, dtype=torch.int64, out=c[1:])
    off = torch.arange(w, device=x.device).unsqueeze(-1) * n
    return c[end + off] - c[first + off]


def sorted_segment_aggregate(gid_s: torch.Tensor, emit_s: torch.Tensor,
                             iota_s: torch.Tensor,
                             values_s: Sequence[torch.Tensor],
                             valids_s: Sequence[Optional[torch.Tensor]],
                             num_segments: int,
                             ops: Sequence[AggregationOp],
                             col_ids: Sequence, all_valid: Sequence[bool]):
    """Aggregate presorted ``[W, n]`` value columns into ``[W,
    num_segments]`` group slots.

    Repeated sub-reductions run once (``col_ids`` name each value's
    source column): SUM/MIN/MAX/COUNT repeated on one column, MEAN
    reusing COUNT's tally; all-valid columns (``all_valid``) share one
    count and skip the any-valid pass (it equals group_valid). Every
    float sum (a float column's SUM, MEAN's float64 sum) goes into one K7
    call.

    Returns (rep, group_valid, [(agg, agg_valid)]): rep[w, g] the first
    original row of group g (``n`` past the last group), MEAN a float64
    array, COUNT int64 of the non-null values."""
    n = gid_s.shape[-1]
    # the sort is stable, so a group's first sorted row holds its first
    # original row
    slots = _start_slots(gid_s, emit_s, num_segments)
    rep = _scatter_starts(slots, iota_s, num_segments, n)[:, :-1]
    group_valid = rep < n

    sub: Dict[tuple, torch.Tensor] = {}

    def memo(key, compute):
        hit = sub.get(key)
        if hit is None:
            hit = sub[key] = compute()
        return hit

    def bounds():
        return memo(("bounds",), lambda: _group_bounds(
            slots, emit_s, num_segments))

    def used(arr, vmask, cid):
        """arr where the row is valid, else 0; sums read live rows only
        (K7 its live rows, _bounded_sum the groups' rows), so an
        all-valid column goes as it is."""
        if vmask is None:
            return arr
        return memo(("used", cid),
                    lambda: torch.where(emit_s & vmask, arr, 0))

    # every float sum of the call, keyed (column, accumulator dtype), in
    # one K7 launch
    fsums: Dict[tuple, Tuple[torch.Tensor, torch.dtype]] = {}
    for arr, vmask, op, cid in zip(values_s, valids_s, ops, col_ids):
        if op == AggregationOp.SUM and arr.dtype.is_floating_point:
            fsums.setdefault(("fsum", cid, arr.dtype),
                             (used(arr, vmask, cid), arr.dtype))
        elif op == AggregationOp.MEAN:
            x = used(arr, vmask, cid)
            if x.dtype not in _kernels.SUM_DTYPES:
                x = memo(("f64", cid), lambda: x.to(torch.float64))
            fsums.setdefault(("fsum", cid, torch.float64),
                             (x, torch.float64))
    if fsums:
        sums = _kernels.segment_sum([x for x, _a in fsums.values()], gid_s,
                                    emit_s, num_segments,
                                    [a for _x, a in fsums.values()])
        sub.update(zip(fsums, sums))

    reduce = None
    results: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for arr, vmask, op, cid, av in zip(values_s, valids_s, ops, col_ids,
                                       all_valid):
        use = emit_s if vmask is None else (emit_s & vmask)
        vkey = "all" if av else cid

        def count(use=use, vkey=vkey):
            first, end = bounds()
            if vkey == "all":
                return memo(("count", vkey), lambda: end - first)
            return memo(("count", vkey),
                        lambda: _bounded_sum(use, first, end))

        if op == AggregationOp.COUNT:
            results.append((count(), group_valid))
            continue
        if op == AggregationOp.MEAN:
            s = sub[("fsum", cid, torch.float64)]
            c = count().to(torch.float64)
            results.append((s / torch.clamp(c, min=1),
                            group_valid & (c > 0)))
            continue
        if op == AggregationOp.SUM:
            if arr.dtype.is_floating_point:
                out = sub[("fsum", cid, arr.dtype)]
            else:
                first, end = bounds()
                out = memo(("isum", cid), lambda: _bounded_sum(
                    used(arr, vmask, cid), first, end).to(arr.dtype))
        else:
            if reduce is None:
                reduce = _segment_reducer(gid_s, emit_s, num_segments)
            ident = _identity_for(op, arr.dtype)
            x = torch.where(use, arr, torch.full((), ident, dtype=arr.dtype,
                                                 device=arr.device))
            how = "amin" if op == AggregationOp.MIN else "amax"
            out = memo((how, cid), lambda: _minmax(reduce, x, how, ident,
                                                   use))
        if av:
            # all rows valid: a group's value is valid iff the group is
            results.append((out, group_valid))
        else:
            results.append((out, group_valid & (count() > 0)))
    return rep, group_valid, results
