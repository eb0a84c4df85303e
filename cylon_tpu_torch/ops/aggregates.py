"""Scalar column aggregates: table-level sum/count/min/max/mean
(counterpart of cylon_tpu.ops.aggregates).

Reference: cpp/src/cylon/compute/aggregates.cpp:113-339 — a local
reduction followed by an all-reduce of the scalar. A distributed table
keeps every shard in one flat tensor, so one reduction over its live
rows spans all shards. Nulls are skipped; count counts non-null rows;
string min/max are lexicographic.
The result is a Python scalar, as in the JAX package: sum keeps torch's
(and numpy's) promotion of small integers to int64.

A table spread over several processes reduces each process's rows to
one partial; every process gathers the partials and combines them in
rank order, so each gets the same scalar (at one process the one
partial is the result). Counts, integer sums and MIN/MAX equal the
one-process result exactly; a float SUM adds its partials in rank
order, which is PERF.md section 2's contract (within ``1e-5 * sum |x|``
of any other order), not a sum in row order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dtypes import Type, numpy_dtype
from ..status import Code, CylonError
from .groupby import _max_of, _min_of, float_order_key
from .order import lexsort_indices


def _arith(x: torch.Tensor) -> torch.Tensor:
    """uint16/uint32 values widened to int64 (torch has no reductions for
    them on every device); other dtypes as they are."""
    if x.dtype in (torch.uint16, torch.uint32):
        return x.to(torch.int64)
    return x


def _fill(x: torch.Tensor, valid: torch.Tensor, value) -> torch.Tensor:
    return torch.where(valid, x, torch.full((), value, dtype=x.dtype,
                                            device=x.device))


def _extreme(data: torch.Tensor, valid: torch.Tensor, op: str
             ) -> torch.Tensor:
    """min or max of the valid values as a 0-dim tensor; the identity
    when none is valid. Floats follow XLA: a NaN wins, and -0.0 <
    +0.0."""
    ident = (_max_of if op == "min" else _min_of)(numpy_dtype(data.dtype))
    data = _arith(data)
    x = _fill(data, valid, ident)
    if not data.dtype.is_floating_point:
        return x.min() if op == "min" else x.max()
    if bool((valid & torch.isnan(data)).any()):
        return torch.full((), float("nan"), dtype=data.dtype,
                          device=data.device)
    k = float_order_key(x)
    k = k.min() if op == "min" else k.max()
    return float_order_key(k).view(data.dtype)


def _string_extreme(col, valid: torch.Tensor, op: str):
    """Lexicographic min/max of a string column as str (bytes for
    BINARY), None when no row is valid. Dictionary columns reduce their
    codes; varbytes columns sort their prefix keys once and decode only
    the winning row (rows past the device prefix bound: on the host)."""
    if not bool(valid.any()):
        return None
    if col.dictionary is not None:
        x = _fill(col.data, valid, (1 << 31) - 1 if op == "min" else -1)
        return str(col.dictionary[int(x.min() if op == "min" else x.max())])
    as_str = col.dtype.type != Type.BINARY
    vb = col.varbytes
    if not vb.sortable_on_device:
        vals = [v for v in col.to_numpy() if v is not None]
        return min(vals) if op == "min" else max(vals)
    keys = vb.sort_prefix_keys()
    if op == "max":
        keys = [~k for k in keys]
    keys = [torch.where(valid, k, -1) for k in keys]  # nulls lose
    v = vb.take(lexsort_indices(keys)[:1]).to_host(as_str=as_str)[0]
    return str(v) if as_str else bytes(v)


def _partials(gather, value: torch.Tensor) -> torch.Tensor:
    """Every process's 0-dim partial ``value`` as a 1-D host tensor in
    rank order; ``gather`` takes a 1-D host array and returns every
    process's (`parallel.comm.all_gather_rows`). The partial crosses as
    its bytes, so every dtype does and no bit changes."""
    x = value.reshape(1).cpu()
    parts = gather(x.view(torch.uint8).numpy())
    return torch.from_numpy(np.concatenate(parts)).view(x.dtype)


def _rank_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """The partials added one after another in rank order, in their own
    dtype (integers wrap as torch's sum does)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def agg_scalar(col, op: str, gather, gather_bytes):
    """One scalar aggregate of a column, as a Python scalar: this
    process's partial, every process's partials through ``gather`` (1-D
    host arrays, `parallel.comm.all_gather_rows`) and ``gather_bytes``
    (lists of byte strings, `parallel.comm.all_gather_bytes`), combined
    in rank order. Both return this process's own at one process. Every
    process of a table spread over processes must call it, and every
    process returns the same scalar."""
    valid = col.valid_mask()
    if op == "count":
        return int(_partials(gather, valid.sum()).sum())
    if col.is_string:
        if op not in ("min", "max"):
            raise CylonError(Code.TypeError,
                             f"{op} unsupported for string column")
        part = _string_extreme(col, valid, op)
        as_str = col.dtype.type != Type.BINARY or col.dictionary is not None
        enc = None if part is None else (
            part.encode("utf-8") if isinstance(part, str) else bytes(part))
        every = [v for p in gather_bytes([enc]) for v in p if v is not None]
        if not every:
            return None
        # UTF-8 bytes order as their code points do: the order of
        # _string_extreme on either storage
        pick = min(every) if op == "min" else max(every)
        return pick.decode("utf-8") if as_str else pick
    data = col.data
    if op == "sum":
        return _rank_order_sum(_partials(
            gather, _fill(_arith(data), valid, 0).sum())).item()
    if op in ("min", "max"):
        parts = _partials(gather, _extreme(data, valid, op))
        return _extreme(parts, torch.ones(parts.shape, dtype=torch.bool),
                        op).item()
    if op == "mean":
        s = _rank_order_sum(_partials(
            gather, _fill(data.to(torch.float64), valid, 0).sum()))
        count = int(_partials(gather, valid.sum()).sum())
        return float(s) / max(count, 1)
    raise CylonError(Code.Invalid, f"unknown aggregate {op}")
