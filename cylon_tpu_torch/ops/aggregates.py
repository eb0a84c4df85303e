"""Scalar column aggregates: table-level sum/count/min/max/mean
(counterpart of cylon_tpu.ops.aggregates).

Reference: cpp/src/cylon/compute/aggregates.cpp:113-339 — a local
reduction followed by an all-reduce of the scalar. A distributed table
keeps every shard in one flat tensor, so one reduction over its live
rows spans all shards. Nulls are skipped; count counts non-null rows;
string min/max are lexicographic.
The result is a Python scalar, as in the JAX package: sum keeps torch's
(and numpy's) promotion of small integers to int64.
"""
from __future__ import annotations

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


def _extreme(data: torch.Tensor, valid: torch.Tensor, op: str):
    """min or max of the valid values; the identity when none is valid.
    Floats follow XLA: a NaN wins, and -0.0 < +0.0."""
    ident = (_max_of if op == "min" else _min_of)(numpy_dtype(data.dtype))
    data = _arith(data)
    x = _fill(data, valid, ident)
    if not data.dtype.is_floating_point:
        return (x.min() if op == "min" else x.max()).item()
    if bool((valid & torch.isnan(data)).any()):
        return float("nan")
    k = float_order_key(x)
    k = k.min() if op == "min" else k.max()
    return float_order_key(k).view(data.dtype).item()


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


def agg_scalar(col, op: str):
    """One scalar aggregate of a column, as a Python scalar."""
    valid = col.valid_mask()
    data = col.data
    if op == "count":
        return int(valid.sum())
    if col.is_string:
        if op not in ("min", "max"):
            raise CylonError(Code.TypeError,
                             f"{op} unsupported for string column")
        return _string_extreme(col, valid, op)
    if op == "sum":
        return _fill(_arith(data), valid, 0).sum().item()
    if op in ("min", "max"):
        return _extreme(data, valid, op)
    if op == "mean":
        s = _fill(data.to(torch.float64), valid, 0).sum()
        return float(s) / max(int(valid.sum()), 1)
    raise CylonError(Code.Invalid, f"unknown aggregate {op}")
