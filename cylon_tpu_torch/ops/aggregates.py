"""Scalar column aggregates: table-level sum/count/min/max/mean
(counterpart of cylon_tpu.ops.aggregates).

Reference: cpp/src/cylon/compute/aggregates.cpp:113-339 — a local
reduction followed by an all-reduce of the scalar. A distributed table
keeps every shard in one flat tensor, so one reduction over its live
rows spans all shards. Nulls are skipped; count counts non-null rows.
The result is a Python scalar, as in the JAX package: sum keeps torch's
(and numpy's) promotion of small integers to int64.
"""
from __future__ import annotations

import torch

from ..dtypes import numpy_dtype
from ..status import Code, CylonError, not_ported
from .groupby import _max_of, _min_of, float_order_key


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


def agg_scalar(col, op: str):
    """One scalar aggregate of a column, as a Python scalar."""
    if col.dtype.is_var_width():
        raise not_ported("string columns in aggregates")
    valid = col.valid_mask()
    data = col.data
    if op == "count":
        return int(valid.sum())
    if op == "sum":
        return _fill(_arith(data), valid, 0).sum().item()
    if op in ("min", "max"):
        return _extreme(data, valid, op)
    if op == "mean":
        s = _fill(data.to(torch.float64), valid, 0).sum()
        return float(s) / max(int(valid.sum()), 1)
    raise CylonError(Code.Invalid, f"unknown aggregate {op}")
