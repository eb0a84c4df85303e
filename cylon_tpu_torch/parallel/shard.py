"""Row-sharding of tables over the virtual world (counterpart of
cylon_tpu.parallel.shard).

A distributed table keeps ONE flat tensor per column: every shard is
padded to one common capacity ``cap`` and shard s holds rows ``[s*cap,
(s+1)*cap)``; the padding rows are dead in the table's ``row_mask``.
Per-shard kernels view a column as ``[W, cap]``.
"""
from __future__ import annotations

import torch

from ..context import CylonContext
from ..data.column import Column
from ..data.table import Table

# per-shard capacities are rounded to a multiple of 8, as in the JAX
# package, so both packages hold the same padded layout
_ROW_QUANTUM = 8


def shard_capacity(n: int, world: int) -> int:
    """Per-shard padded capacity for n global rows."""
    c = -(-max(n, 1) // world)
    return -(-c // _ROW_QUANTUM) * _ROW_QUANTUM


def _pad_to(x: torch.Tensor, total: int, fill) -> torch.Tensor:
    n = x.shape[0]
    if n == total:
        return x
    pad = torch.full((total - n,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def is_distributed_table(table: Table, ctx: CylonContext) -> bool:
    return table._shard_world == ctx.get_world_size()


def distribute(table: Table, ctx: CylonContext) -> Table:
    """Shard a table's rows over the virtual world (pad to ``W * cap``).
    Already-distributed tables pass through untouched; padding rows are
    dead in the result's ``row_mask``."""
    if is_distributed_table(table, ctx):
        return table
    world = ctx.get_world_size()
    n = table.capacity
    total = world * shard_capacity(n, world)
    cols = []
    for c in table._columns:
        validity = None if c.validity is None \
            else _pad_to(c.validity, total, False)
        cols.append(Column(_pad_to(c.data, total, 0), c.dtype, validity,
                           c.name))
    if table.row_mask is None and total == n:
        mask = None  # no padding, all rows live: keep the dense invariant
    else:
        mask = _pad_to(table.emit_mask(), total, False)
    out = Table(cols, ctx, mask)
    out._shard_world = world
    return out


def partition_signature(key_cols, idxs, world: int):
    """Hashable co-partitioning witness: a table whose rows were placed by
    hash of these key columns (with these dtypes) can skip a later
    exchange on the same keys."""
    return (tuple(int(i) for i in idxs),
            tuple(str(c.data.dtype) for c in key_cols), int(world))
