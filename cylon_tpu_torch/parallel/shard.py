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
from ..util import capacity as _capacity

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
    cap = total // world
    cols = []
    for c in table._columns:
        validity = None if c.validity is None \
            else _pad_to(c.validity, total, False)
        if c.is_varbytes:
            vb = _distribute_varbytes(c.varbytes, n, cap, world)
            cols.append(Column(vb.lengths, c.dtype, validity, c.name,
                               varbytes=vb))
            continue
        cols.append(Column(_pad_to(c.data, total, 0), c.dtype, validity,
                           c.name, dictionary=c.dictionary))
    if table.row_mask is None and total == n:
        mask = None  # no padding, all rows live: keep the dense invariant
    else:
        mask = _pad_to(table.emit_mask(), total, False)
    out = Table(cols, ctx, mask)
    out._shard_world = world
    return out


def _distribute_varbytes(vb, n: int, cap: int, world: int):
    """Shard a varbytes column as the JAX package does: each shard gets a
    self-contained layout (shard-relative starts), the shards' word
    buffers padded to one capacity. A shard's rows are a contiguous row
    range, so its words are a contiguous slice of the source buffer (the
    starts are monotone): one copy per shard on the device, and one host
    fetch of the 2 * world slice bounds."""
    from ..data.strings import VarBytes, _nwords

    dev = vb.device
    estarts = vb.eff_starts()
    rows = [(s * cap, min((s + 1) * cap, n)) for s in range(world)]
    live = [(lo, hi) for lo, hi in rows if lo < hi]
    bounds = torch.stack([torch.stack([estarts[lo], estarts[hi - 1]
                                       + _nwords(vb.lengths[hi - 1])])
                          for lo, hi in live]).cpu().tolist() if live else []
    spans = iter(bounds)
    slices = [tuple(next(spans)) if lo < hi else (0, 0) for lo, hi in rows]
    wc = _capacity(max(max(w_hi - w_lo for w_lo, w_hi in slices), 1))
    words = torch.zeros(world * wc, dtype=torch.int32, device=dev)
    st = torch.zeros(world * cap, dtype=torch.int32, device=dev)
    ln = torch.zeros(world * cap, dtype=torch.int32, device=dev)
    for s, ((w_lo, w_hi), (lo, hi)) in enumerate(zip(slices, rows)):
        if lo >= hi:
            continue
        words[s * wc: s * wc + (w_hi - w_lo)] = vb.words[w_lo:w_hi]
        st[s * cap: s * cap + (hi - lo)] = estarts[lo:hi] - w_lo
        ln[s * cap: s * cap + (hi - lo)] = vb.lengths[lo:hi]
    return VarBytes(words, st, ln, vb.max_words, world * wc,
                    shard_geom=(cap, wc))


def partition_signature(key_cols, idxs, world: int):
    """Hashable co-partitioning witness: a table whose rows were placed by
    hash of these key columns (with these dtypes) can skip a later
    exchange on the same keys. None for string keys (vocabulary
    unification re-codes them)."""
    if any(c.is_string for c in key_cols):
        return None
    return (tuple(int(i) for i in idxs),
            tuple(str(c.data.dtype) for c in key_cols), int(world))
