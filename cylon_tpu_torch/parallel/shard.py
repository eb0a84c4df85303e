"""Row-sharding of tables over the world's shards (counterpart of
cylon_tpu.parallel.shard).

A distributed table keeps ONE flat tensor per column: every shard is
padded to one common capacity ``cap`` and shard s holds rows ``[s*cap,
(s+1)*cap)``; the padding rows are dead in the table's ``row_mask``.
Per-shard kernels view a column as ``[V, cap]``. In the virtual world V
= W and one process holds every shard; with several processes
(config.MultiHostConfig) process p's tensors hold its own shards
``[p * V, (p + 1) * V)`` only, as each controller of the JAX package's
multi-host mesh holds its addressable shards.

Ingest and export per process: `distribute` places this process's
shards of a table every process holds (JAX's ``device_put`` with a
sharding); `assemble_process_local` builds a table from one host table
per local shard (per-rank files), `distribute_by_key` from a host-side
hash partition; `extract_process_local` hands this process's rows out.
"""
from __future__ import annotations

import numpy as np
import torch

from ..context import CylonContext
from ..data.column import Column, as_varbytes
from ..data.table import Table
from ..dtypes import Type, np_name
from ..status import Code, CylonError, CylonPlanError
from ..telemetry.metrics import record_host_sync as _host_sync
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
    """Shard a table's rows over the world (pad to ``W * cap``); each
    process keeps its own shards' rows, ``[first * cap, (first + V) *
    cap)`` of the padded layout, of a table every process holds whole.
    Already-distributed tables pass through untouched; padding rows are
    dead in the result's ``row_mask``."""
    if is_distributed_table(table, ctx):
        return table
    world = ctx.get_world_size()
    local = ctx.local_shard_indices()
    n = table.capacity
    total = world * shard_capacity(n, world)
    cap = total // world
    lo, hi = local[0] * cap, (local[-1] + 1) * cap
    cols = []
    for c in table._columns:
        validity = None if c.validity is None \
            else _pad_to(c.validity, total, False)[lo:hi]
        if c.is_varbytes:
            vb = _distribute_varbytes(c.varbytes, n, cap, world, local)
            cols.append(Column(vb.lengths, c.dtype, validity, c.name,
                               varbytes=vb))
            continue
        cols.append(Column(_pad_to(c.data, total, 0)[lo:hi], c.dtype,
                           validity, c.name, dictionary=c.dictionary))
    if table.row_mask is None and total == n:
        mask = None  # no padding, all rows live: keep the dense invariant
    else:
        mask = _pad_to(table.emit_mask(), total, False)[lo:hi]
    out = Table(cols, ctx, mask)
    out._shard_world = world
    return out


def _distribute_varbytes(vb, n: int, cap: int, world: int, local):
    """Shard a varbytes column as the JAX package does: each shard gets a
    self-contained layout (shard-relative starts), the shards' word
    buffers padded to one capacity. A shard's rows are a contiguous row
    range, so its words are a contiguous slice of the source buffer (the
    starts are monotone): one copy per shard on the device, and one host
    fetch of the 2 * world slice bounds. The word capacity comes from
    every shard's slice, so each process of a multi-process world, which
    holds the whole source, picks the same; it keeps its ``local``
    shards."""
    from ..data.strings import VarBytes, _nwords

    dev = vb.device
    estarts = vb.eff_starts()
    rows = [(s * cap, min((s + 1) * cap, n)) for s in range(world)]
    live = [(lo, hi) for lo, hi in rows if lo < hi]
    bounds = []
    if live:
        bounds = torch.stack([torch.stack([estarts[lo], estarts[hi - 1]
                                           + _nwords(vb.lengths[hi - 1])])
                              for lo, hi in live]).cpu().tolist()
        # one copy where the JAX package makes three (words, starts and
        # lengths, whole)
        _host_sync("distribute.varbytes")
    spans = iter(bounds)
    slices = [tuple(next(spans)) if lo < hi else (0, 0) for lo, hi in rows]
    wc = _capacity(max(max(w_hi - w_lo for w_lo, w_hi in slices), 1))
    v = len(local)
    words = torch.zeros(v * wc, dtype=torch.int32, device=dev)
    st = torch.zeros(v * cap, dtype=torch.int32, device=dev)
    ln = torch.zeros(v * cap, dtype=torch.int32, device=dev)
    for j, s in enumerate(local):
        (w_lo, w_hi), (lo, hi) = slices[s], rows[s]
        if lo >= hi:
            continue
        words[j * wc: j * wc + (w_hi - w_lo)] = vb.words[w_lo:w_hi]
        st[j * cap: j * cap + (hi - lo)] = estarts[lo:hi] - w_lo
        ln[j * cap: j * cap + (hi - lo)] = vb.lengths[lo:hi]
    return VarBytes(words, st, ln, vb.max_words, v * wc,
                    shard_geom=(cap, wc))


def partition_signature(key_cols, idxs, world: int):
    """Hashable co-partitioning witness: a table whose rows were placed by
    hash of these key columns (with these dtypes) can skip a later
    exchange on the same keys. None for string keys (vocabulary
    unification re-codes them). The dtypes are spelled by their numpy
    names, as the JAX package spells them (the plan layer compares them
    with its type strings)."""
    if any(c.is_string for c in key_cols):
        return None
    return (tuple(int(i) for i in idxs),
            tuple(np_name(c.data.dtype) for c in key_cols), int(world))


def host_partition_arrays(t: Table, idxs, world: int):
    """The host-side partition of a dense table's rows by the hash of its
    key columns, shared by `distribute_by_key` and the host route of
    ``dist_ops.hash_partition``: (host columns, host validities, counts
    int64 [world], the stable order grouping rows by target, offsets
    [world + 1]). Varbytes columns come to the host as object arrays;
    varbytes keys hash their bytes through the host mirror of the device
    content hash (``native.np_varbytes_hash``), so placement is a pure
    function of the key values."""
    from .. import native

    host, valids = [], []
    for c in t._columns:
        host.append(c.varbytes.to_host(as_str=c.dtype.type != Type.BINARY)
                    if c.is_varbytes else c.data.cpu().numpy())
        valids.append(None if c.validity is None
                      else c.validity.cpu().numpy())
    _host_sync("ingest.host_partition",
               len(host) + sum(v is not None for v in valids))
    pre = [t._columns[i].is_varbytes for i in idxs]
    keys = [native.np_varbytes_hash(host[i]) if p else host[i]
            for i, p in zip(idxs, pre)]
    flags = [t._columns[i].dictionary is not None for i in idxs]
    _targets, counts, order = native.hash_partition(
        keys, [valids[i] for i in idxs], world, is_string=flags,
        prehashed=pre)
    offs = np.concatenate([[0], np.cumsum(counts)])
    return host, valids, counts, order, offs


def distribute_by_key(table: Table, ctx: CylonContext, key_columns) -> Table:
    """Host-side pre-partitioned ingest: place every row of a table every
    process holds on the shard its key hashes to (the placement a device
    shuffle would produce; `host_partition_arrays`), each process
    building its own shards. The result carries the co-partitioning
    witness, so `shuffle` on the same keys is a no-op and
    `distributed_join` skips that side's exchange. Varbytes columns go
    through `assemble_process_local`, on one process only, as in the JAX
    package."""
    from ..data.strings import VarBytes

    world = ctx.get_world_size()
    idxs = [table._col_index(c) for c in key_columns]
    t = table.compact()
    key_cols = [t._columns[i] for i in idxs]
    host, valids, counts, order, offs = host_partition_arrays(t, idxs, world)
    sig = partition_signature(key_cols, idxs, world)
    dev = ctx.device

    if any(c.is_varbytes for c in t._columns):
        if ctx.is_multiprocess():
            raise CylonPlanError(
                "multi-host distribute_by_key with varbytes columns: "
                "use per-rank file placement (read_csv_per_rank)",
                code=Code.NotImplemented)
        shard_tables = []
        for s in range(world):
            seg = order[offs[s]:offs[s + 1]]
            cols = []
            for ci, c in enumerate(t._columns):
                v = None if valids[ci] is None \
                    else torch.from_numpy(valids[ci][seg]).to(dev)
                if c.is_varbytes:
                    vb = VarBytes.from_host(host[ci][seg], device=dev)
                    cols.append(Column(vb.lengths, c.dtype, v, c.name,
                                       varbytes=vb))
                else:
                    cols.append(Column(torch.from_numpy(np.ascontiguousarray(
                        host[ci][seg])).to(dev), c.dtype, v, c.name,
                        dictionary=c.dictionary))
            shard_tables.append(Table(cols, ctx))
        out = assemble_process_local(shard_tables, ctx)
        out._hash_partitioned = sig
        return out

    local = ctx.local_shard_indices()
    cap = shard_capacity(int(counts.max()), 1)

    def build(arr, fill):
        g = np.asarray(arr)[order]
        out = np.full(len(local) * cap, fill, g.dtype)
        for j, s in enumerate(local):
            out[j * cap:j * cap + counts[s]] = g[offs[s]:offs[s + 1]]
        return torch.from_numpy(out).to(dev)

    cols = []
    for ci, c in enumerate(t._columns):
        validity = None if valids[ci] is None else build(valids[ci], False)
        cols.append(Column(build(host[ci], 0), c.dtype, validity, c.name,
                           dictionary=c.dictionary))
    out = Table(cols, ctx, build(np.ones(t.capacity, np.bool_), False))
    out._shard_world = world
    out._hash_partitioned = sig
    return out


def assemble_process_local(tables, ctx: CylonContext) -> Table:
    """ONE distributed table from per-shard host tables, one per shard
    this process owns (``len(ctx.local_shard_indices())``; the per-rank
    file convention, cpp/test/join_test.cpp:22-24). Every process calls
    it with its own shards' tables. Row counts may be ragged: every
    shard is padded to the global maximum, agreed by one all-gather of
    the row and word counts, and the padding is masked dead.

    String columns are lifted to varbytes storage, whose content hashes
    need no vocabulary shared between processes. What the processes must
    agree on, they agree here: the column types (a mismatch raises), the
    string columns' word capacities and ``max_words``, and which columns
    carry a validity mask (a process whose files hold no null still
    builds one, so every process's tables have the same leaves)."""
    from ..data.strings import VarBytes

    local = ctx.local_shard_indices()
    if len(tables) != len(local):
        raise CylonPlanError(
            f"need one table per local shard ({len(local)}), "
            f"got {len(tables)}")
    tables = [t.compact() for t in tables]
    cm = ctx.comm
    ncols = tables[0].column_count
    types = np.array([[int(c.dtype.type) for c in t._columns]
                      for t in tables], np.int64)
    every = cm.all_gather_host(types)
    if any(t.column_count != ncols for t in tables) \
            or not (every == every[0, 0]).all():
        raise CylonError(Code.TypeError,
                         "per-shard tables disagree on their column types")
    vb_cols = [ci for ci in range(ncols)
               if any(t._columns[ci].is_string for t in tables)]
    lifted = {ci: [as_varbytes(t._columns[ci]) for t in tables]
              for ci in vb_cols}
    # rows, each string column's words, then the validity flags and
    # max_words: one gather, maxed over every shard of every process
    counts = np.array(
        [[t.capacity for t in tables]]
        + [[c.varbytes.total_words for c in lifted[ci]] for ci in vb_cols]
        + [[any(t._columns[ci].validity is not None for t in tables)]
           * len(tables) for ci in range(ncols)]
        + [[max(c.varbytes.max_words for c in lifted[ci])] * len(tables)
           for ci in vb_cols], np.int64)
    agreed = cm.all_gather_host(counts).max(axis=(0, 2))
    cap = max(-(-int(agreed[0]) // _ROW_QUANTUM) * _ROW_QUANTUM,
              _ROW_QUANTUM)
    word_caps = {ci: _capacity(max(int(agreed[1 + k]), 1))
                 for k, ci in enumerate(vb_cols)}
    has_validity = agreed[1 + len(vb_cols):1 + len(vb_cols) + ncols] > 0
    max_words = {ci: int(agreed[1 + len(vb_cols) + ncols + k])
                 for k, ci in enumerate(vb_cols)}

    def build(parts, fill, pad_len=cap):
        """Each local shard's tensor padded to ``pad_len``, stacked."""
        return torch.cat([_pad_to(x.to(ctx.device), pad_len, fill)
                          for x in parts])

    cols = []
    for ci in range(ncols):
        ref = tables[0]._columns[ci]
        validity = build([t._columns[ci].valid_mask() for t in tables],
                         False) if has_validity[ci] else None
        if ci in vb_cols:
            parts = [c.varbytes for c in lifted[ci]]
            wc = word_caps[ci]
            vb = VarBytes(build([p.words[:p.total_words] for p in parts], 0,
                                wc),
                          build([p.eff_starts().to(torch.int32)
                                 for p in parts], 0),
                          build([p.lengths for p in parts], 0),
                          max_words[ci], len(local) * wc,
                          shard_geom=(cap, wc))
            cols.append(Column(vb.lengths, ref.dtype, validity, ref.name,
                               varbytes=vb))
            continue
        cols.append(Column(build([t._columns[ci].data for t in tables], 0),
                           ref.dtype, validity, ref.name))
    emit = build([torch.ones(t.capacity, dtype=torch.bool) for t in tables],
                 False)
    out = Table(cols, ctx, emit)
    out._shard_world = ctx.get_world_size()
    return out


def extract_process_local(table: Table, ctx: CylonContext) -> dict:
    """Host numpy dict of THIS process's shards' live rows, in shard
    order: the per-process handoff out of a distributed table (the
    export mirror of `assemble_process_local`), e.g. to feed each
    process's training loop without any global gather (reference:
    demo_pytorch_distributed.py:1-50 feeds each rank its partition).
    Nulls come out as NaN in float columns and None elsewhere."""
    t = table._compact_rows()
    return {name: c.to_numpy() for name, c in zip(t._unique_names(),
                                                 t._columns)}
