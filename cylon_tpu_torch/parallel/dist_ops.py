"""Distributed relational operators: shuffle-composed, per-shard kernels
(counterpart of cylon_tpu.parallel.dist_ops: the shuffle, the join, the
set ops, the groupby, the sort, hash_partition and repartition).

The reference composes every distributed op as *local partition +
all-to-all + local op* (reference: DistributedJoin, table.cpp:656-696).
The same composition here:

  1. key prep on the flat sharded columns (elementwise): dtype promotion,
     order-preserving key bits, murmur-style partition targets;
  2. the counted padded exchange of parallel/shuffle.py;
  3. the per-shard op on ``[W, cap]`` views: matching keys (full rows for
     a set op) are co-located after the hash shuffle, so one batched call
     of the local op's routes covers every shard.

Results stay sharded: a result table holds ``W * cap`` rows, its padding
masked by ``row_mask``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes
from ..context import CylonContext
from ..data import table as table_mod
from ..data.column import Column
from ..data.table import Table
from ..dtypes import movable
from ..ops import groupby as _groupby
from ..ops import hash as _hash
from ..ops import join as _join
from ..ops import order as _order
from ..ops import setops as _setops
from ..status import Code, CylonError, not_ported
from ..util import bucket_cap as _bucket_cap
from . import shard
from .shuffle import count_pair, exchange, exchange_pair


def _dist_key_bits(cols: Sequence[Column]):
    """Key bit arrays (nulls pushed to the all-ones end) and combined key
    validity of flat sharded key columns. (The JAX package also returns
    the partition hashes here; no caller reads them after the exchange,
    so the port does not compute them.)"""
    return tuple(_order.sort_keys(list(cols))), table_mod._all_valid(cols)


def _targets_from_hashes(world: int, h1s: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """Combine per-column row hashes into a shard target (the
    ops/hash.hash_columns combine scheme, from the first hash)."""
    return (_hash.combine_hashes(h1s) % world).to(torch.int32)


def _partition_targets_dist(world: int, cols: Sequence[Column]
                            ) -> torch.Tensor:
    """Per-row target shard for the key columns."""
    return _targets_from_hashes(world, [_hash.hash_column(c) for c in cols])


def _build_exchange_payload(t: Table) -> dict:
    """Payload leaves of a table shuffle: all-valid columns skip their
    mask leaf (validity None round-trips as None)."""
    payload = {}
    for i, c in enumerate(t._columns):
        payload[f"d{i}"] = c.data
        if c.validity is not None:
            payload[f"v{i}"] = c.validity
    return payload


def _finish_exchange_table(t: Table, out, new_emit):
    cols = [Column(out[f"d{i}"], c.dtype, out.get(f"v{i}"), c.name)
            for i, c in enumerate(t._columns)]
    return cols, new_emit


def _exchange_table(t: Table, targets, emit, ctx, counts=None,
                    dense: bool = False):
    """Shuffle a whole table's columns. Returns (columns, new_emit)."""
    out, new_emit, _cap, _meta = exchange(_build_exchange_payload(t),
                                          targets, emit, ctx, counts=counts,
                                          dense=dense)
    return _finish_exchange_table(t, out, new_emit)


def _exchange_table_pair(t1: Table, tg1, e1, c1, t2: Table, tg2, e2, c2,
                         ctx, dense: bool = False):
    """The two-table shuffle of a distributed join."""
    r1, r2 = exchange_pair(_build_exchange_payload(t1), tg1, e1, c1,
                           _build_exchange_payload(t2), tg2, e2, c2, ctx,
                           dense=dense)
    return (_finish_exchange_table(t1, r1[0], r1[1]),
            _finish_exchange_table(t2, r2[0], r2[1]))


def _rebuild_columns(dat: Sequence, val: Sequence, src: Sequence[Column],
                     names: Sequence[str]) -> List[Column]:
    return [Column(d, c.dtype, v, name)
            for d, v, c, name in zip(dat, val, src, names)]


def _shards(xs, world: int) -> tuple:
    """Flat [W * cap] tensors as [W, cap] per-shard views."""
    return tuple(x.view(world, -1) for x in xs)


def _dist_stream_mode(lkb, rkb, join_type: _join.JoinType, world: int,
                      device: torch.device) -> Optional[Tuple[bool, int]]:
    """None (the plan route) or (hash_mode, block_rows) when the per-shard
    stream route applies: on CUDA the kernel route K3/K4, where the JAX
    package picks its Pallas kernels on a TPU."""
    if not _join._stream_on(device) \
            or join_type == _join.JoinType.FULL_OUTER:
        return None
    na = int(lkb[0].shape[0]) // world
    nb = int(rkb[0].shape[0]) // world
    if na == 0 or nb == 0 or na + nb >= (1 << 29):
        return None
    if len(lkb) == 1 and lkb[0].element_size() == 4:
        return (False, _join.stream_block_rows(na, nb))
    lanes = sum(2 if b.element_size() == 8 else 1 for b in lkb)
    if lanes <= _join.MAX_HASH_KEY_LANES:
        return (True, _join.stream_block_rows(na, nb))
    return None


def shuffle(table: Table, hash_columns: Sequence) -> Table:
    """Repartition rows by key hash (reference: cylon::Shuffle,
    table.cpp:162-236). Tables already hash-placed on the same keys pass
    through without an exchange."""
    ctx = table._ctx
    world = ctx.get_world_size()
    if world == 1:
        return table
    t = shard.distribute(table, ctx)
    idxs = [t._col_index(c) for c in hash_columns]
    sig = shard.partition_signature([t._columns[i] for i in idxs], idxs,
                                    world)
    if t._hash_partitioned == sig:
        return t
    targets = _partition_targets_dist(world, [t._columns[i] for i in idxs])
    cols, new_emit = _exchange_table(t, targets, t.emit_mask(), ctx,
                                     dense=t.row_mask is None)
    result = Table(cols, ctx, new_emit)
    result._shard_world = world
    result._hash_partitioned = sig
    return result


def distributed_join(left: Table, right: Table, config: _join.JoinConfig,
                     force_exchange: bool = False) -> Table:
    """The shuffle join (reference: DistributedJoin, table.cpp:656-696).
    ``force_exchange`` runs the full shuffle + join composition even on a
    one-shard world or co-partitioned inputs."""
    ctx = left._ctx
    world = ctx.get_world_size()
    if world == 1 and not (force_exchange and ctx.is_distributed()):
        # reference parity: world 1 short-circuits to the local join
        return table_mod.join(left, right, config)
    if config.exact:
        raise not_ported("exact=True joins (varbytes keys)")
    left_d = shard.distribute(left, ctx)
    right_d = shard.distribute(right, ctx)
    lidx, ridx = config.left_column_idx, config.right_column_idx
    # the JAX package's _align_key_columns_dist differs from
    # align_key_columns only for string keys, which are not ported
    lcols, rcols = table_mod.align_key_columns(left_d, right_d, lidx, ridx)

    plan = []
    for t, kcols, kidx in ((left_d, lcols, lidx), (right_d, rcols, ridx)):
        sig = shard.partition_signature(kcols, kidx, world)
        if t._hash_partitioned == sig and not force_exchange:
            # co-partitioned: rows are already hash-placed
            plan.append(("skip", t, None, None))
            continue
        plan.append(("exchange", t, _partition_targets_dist(world, kcols),
                     t.emit_mask()))
    ex = [p for p in plan if p[0] == "exchange"]
    results = {}
    if len(ex) == 2:
        # one count fetch covers both shuffles; a dense one-shard world
        # needs none (the exchange counts in-program)
        dense = ex[0][1].row_mask is None and ex[1][1].row_mask is None
        cl = cr = None
        if world > 1 or not dense:
            cl, cr = count_pair(ex[0][2], ex[0][3], ex[1][2], ex[1][3],
                                world)
        r1, r2 = _exchange_table_pair(ex[0][1], ex[0][2], ex[0][3], cl,
                                      ex[1][1], ex[1][2], ex[1][3], cr, ctx,
                                      dense=dense)
        results[id(ex[0])] = r1
        results[id(ex[1])] = r2
    shuffled = []
    for p in plan:
        kind, t, targets, emit = p
        if kind == "skip":
            shuffled.append((t._columns, t.emit_mask()))
        elif id(p) in results:
            shuffled.append(results[id(p)])
        else:
            shuffled.append(_exchange_table(t, targets, emit, ctx,
                                            dense=t.row_mask is None))

    # key bits from the SHUFFLED columns (elementwise ordered bits)
    (lcols_s, lemit), (rcols_s, remit) = shuffled
    left_s = Table(list(lcols_s), ctx, lemit)
    right_s = Table(list(rcols_s), ctx, remit)
    lcols2, rcols2 = table_mod.align_key_columns(left_s, right_s, lidx, ridx)
    lkb, lkv = _dist_key_bits(lcols2)
    rkb, rkv = _dist_key_bits(rcols2)
    ldat = _shards((c.data for c in lcols_s), world)
    lval = _shards((c.valid_mask() for c in lcols_s), world)
    rdat = _shards((c.data for c in rcols_s), world)
    rval = _shards((c.valid_mask() for c in rcols_s), world)
    lkb_w, rkb_w = _shards(lkb, world), _shards(rkb, world)
    lkv_w, rkv_w = lkv.view(world, -1), rkv.view(world, -1)
    lemit_w, remit_w = lemit.view(world, -1), remit.view(world, -1)

    jt = config.type
    res = None
    mode = _dist_stream_mode(lkb, rkb, jt, world, ctx.device)
    if mode is not None:
        hash_mode, br = mode
        a_desc, b_desc = _join.plan_lane_descs(ldat, lval, rdat, rval, jt)
        counts, a_streams, b_streams = _join.plan_program_stream(
            lkb_w, lkv_w, lemit_w, rkb_w, rkv_w, remit_w, ldat, lval, rdat,
            rval, jt, a_desc=a_desc, b_desc=b_desc, hash_mode=hash_mode)
        cm = counts.cpu().numpy()
        if not (hash_mode and int(cm[:, 3].sum()) > 0):
            cap_e = _join.stream_expand_capacity(int(cm[:, 0].max()), br)
            res = _join.materialize_program_stream(
                counts, a_streams, b_streams, ldat, lval, rdat, rval, jt,
                cap_e, a_desc=a_desc, b_desc=b_desc)
        # else: 64-bit hash collision — recompute via the exact plan route
    if res is None:
        counts2, lo, m, bperm, un_mask = _join.join_plan_keys(
            lkb_w, lkv_w, lemit_w, rkb_w, rkv_w, remit_w, jt)
        aemit = remit_w if jt == _join.JoinType.RIGHT else lemit_w
        cm = counts2.cpu().numpy()
        cap_p = _bucket_cap(int(cm[:, 0].max()))
        cap_u = _bucket_cap(int(cm[:, 1].max())) \
            if jt == _join.JoinType.FULL_OUTER else 0
        res = _join.materialize_program(lo, m, bperm, un_mask, aemit,
                                        ldat, lval, rdat, rval, jt, cap_p,
                                        cap_u)
    # flatten the [W, cap] outputs back to the sharded flat layout
    lod, lov, rod, rov = ([x.reshape(-1) for x in part] for part in res[:4])
    emit = res[4].reshape(-1)
    nl = left_d.column_count
    cols = _rebuild_columns(lod, lov, lcols_s,
                            [f"lt-{i}" for i in range(nl)])
    cols += _rebuild_columns(rod, rov, rcols_s,
                             [f"rt-{nl + j}"
                              for j in range(right_d.column_count)])
    result = Table(cols, ctx, emit)
    result._shard_world = world
    # co-partitioning witness: every emitted row sits on the shard its
    # join-key hash routed it to
    if jt in (_join.JoinType.INNER, _join.JoinType.LEFT):
        result._hash_partitioned = shard.partition_signature(
            lcols2, tuple(lidx), world)
    elif jt == _join.JoinType.RIGHT:
        result._hash_partitioned = shard.partition_signature(
            rcols2, tuple(nl + j for j in ridx), world)
    return result


# ---------------------------------------------------------------------------
# distributed set ops (reference: DistributedUnion/Subtract/Intersect,
# table.cpp:948-1010 — ShuffleTwoTables on ALL columns + local set op)
# ---------------------------------------------------------------------------


def distributed_set_op(left: Table, right: Table, op: _setops.SetOp,
                       force_exchange: bool = False) -> Table:
    """Both tables shuffle on all their columns, then every shard runs
    the dense-ranks set op (as the JAX package does: its per-shard set op
    has no kernel). ``force_exchange`` runs the full composition even on
    a one-shard world. The result stays sharded, in the JAX package's
    per-shard row order."""
    ctx = left._ctx
    world = ctx.get_world_size()
    if world == 1 and not (force_exchange and ctx.is_distributed()):
        # reference parity: world 1 short-circuits to the local set op
        return table_mod.set_op(left, right, op)
    if left.column_count != right.column_count:
        raise CylonError(Code.Invalid, "set ops need equal schemas")
    left_d = shard.distribute(left, ctx)
    right_d = shard.distribute(right, ctx)
    lcols, rcols = table_mod._aligned_setop_columns(left_d, right_d)
    has_validity = [a.validity is not None or b.validity is not None
                    for a, b in zip(lcols, rcols)]

    # exchange only the aligned columns; the row keys are recomputed per
    # shard from the shuffled columns. Both counts in one host fetch.
    sides = [(Table(list(cols), ctx, t.row_mask),
              _partition_targets_dist(world, cols), t.emit_mask())
             for cols, t in ((lcols, left_d), (rcols, right_d))]
    dense = (world == 1 and left_d.row_mask is None
             and right_d.row_mask is None)
    cl = cr = None
    if not dense:
        cl, cr = count_pair(sides[0][1], sides[0][2], sides[1][1],
                            sides[1][2], world)
    (lcols_s, lemit), (rcols_s, remit) = (
        _exchange_table(view, targets, emit, ctx, counts=cnt, dense=dense)
        for (view, targets, emit), cnt in zip(sides, (cl, cr)))

    def rebits(cols):
        # ordered bits (nulls at the all-ones end) plus the validity byte:
        # validity is part of the row key, so nulls compare equal
        bits = []
        for ci, c in enumerate(cols):
            bits.append(_order.sort_keys([c])[0])
            if has_validity[ci]:
                bits.append(c.valid_mask().to(torch.uint8))
        return _shards(bits, world)

    lemit_w, remit_w = lemit.view(world, -1), remit.view(world, -1)
    gl, gr = _order.dense_ranks_two(rebits(lcols_s), rebits(rcols_s))
    counts = torch.stack(list(_setops.setop_counts(
        gl, gr, lemit_w, remit_w).values()), 1).cpu().numpy()
    cap = _bucket_cap(int(counts[:, int(op)].max()))
    idx = _setops.setop_indices(gl, gr, lemit_w, remit_w, op, cap)
    # indices address the per-shard concatenation [left; right]
    dat = [torch.cat([a, b], 1) for a, b in zip(
        _shards((c.data for c in lcols_s), world),
        _shards((c.data for c in rcols_s), world))]
    val = [torch.cat([a, b], 1) for a, b in zip(
        _shards((c.valid_mask() for c in lcols_s), world),
        _shards((c.valid_mask() for c in rcols_s), world))]
    od, ov = _join.gather_columns(dat, val, idx)
    cols = _rebuild_columns([d.reshape(-1) for d in od],
                            [v.reshape(-1) for v in ov], lcols_s,
                            [c.name for c in lcols_s])
    result = Table(cols, ctx, (idx >= 0).reshape(-1))
    result._shard_world = world
    return result


# ---------------------------------------------------------------------------
# hash_partition / repartition (reference: HashPartition, table.cpp:102-160)
# ---------------------------------------------------------------------------


def hash_partition(table: Table, hash_columns: Sequence,
                   num_partitions: int) -> Dict[int, Table]:
    """Split a table into ``{partition: Table}`` by key hash: one stable
    sort by target (dead rows last), then each partition is one slice of
    every column, on the device. String columns are not ported."""
    idxs = [table._col_index(c) for c in hash_columns]
    if any(c.dtype.is_var_width() for c in table._columns):
        raise not_ported("string columns in hash_partition")
    ctx = table._ctx
    targets = _hash.partition_targets([table._columns[i] for i in idxs],
                                      num_partitions)
    tkey = torch.where(table.emit_mask(), targets, num_partitions)
    perm = torch.sort(tkey, stable=True).indices
    counts = torch.bincount(tkey.to(torch.int64),
                            minlength=num_partitions + 1).cpu().numpy()
    offs = np.concatenate([[0], np.cumsum(counts[:num_partitions])])
    cols = [Column(movable(c.data)[perm].view(c.data.dtype), c.dtype,
                   None if c.validity is None else c.validity[perm], c.name)
            for c in table._columns]
    out = {}
    for p in range(num_partitions):
        lo, hi = int(offs[p]), int(offs[p + 1])
        out[p] = Table([Column(c.data[lo:hi], c.dtype,
                               None if c.validity is None
                               else c.validity[lo:hi], c.name)
                        for c in cols], ctx)
    return out


def repartition(table: Table, ctx: CylonContext) -> Table:
    """Round-robin rows over the shards (no key): row i of the flat
    layout goes to shard i % world."""
    t = shard.distribute(table, ctx)
    world = ctx.get_world_size()
    targets = (torch.arange(t.capacity, device=ctx.device)
               % world).to(torch.int32)
    cols, new_emit = _exchange_table(t, targets, t.emit_mask(), ctx,
                                     dense=t.row_mask is None)
    result = Table(cols, ctx, new_emit)
    result._shard_world = world
    return result


# ---------------------------------------------------------------------------
# distributed groupby (reference: GroupBy, groupby/groupby.cpp:96-139):
# per-shard partial aggregates, their exchange by key hash, and a merge
# with the second-phase ops (COUNT partials summed, MEAN as SUM + COUNT)
# ---------------------------------------------------------------------------


def _shard_groupby(world: int, kbits, kdat, kval, emit, vdat, vval,
                   ops, col_ids, all_valid):
    """The per-shard group-by over ``[W, n]`` views, every shard in one
    batched call (the JAX package's ``_groupby_fn`` under ``shard_map``):
    group slots per shard = the shard capacity n. Returns flat
    ``[W * n]`` key data, key validity, group validity, aggregates."""
    n = emit.shape[0] // world
    keys = [b.view(world, n) for b in kbits] \
        + [v.view(world, n).to(torch.uint8) for v in kval]
    vdat_s, vval_s, emit_s, iota_s, gid_s, _ng = _groupby.presort_groups(
        keys, emit.view(world, n), [d.view(world, n) for d in vdat],
        [None if v is None else v.view(world, n) for v in vval])
    rep, gvalid, results = _groupby.sorted_segment_aggregate(
        gid_s, emit_s, iota_s, vdat_s, vval_s, n, ops, col_ids, all_valid)
    safe = torch.clamp(rep, max=n - 1)

    def take(x):
        return movable(x.view(world, n)).gather(1, safe).view(
            x.dtype).reshape(-1)

    kout = [take(d) for d in kdat]
    kvout = [take(v) & gvalid.reshape(-1) for v in kval]
    agg = [(arr.reshape(-1), (av & gvalid).reshape(-1))
           for arr, av in results]
    return kout, kvout, gvalid.reshape(-1), agg


def _groupby_shuffle_agg(ctx: CylonContext, key_columns, value_columns,
                         ops, emit, col_ids=None, dense: bool = False,
                         skip_exchange: bool = False):
    """Shuffle rows by key hash (unless ``skip_exchange``: the caller
    asserts each key's rows already sit on one shard), then aggregate per
    shard. Returns (key columns, [(agg, valid)], group validity)."""
    world = ctx.get_world_size()
    if skip_exchange:
        out_cols, emit_s = list(key_columns) + list(value_columns), emit
    else:
        view = Table(list(key_columns) + list(value_columns), ctx, None)
        targets = _partition_targets_dist(world, key_columns)
        out_cols, emit_s = _exchange_table(view, targets, emit, ctx,
                                           dense=dense)
    nk = len(key_columns)
    kcols_s, vcols_s = out_cols[:nk], out_cols[nk:]
    if col_ids is None:
        col_ids = tuple(range(len(vcols_s)))
    kout, kvout, gvalid, agg = _shard_groupby(
        world, _order.sort_keys(kcols_s), [c.data for c in kcols_s],
        [c.valid_mask() for c in kcols_s], emit_s,
        [c.data for c in vcols_s], [c.validity for c in vcols_s], ops,
        col_ids, [c.validity is None for c in vcols_s])
    key_out = [Column(d, kc.dtype, v, kc.name)
               for d, v, kc in zip(kout, kvout, kcols_s)]
    return key_out, agg, gvalid


def _groupby_table(ctx, key_out, cols, gvalid) -> Table:
    """The distributed groupby's result: sharded, its groups placed by
    key hash (the witness lets a later same-key stage skip its
    exchange)."""
    world = ctx.get_world_size()
    out = Table(list(key_out) + cols, ctx, gvalid)
    out._shard_world = world
    out._hash_partitioned = shard.partition_signature(
        key_out, tuple(range(len(key_out))), world)
    return out


def distributed_groupby(table: Table, index_col, aggregate_cols: List,
                        aggregate_ops: List[_groupby.AggregationOp],
                        pre_aggregate: bool = True,
                        pre_partitioned: bool = False) -> Table:
    """Phase A aggregates each shard's rows into partials (MEAN as a
    float64 SUM and a COUNT), phase B exchanges the partials by key hash
    and merges them with the second-phase ops. ``pre_aggregate=False``
    exchanges the rows and aggregates once; ``pre_partitioned=True``
    asserts the rows are already hash-placed by these keys and runs one
    per-shard pass with no exchange. A one-shard world runs the local
    groupby."""
    ctx = table._ctx
    world = ctx.get_world_size()
    if world == 1:
        return table_mod.groupby_local(table, index_col, aggregate_cols,
                                       aggregate_ops)
    t = shard.distribute(table, ctx)
    idx_cols = index_col if isinstance(index_col, (list, tuple)) \
        else [index_col]
    idx_cols = [t._col_index(c) for c in idx_cols]
    val_cols = [t._col_index(c) for c in aggregate_cols]
    key_columns = [t._columns[i] for i in idx_cols]
    if any(c.dtype.is_var_width() for c in t._columns):
        raise not_ported("string columns in groupby")
    ops = list(aggregate_ops)
    emit = t.emit_mask()
    MEAN = _groupby.AggregationOp.MEAN
    SUM = _groupby.AggregationOp.SUM
    COUNT = _groupby.AggregationOp.COUNT

    if pre_partitioned or not pre_aggregate:
        key_out, agg, gvalid = _groupby_shuffle_agg(
            ctx, key_columns, [t._columns[vi] for vi in val_cols],
            tuple(ops), emit, col_ids=tuple(val_cols),
            dense=t.row_mask is None, skip_exchange=pre_partitioned)
        cols = [Column(arr, table_mod._agg_dtype(t._columns[vi], op), av,
                       t._columns[vi].name)
                for (arr, av), vi, op in zip(agg, val_cols, ops)]
        return _groupby_table(ctx, key_out, cols, gvalid)

    # phase A: per-shard partials; MEAN expands to (f64 SUM, COUNT)
    a_entries = []   # (original position, phase-A op, cast to f64)
    b_ops = []
    out_map = []     # ("d", a index) or ("mean", sum index, count index)
    for j, op in enumerate(ops):
        if op == MEAN:
            out_map.append(("mean", len(a_entries), len(a_entries) + 1))
            a_entries += [(j, SUM, True), (j, COUNT, False)]
            b_ops += [SUM, SUM]
        else:
            out_map.append(("d", len(a_entries)))
            a_entries.append((j, op, False))
            b_ops.append(_groupby.second_phase_op(op))
    srcs = [t._columns[val_cols[j]] for j, _op, _c in a_entries]
    koutA, kvoutA, gvalidA, aggA = _shard_groupby(
        world, _order.sort_keys(key_columns),
        [c.data for c in key_columns], [c.valid_mask() for c in key_columns],
        emit,
        [src.data.to(torch.float64) if cast else src.data
         for src, (_j, _op, cast) in zip(srcs, a_entries)],
        [src.validity for src in srcs],
        tuple(op for _j, op, _c in a_entries),
        tuple((val_cols[j], cast) for j, _op, cast in a_entries),
        [src.validity is None for src in srcs])
    pkey_cols = [Column(d, kc.dtype, v, kc.name)
                 for d, v, kc in zip(koutA, kvoutA, key_columns)]
    pval_cols = [Column(arr, dtypes.Double() if cast
                        else table_mod._agg_dtype(src, opA), av, src.name)
                 for (arr, av), src, (_j, opA, cast)
                 in zip(aggA, srcs, a_entries)]

    # phase B: exchange the partials, merge with the second-phase ops
    key_out, aggB, gvalid = _groupby_shuffle_agg(
        ctx, pkey_cols, pval_cols, tuple(b_ops), gvalidA)
    cols = []
    for op, vi, m in zip(ops, val_cols, out_map):
        src = t._columns[vi]
        if m[0] == "mean":
            s_arr, s_av = aggB[m[1]]
            c_arr, c_av = aggB[m[2]]
            data = s_arr / torch.clamp(c_arr.to(torch.float64), min=1)
            cols.append(Column(data, table_mod._agg_dtype(src, op),
                               s_av & c_av & (c_arr > 0), src.name))
        else:
            arr, av = aggB[m[1]]
            cols.append(Column(arr, table_mod._agg_dtype(src, op), av,
                               src.name))
    return _groupby_table(ctx, key_out, cols, gvalid)


# ---------------------------------------------------------------------------
# distributed sort: sample the key lanes, agree range splitters, range-
# partition through the exchange the joins use, then sort each shard
# ---------------------------------------------------------------------------

# per-shard sample count for splitter estimation (total = world * this)
SORT_SAMPLES_PER_SHARD = 4096


def _range_splitters(world: int, lanes: Sequence[torch.Tensor],
                     emit: torch.Tensor) -> list:
    """world - 1 splitter tuples: the lexicographic quantiles of a
    sample of the live rows' key lanes, as unsigned numpy scalars. The
    sample positions come from the JAX package's generator and seed, so
    the splitters match its own on the same layout."""
    n = int(lanes[0].shape[0])
    rng = np.random.default_rng(0xC11)
    k = min(n, SORT_SAMPLES_PER_SHARD * world)
    pos = torch.from_numpy(np.sort(rng.integers(0, n, k))).to(emit.device)
    # one device->host copy: every lane's unsigned value as int64 (8-byte
    # lanes keep their bits), then the emit flag
    packed = torch.stack([l[pos].to(torch.int64)
                          if l.element_size() == 8
                          else _order.unsigned(l[pos]) for l in lanes]
                         + [emit[pos].to(torch.int64)]).cpu().numpy()
    live = packed[-1].astype(bool)
    samples = [packed[i].view(np.uint64)[live].astype(
        np.dtype(f"u{l.element_size()}")) for i, l in enumerate(lanes)]
    if samples[0].size == 0:
        return [tuple(s.dtype.type(0) for s in samples)] * (world - 1)
    order = np.lexsort(tuple(reversed(samples)))
    q = (np.arange(1, world) * samples[0].size) // world
    return [tuple(s[order[qi]] for s in samples) for qi in q]


def _sortable_scalar(v: np.generic) -> int:
    """An unsigned splitter value in `order.sortable`'s int64 space."""
    if v.dtype.itemsize == 8:
        return int(np.array(v).view(np.int64)) ^ _order._I64_MIN
    return int(v)


def _splitter_targets(lanes: Sequence[torch.Tensor],
                      splitters) -> torch.Tensor:
    """target = the number of splitter tuples lexicographically <= the
    row's key tuple. Lanes compare unsigned (`order.sortable`): the
    port's bits ride in signed containers, and a signed compare would
    send every key with the top bit set to the wrong shard."""
    keys = [_order.sortable(l) for l in lanes]
    n = keys[0].shape[0]
    targets = torch.zeros(n, dtype=torch.int32, device=keys[0].device)
    for tup in splitters:
        ge = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
        eq = torch.ones(n, dtype=torch.bool, device=keys[0].device)
        for key, sv in zip(keys, tup):
            v = _sortable_scalar(sv)
            ge |= eq & (key > v)
            eq &= key == v
        targets += (ge | eq).to(torch.int32)
    return targets


def _shard_sort(world: int, bits, emit, dat, val):
    """Each shard's rows stably sorted by (dead last, key lanes...), all
    shards in one batched sort: sorted data, validity and emit, flat."""
    n = emit.shape[0] // world
    emit_w = emit.view(world, n)
    perm = _order.lexsort_indices([(~emit_w).to(torch.uint8)]
                                  + [b.view(world, n) for b in bits])

    def take(x):
        return movable(x.view(world, n)).gather(1, perm).view(
            x.dtype).reshape(-1)

    return ([take(d) for d in dat], [take(v) for v in val],
            take(emit))


def distributed_sort(table: Table, order_by, ascending=True,
                     force_exchange: bool = False) -> Table:
    """Splitter-based distributed sort: sample the key lanes, agree
    world - 1 range splitters, range-partition through the exchange,
    then sort every shard. Shard i's rows all precede shard i+1's, so the
    global order is (shard, position); nulls last. ``force_exchange``
    runs the whole composition on a one-shard world too. (The JAX
    package memoizes the splitters per source column; the port samples
    on every call.)"""
    ctx = table._ctx
    t = shard.distribute(table, ctx) if ctx.is_distributed() else table
    by = order_by if isinstance(order_by, (list, tuple)) else [order_by]
    idxs = [t._col_index(c) for c in by]
    asc = list(ascending) if isinstance(ascending, (list, tuple)) \
        else [ascending] * len(idxs)
    world = ctx.get_world_size()
    if not (ctx.is_distributed() and (world > 1 or force_exchange)):
        return t.sort(by, ascending)
    order_cols = [t._columns[i] for i in idxs]
    if any(c.dtype.is_var_width() for c in t._columns):
        raise not_ported("string columns in distributed_sort")

    lanes = _order.sort_keys(order_cols, asc)
    emit = t.emit_mask()
    splitters = _range_splitters(world, lanes, emit)
    targets = _splitter_targets(lanes, splitters)
    cols_s, emit_s = _exchange_table(t, targets, emit, ctx,
                                     dense=t.row_mask is None)
    # key lanes recomputed from the shuffled columns: they never cross
    # the exchange
    sbits = _order.sort_keys([cols_s[i] for i in idxs], asc)
    sdat, sval, semit = _shard_sort(world, sbits, emit_s,
                                    [c.data for c in cols_s],
                                    [c.valid_mask() for c in cols_s])
    out = Table([Column(d, c.dtype, v, c.name)
                 for d, v, c in zip(sdat, sval, cols_s)], ctx, semit)
    out._shard_world = world
    return out
