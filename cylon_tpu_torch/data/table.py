"""Table — the user-facing columnar table (counterpart of
cylon_tpu.data.table).

Reference: cpp/src/cylon/table.hpp:43-387 and pycylon's table.pyx. A
Table is a list of Columns whose tensors live on the context's device.
A table of a distributed context keeps the JAX package's layout: one flat
``[W * cap]`` tensor per column, shard s holding rows ``[s*cap,
(s+1)*cap)``, padding rows masked dead by ``row_mask``. Per-shard kernels
view the columns as ``[W, cap]``; ``_shard_world`` records that the
layout is sharded (the counterpart of a NamedSharding).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes
from ..config import CSVWriteOptions
from ..context import CylonContext
from ..ops import aggregates as _aggregates
from ..ops import groupby as _groupby
from ..ops import join as _join
from ..ops import order as _order
from ..ops import setops as _setops
from ..status import Code, CylonError, not_ported
from ..util import capacity as _capacity
from ..util import pow2 as _pow2
from .column import Column


class Table:
    def __init__(self, columns: List[Column], ctx: CylonContext,
                 row_mask: Optional[torch.Tensor] = None):
        self._columns = columns
        self._ctx = ctx
        self._row_mask = row_mask  # bool [n] or None (all rows live)
        self._row_count_cache: Optional[int] = None
        # co-partitioning witness (key col idxs, key dtype sig, world)
        self._hash_partitioned = None
        # world of the sharded layout, or None for a plain local table
        self._shard_world: Optional[int] = None
        if columns:
            n = len(columns[0])
            for c in columns:
                if len(c) != n:
                    raise CylonError(Code.Invalid, "ragged columns")

    # -- properties --

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self._columns]

    @property
    def column_count(self) -> int:
        return len(self._columns)

    @property
    def row_mask(self):
        """Row-validity mask: bool [capacity] or None (all rows live)."""
        return self._row_mask

    @property
    def row_count(self) -> int:
        """Live row count (one host sync for a masked table, cached)."""
        if not self._columns:
            return 0
        if self._row_mask is None:
            return len(self._columns[0])
        if self._row_count_cache is None:
            self._row_count_cache = int(self._row_mask.sum())
        return self._row_count_cache

    def __len__(self) -> int:
        return self.row_count

    @property
    def capacity(self) -> int:
        """Physical (padded) row slots."""
        return len(self._columns[0]) if self._columns else 0

    def emit_mask(self) -> torch.Tensor:
        if self._row_mask is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self._ctx.device)
        return self._row_mask

    # -- constructors (pycylon table.pyx:556-624) --

    @staticmethod
    def from_pandas(ctx: CylonContext, df) -> "Table":
        cols = []
        for name in df.columns:
            s = df[name]
            validity = (~s.isna()).to_numpy() if s.isna().any() else None
            cols.append(Column.from_numpy(s.to_numpy(), str(name), validity,
                                          ctx.device))
        return Table(cols, ctx)

    @staticmethod
    def from_numpy(ctx: CylonContext, col_names: Sequence[str],
                   arrays: Sequence[np.ndarray]) -> "Table":
        if len(col_names) != len(arrays):
            raise CylonError(Code.Invalid, "names/arrays length mismatch")
        return Table([Column.from_numpy(np.asarray(a), n, None, ctx.device)
                      for n, a in zip(col_names, arrays)], ctx)

    @staticmethod
    def from_pydict(ctx: CylonContext, data: Dict[str, Sequence]) -> "Table":
        return Table.from_numpy(ctx, list(data.keys()),
                                [np.asarray(v) for v in data.values()])

    # -- exporters (table.pyx:626-693) --

    def compact(self) -> "Table":
        """Drop masked rows; returns a dense local table."""
        if self._row_mask is None:
            return self
        idx = torch.nonzero(self._row_mask).flatten()
        return Table([c.take(idx) for c in self._columns], self._ctx)

    def _unique_names(self) -> List[str]:
        seen: Dict[str, int] = {}
        used = set()
        out = []
        for c in self._columns:
            k = seen.get(c.name, 0) + 1
            name = c.name if k == 1 else f"{c.name}_{k}"
            while name in used:
                k += 1
                name = f"{c.name}_{k}"
            seen[c.name] = k
            used.add(name)
            out.append(name)
        return out

    def to_pydict(self) -> Dict[str, np.ndarray]:
        t = self.compact()
        return {n: c.to_numpy() for n, c in zip(t._unique_names(), t._columns)}

    def to_numpy(self, order: str = "F") -> np.ndarray:
        arrs = [c.to_numpy() for c in self.compact()._columns]
        return np.array(arrs).T.copy() if order == "F" else \
            np.ascontiguousarray(np.array(arrs).T)

    def to_pandas(self):
        import pandas as pd

        t = self.compact()
        df = pd.DataFrame({i: pd.Series(c.to_numpy())
                           for i, c in enumerate(t._columns)})
        df.columns = [c.name for c in t._columns]
        return df

    def to_csv(self, path: str, options: Optional[CSVWriteOptions] = None
               ) -> None:
        from ..io.csv import write_csv

        write_csv(self, path, options)

    # -- row selection --

    def take(self, indices) -> "Table":
        """Gather rows by logical index (live rows in order); -1 gives a
        null row. A masked table compacts first, so an index never
        addresses a filtered-out row."""
        t = self.compact()
        idx = torch.as_tensor(indices, device=self._ctx.device)
        return Table([c.take(idx) for c in t._columns], self._ctx)

    def sort(self, order_by, ascending=True) -> "Table":
        """Local sort (reference: Sort, util/arrow_utils.cpp:144-184):
        one stable lexsort of the key columns' ordered bits (per-key
        ``ascending``, nulls last), then a gather of every column."""
        t = self.compact()
        by = order_by if isinstance(order_by, (list, tuple)) else [order_by]
        cols_idx = [t._col_index(c) for c in by]
        asc = list(ascending) if isinstance(ascending, (list, tuple)) \
            else [ascending] * len(cols_idx)
        cols = [t._columns[i] for i in cols_idx]
        if any(c.dtype.is_var_width() for c in cols):
            raise not_ported("string sort keys")
        perm = _order.lexsort_indices(_order.sort_keys(cols, asc))
        return t.take(perm)

    def filter_mask(self, mask: torch.Tensor) -> "Table":
        """Filter by a bool mask: folds into ``row_mask`` (no gather)."""
        t = Table(list(self._columns), self._ctx, mask & self.emit_mask())
        t._shard_world = self._shard_world
        t._hash_partitioned = self._hash_partitioned
        return t

    def _col_index(self, c: Union[int, str]) -> int:
        if isinstance(c, (int, np.integer)):
            return int(c)
        try:
            return self.column_names.index(c)
        except ValueError:
            raise CylonError(Code.KeyError, f"no column named {c!r}")

    # -- joins --

    def join(self, table: "Table", join_type: str = "inner",
             algorithm: str = "auto", **kwargs) -> "Table":
        """Local join; self is the LEFT table (pycylon table.pyx:373-390).
        algorithm: "auto" (the fastest applicable route), "sort" or
        "hash" (reference join_config.hpp:25)."""
        if kwargs.pop("probe_block_rows", None):
            raise not_ported("the blocked local join (join_blocked)")
        return join(self, table, self._make_join_config(
            table, join_type, algorithm, kwargs))

    def distributed_join(self, table: "Table", join_type: str = "inner",
                         algorithm: str = "auto", **kwargs) -> "Table":
        """The shuffle join: both sides repartition by key hash through
        the counted padded exchange, then every shard joins locally.
        ``force_exchange`` runs the exchange even where it could be
        skipped (a one-shard world, co-partitioned inputs)."""
        from ..parallel import dist_ops

        comm = kwargs.pop("comm", "shuffle")
        force = bool(kwargs.pop("force_exchange", False))
        if comm != "shuffle":
            raise not_ported(f"the {comm!r} distributed join")
        cfg = self._make_join_config(table, join_type, algorithm, kwargs)
        return dist_ops.distributed_join(self, table, cfg,
                                         force_exchange=force)

    # -- set ops (pycylon table.pyx:411-457) --

    def union(self, table: "Table") -> "Table":
        return set_op(self, table, _setops.SetOp.UNION)

    def subtract(self, table: "Table") -> "Table":
        return set_op(self, table, _setops.SetOp.SUBTRACT)

    def intersect(self, table: "Table") -> "Table":
        return set_op(self, table, _setops.SetOp.INTERSECT)

    def distributed_union(self, table: "Table") -> "Table":
        from ..parallel import dist_ops

        return dist_ops.distributed_set_op(self, table, _setops.SetOp.UNION)

    def distributed_subtract(self, table: "Table") -> "Table":
        from ..parallel import dist_ops

        return dist_ops.distributed_set_op(self, table,
                                           _setops.SetOp.SUBTRACT)

    def distributed_intersect(self, table: "Table") -> "Table":
        from ..parallel import dist_ops

        return dist_ops.distributed_set_op(self, table,
                                           _setops.SetOp.INTERSECT)

    # -- aggregates (pycylon table.pyx:485-522) --

    def _agg(self, column, op: str) -> "Table":
        col = column if isinstance(column, Column) \
            else self._columns[self._col_index(column)]
        if self.row_mask is not None:
            col = Column(col.data, col.dtype,
                         col.valid_mask() & self.emit_mask(), col.name)
        # a distributed table's flat columns hold every shard: one
        # reduction spans them all
        value = _aggregates.agg_scalar(col, op)
        return Table.from_pydict(self._ctx, {col.name: [value]})

    def sum(self, column) -> "Table":
        return self._agg(column, "sum")

    def count(self, column) -> "Table":
        return self._agg(column, "count")

    def min(self, column) -> "Table":
        return self._agg(column, "min")

    def max(self, column) -> "Table":
        return self._agg(column, "max")

    def mean(self, column) -> "Table":
        return self._agg(column, "mean")

    # -- groupby (pycylon table.pyx:524-554) --

    def groupby(self, index_col, aggregate_cols: Sequence,
                aggregate_ops: Sequence) -> "Table":
        """Group by ``index_col`` (one column or a list) and aggregate
        ``aggregate_cols[i]`` with ``aggregate_ops[i]`` ("sum", "count",
        "min", "max", "mean" or an AggregationOp). A distributed context
        of world > 1 runs `distributed_groupby`."""
        ops = [_as_agg_op(o) for o in aggregate_ops]
        if self._ctx.is_distributed() and self._ctx.get_world_size() > 1:
            from ..parallel import dist_ops

            return dist_ops.distributed_groupby(self, index_col,
                                                list(aggregate_cols), ops)
        return groupby_local(self, index_col, list(aggregate_cols), ops)

    def _make_join_config(self, table: "Table", join_type, algorithm,
                          kwargs) -> _join.JoinConfig:
        exact = bool(kwargs.pop("exact", False))
        lidx, ridx = _resolve_join_columns(self, table, kwargs)
        if isinstance(join_type, _join.JoinType):
            jt = join_type
        else:
            jt = _JOIN_TYPES.get(join_type)
        if jt is None:
            raise CylonError(Code.Invalid, f"Unsupported join type {join_type}")
        alg = _JOIN_ALGOS.get(algorithm, _join.JoinAlgorithm.SORT) \
            if isinstance(algorithm, str) else algorithm
        return _join.JoinConfig(jt, lidx, ridx, alg, exact=exact)

    def __repr__(self) -> str:
        return f"Table({self.row_count}x{self.column_count} " \
               f"cols={self.column_names})"


_JOIN_TYPES = {
    "inner": _join.JoinType.INNER,
    "left": _join.JoinType.LEFT,
    "right": _join.JoinType.RIGHT,
    "outer": _join.JoinType.FULL_OUTER,
    "full_outer": _join.JoinType.FULL_OUTER,
}

_JOIN_ALGOS = {"sort": _join.JoinAlgorithm.SORT,
               "hash": _join.JoinAlgorithm.HASH,
               "auto": _join.JoinAlgorithm.AUTO}


def _as_agg_op(o) -> _groupby.AggregationOp:
    if isinstance(o, _groupby.AggregationOp):
        return o
    if isinstance(o, str):
        return _groupby.AggregationOp[o.upper()]
    return _groupby.AggregationOp(int(o))


def _agg_dtype(src: Column, op) -> dtypes.DataType:
    """The result type of ``op`` over ``src``: COUNT int64, MEAN double,
    the others the source's type."""
    if op == _groupby.AggregationOp.COUNT:
        return dtypes.Int64()
    if op == _groupby.AggregationOp.MEAN:
        return dtypes.Double()
    return src.dtype


def _resolve_join_columns(left: Table, right: Table, kwargs
                          ) -> Tuple[List[int], List[int]]:
    """pycylon's on=/left_on=/right_on= resolution (table.pyx:228-266)."""
    on = kwargs.get("on")
    left_on = kwargs.get("left_on")
    right_on = kwargs.get("right_on")
    if on is not None:
        names = on if isinstance(on, (list, tuple)) else [on]
        return ([left._col_index(c) for c in names],
                [right._col_index(c) for c in names])
    if left_on is not None and right_on is not None:
        lo = left_on if isinstance(left_on, (list, tuple)) else [left_on]
        ro = right_on if isinstance(right_on, (list, tuple)) else [right_on]
        return ([left._col_index(c) for c in lo],
                [right._col_index(c) for c in ro])
    raise CylonError(Code.Invalid,
                     "kwargs 'on' or 'left_on' and 'right_on' must be provided")


# ---------------------------------------------------------------------------
# key preparation
# ---------------------------------------------------------------------------


def align_key_columns(left: Table, right: Table, lidx: List[int],
                      ridx: List[int]) -> Tuple[List[Column], List[Column]]:
    """Promote dtypes so both sides' key columns compare on device."""
    lcols, rcols = [], []
    for li, ri in zip(lidx, ridx):
        a, b = left._columns[li], right._columns[ri]
        if a.data.dtype != b.data.dtype:
            common = dtypes.from_np_dtype(dtypes.numpy_dtype(
                torch.promote_types(a.data.dtype, b.data.dtype)))
            a, b = a.astype(common), b.astype(common)
        lcols.append(a)
        rcols.append(b)
    return lcols, rcols


def _aligned_setop_columns(left: Table, right: Table):
    """Schema-aligned column pairs for set ops: dtypes promoted. String
    columns (dictionaries to unify in the JAX package) are not ported."""
    if left.column_count != right.column_count:
        raise CylonError(Code.Invalid, "set ops need equal schemas")
    for c in left._columns + right._columns:
        if c.dtype.is_var_width():
            raise not_ported("string columns in set ops")
    idx = list(range(left.column_count))
    return align_key_columns(left, right, idx, idx)


def row_gids(left: Table, right: Table) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared dense FULL-ROW ids for set ops; nulls compare equal (validity
    is part of the key, matching set-distinct semantics)."""
    lcols, rcols = _aligned_setop_columns(left, right)
    keys_l, keys_r = [], []
    for a, b in zip(lcols, rcols):
        keys_l.append(_order.sort_keys([a])[0])
        keys_r.append(_order.sort_keys([b])[0])
        if a.validity is not None or b.validity is not None:
            keys_l.append(a.valid_mask().to(torch.uint8))
            keys_r.append(b.valid_mask().to(torch.uint8))
    return _order.dense_ranks_two(keys_l, keys_r)


def _all_valid(cols: Sequence[Column]) -> torch.Tensor:
    v = cols[0].valid_mask()
    for c in cols[1:]:
        v = v & c.valid_mask()
    return v


def _row(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A 1-D local tensor as a one-shard [1, n] batch."""
    return None if x is None else x.unsqueeze(0)


def _rows(xs) -> tuple:
    return tuple(_row(x) for x in xs)


# ---------------------------------------------------------------------------
# the local join (reference: cylon::Join, table.cpp:640-654)
# ---------------------------------------------------------------------------


def join(left: Table, right: Table, config: _join.JoinConfig) -> Table:
    """Local join: two phases (plan, then materialize) with only the
    output counts crossing to the host; the result keeps a static
    capacity with padding rows masked by ``row_mask``."""
    if config.exact:
        raise not_ported("exact=True joins (varbytes keys)")
    lcols, rcols = align_key_columns(left, right, config.left_column_idx,
                                     config.right_column_idx)
    lbits, lkv = _join.key_bits(_rows(c.data for c in lcols),
                                _rows(c.validity for c in lcols))
    rbits, rkv = _join.key_bits(_rows(c.data for c in rcols),
                                _rows(c.validity for c in rcols))
    lemit, remit = _row(left.row_mask), _row(right.row_mask)
    ldat = _rows(c.data for c in left._columns)
    lval = _rows(c.validity for c in left._columns)
    rdat = _rows(c.data for c in right._columns)
    rval = _rows(c.validity for c in right._columns)

    # route: the sort-stream path for one 4-byte key, the hash-stream
    # path (JoinAlgorithm.HASH) for multi-column/wide keys, FULL_OUTER as
    # LEFT plus the unmatched-build tail; the plan route is the general
    # fallback (forced off, hash collisions, other shapes)
    alg = config.algorithm
    jt = config.type
    if jt == _join.JoinType.FULL_OUTER and (
            _join.stream_plan_applicable(lbits, rbits, _join.JoinType.LEFT)
            or _join.hash_stream_applicable(lbits, rbits,
                                            _join.JoinType.LEFT)):
        sub = _join.JoinConfig(_join.JoinType.LEFT, config.left_column_idx,
                               config.right_column_idx, alg)
        out = join(left, right, sub)
        return _append_unmatched_right(left, right, out, (lcols, rcols))
    use_stream = (alg != _join.JoinAlgorithm.HASH
                  and _join.stream_plan_applicable(lbits, rbits, jt))
    use_hash = (not use_stream
                and alg in (_join.JoinAlgorithm.HASH,
                            _join.JoinAlgorithm.AUTO)
                and _join.hash_stream_applicable(lbits, rbits, jt))

    res = None
    if use_stream or use_hash:
        a_desc, b_desc = _join.plan_lane_descs(ldat, lval, rdat, rval, jt)
        counts, a_streams, b_streams = _join.plan_program_stream(
            lbits, lkv, lemit, rbits, rkv, remit, ldat, lval, rdat, rval,
            jt, a_desc=a_desc, b_desc=b_desc, hash_mode=use_hash)
        host = counts[0].tolist()
        if not (use_hash and host[3] > 0):
            if host[0] < 0:
                raise CylonError(Code.ExecutionError,
                                 "join output exceeds 2^31 rows per shard; "
                                 "repartition over more shards")
            br = _join.stream_block_rows(left.capacity, right.capacity)
            cap_e = _join.stream_expand_capacity(host[0], br)
            res = _join.materialize_program_stream(
                counts, a_streams, b_streams, ldat, lval, rdat, rval, jt,
                cap_e, a_desc=a_desc, b_desc=b_desc)
        # else: a 64-bit hash collision: the exact plan route redoes it
    if res is None:
        counts2, lo, m, bperm, un_mask = _join.join_plan_keys(
            lbits, lkv, _join._vm(lemit, lkv), rbits, rkv,
            _join._vm(remit, rkv), jt)
        n_primary, n_un = counts2[0].tolist()
        cap_p = _capacity(n_primary)
        cap_u = _capacity(n_un) if jt == _join.JoinType.FULL_OUTER else 0
        aemit = remit if jt == _join.JoinType.RIGHT else lemit
        res = _join.materialize_program(
            lo, m, bperm, un_mask, aemit, ldat, lval, rdat, rval, jt,
            cap_p, cap_u)
    # drop the one-shard batch dimension
    lod, lov, rod, rov = ([x[0] for x in part] for part in res[:4])
    emit = res[4][0]
    nl = left.column_count
    cols = [Column(d, c.dtype, v, f"lt-{i}")
            for i, (d, v, c) in enumerate(zip(lod, lov, left._columns))]
    cols += [Column(d, c.dtype, v, f"rt-{nl + j}")
             for j, (d, v, c) in enumerate(zip(rod, rov, right._columns))]
    return Table(cols, left._ctx, emit)


def _append_unmatched_right(left: Table, right: Table, out: Table,
                            aligned) -> Table:
    """FULL_OUTER = LEFT output + the right rows whose key matches no
    live left row (null keys never match), appended as one tail."""
    lcols, rcols = aligned
    lv = _all_valid(lcols) & left.emit_mask()
    rv = _all_valid(rcols) & right.emit_mask()
    gl, gr = _order.dense_ranks_two(
        [_order.ordered_bits(c) for c in lcols],
        [_order.ordered_bits(c) for c in rcols])
    in_l = torch.isin(torch.where(rv, gr, -2), torch.where(lv, gl, -1))
    un = right.emit_mask() & torch.where(rv, ~in_l, True)
    r_unmatched = right.filter_mask(un).compact()
    ncap = r_unmatched.capacity
    dev = left._ctx.device
    tail_cols = [Column(torch.zeros(ncap, dtype=c.data.dtype, device=dev),
                        c.dtype, torch.zeros(ncap, dtype=torch.bool,
                                             device=dev), c.name)
                 for c in left._columns] + list(r_unmatched._columns)
    tail = Table([c.rename(nm) for c, nm in
                  zip(tail_cols, out.column_names)], left._ctx,
                 r_unmatched.emit_mask())
    return concat_tables([out, tail], left._ctx)


# ---------------------------------------------------------------------------
# local groupby (reference: LocalHashGroupBy, groupby_hash.hpp:321-359)
# ---------------------------------------------------------------------------


def groupby_local(table: Table, index_col, aggregate_cols: List,
                  aggregate_ops: List) -> Table:
    """Sort the rows into groups (one lexsort by dead flag and key bits,
    a key's validity a key of its own), fetch the group count (the op's
    one host sync), then one segment reduction per distinct (column, op).
    The output holds ``pow2(groups)`` rows in key order, its padding dead
    in ``row_mask``."""
    idx_cols = index_col if isinstance(index_col, (list, tuple)) \
        else [index_col]
    idx_cols = [table._col_index(c) for c in idx_cols]
    val_cols = [table._col_index(c) for c in aggregate_cols]
    ops = list(aggregate_ops)
    key_columns = [table._columns[i] for i in idx_cols]
    if any(c.dtype.is_var_width() for c in key_columns
           + [table._columns[i] for i in val_cols]):
        raise not_ported("string columns in groupby")
    keys = []
    for c in key_columns:
        keys.extend(_order.sort_keys([c]))
        if c.validity is not None:
            keys.append(c.valid_mask().to(torch.uint8))
    values = [table._columns[i].data for i in val_cols]
    valids = [table._columns[i].validity for i in val_cols]
    values_s, valids_s, emit_s, iota_s, gid_s, ng = \
        _groupby.presort_groups(keys, table.emit_mask(), values, valids)
    num_groups = max(int(ng[0]), 1)
    cap = _pow2(num_groups)
    rep, group_valid, results = _groupby.sorted_segment_aggregate(
        gid_s, emit_s, iota_s, values_s, valids_s, cap, ops, val_cols,
        [table._columns[i].validity is None for i in val_cols])
    rep, group_valid = rep[0], group_valid[0]
    safe = torch.clamp(rep, max=max(table.capacity - 1, 0))
    out_cols = []
    for i in idx_cols:
        g = table._columns[i].take(safe)
        validity = None if table._columns[i].validity is None \
            else g.validity & group_valid
        out_cols.append(Column(g.data, g.dtype, validity, g.name))
    for (arr, avalid), vi, op in zip(results, val_cols, ops):
        src = table._columns[vi]
        out_cols.append(Column(arr[0], _agg_dtype(src, op),
                               avalid[0] & group_valid, src.name))
    return Table(out_cols, table._ctx, group_valid)


# ---------------------------------------------------------------------------
# local set ops (reference: table.cpp:729-942)
# ---------------------------------------------------------------------------


def set_op(left: Table, right: Table, op) -> Table:
    """Local union/subtract/intersect. The stream route (one sort on a
    full-row hash, then K5/K6) takes lane-packable schemas; the
    dense-ranks route is the general and the hash-collision fallback."""
    lcols, rcols = _aligned_setop_columns(left, right)
    out = _setops.setop_stream_table(left, right, lcols, rcols, op)
    if out is not None:
        return out
    gl, gr = row_gids(left, right)
    rows = _setops.setop_rows(gl, gr, left.emit_mask(), right.emit_mask(),
                              op)
    out_cols = []
    for a, b in zip(lcols, rcols):
        validity = None
        if a.validity is not None or b.validity is not None:
            validity = torch.cat([a.valid_mask(), b.valid_mask()])
        merged = Column(torch.cat([a.data, b.data]), a.dtype, validity,
                        a.name)
        out_cols.append(merged.take(rows))
    return Table(out_cols, left._ctx)


def concat_tables(tables: Sequence[Table], ctx: CylonContext) -> Table:
    """Reference: Merge (table.cpp:388-427) — schema-aligned concat."""
    first = tables[0]
    out_cols = []
    for ci in range(first.column_count):
        cs = [t._columns[ci] for t in tables]
        data = torch.cat([c.data for c in cs])
        has_null = any(c.validity is not None for c in cs)
        validity = torch.cat([c.valid_mask() for c in cs]) if has_null \
            else None
        out_cols.append(Column(data, cs[0].dtype, validity, cs[0].name))
    mask = None
    if any(t.row_mask is not None for t in tables):
        mask = torch.cat([t.emit_mask() for t in tables])
    return Table(out_cols, ctx, mask)
