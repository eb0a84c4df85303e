"""Table — the user-facing columnar table (counterpart of
cylon_tpu.data.table).

Reference: cpp/src/cylon/table.hpp:43-387 and pycylon's table.pyx. A
Table is a list of Columns whose tensors live on the context's device.
A table of a distributed context keeps the JAX package's layout: one flat
``[W * cap]`` tensor per column, shard s holding rows ``[s*cap,
(s+1)*cap)``, padding rows masked dead by ``row_mask``. Per-shard kernels
view the columns as ``[W, cap]``; ``_shard_world`` records that the
layout is sharded (the counterpart of a NamedSharding). In a context of
several processes (config.MultiHostConfig) a sharded table's tensors
hold this process's V shards only, ``[V * cap]``: its ``row_count`` is
the global count, agreed by the processes, and the local ops and the
exports, which would see one process's rows as the whole table, raise
(as the JAX package's do for an array spanning other processes'
devices); ``to_pydict_local`` hands out this process's rows.

String columns (dictionary or varbytes, data/column.py) go through every
op: keys expand to dictionary codes, raw word lanes (short varbytes rows,
byte-exact) or the 96-bit content hash (long rows); short varbytes
payload rides the join as word lanes and comes out strided.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes
from ..config import CSVWriteOptions
from ..context import CylonContext
from ..ops import aggregates as _aggregates
from ..ops import groupby as _groupby
from ..ops import join as _join
from ..ops import kernels as _kernels
from ..ops import order as _order
from ..ops import setops as _setops
from ..status import Code, CylonError
from ..telemetry import ledger as _ledger
from ..telemetry import metrics as _metrics
from ..telemetry import phase as _phase
from ..telemetry import record_host_sync as _host_sync
from ..util import capacity as _capacity
from ..util import pow2 as _pow2
from .column import (Column, align_string_columns, as_varbytes,
                     remap_dictionary, string_key_arrays)
from .strings import (EXACT_KEY_WORDS, LANE_WORDS_MAX, VarBytes,
                      concat_varbytes, pair_k_words)


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
    def context(self) -> CylonContext:
        return self._ctx

    @property
    def column_names(self) -> List[str]:
        return [c.name for c in self._columns]

    @property
    def column_count(self) -> int:
        return len(self._columns)

    def columns(self) -> List[Column]:
        return self._columns

    def get_column(self, i: int) -> Column:
        return self._columns[i]

    @property
    def row_mask(self):
        """Row-validity mask: bool [capacity] or None (all rows live)."""
        return self._row_mask

    @property
    def row_count(self) -> int:
        """Live row count (one host sync for a masked table, cached). A
        table spread over several processes counts every process's rows
        (one all-reduce: every process must ask)."""
        if not self._columns:
            return 0
        spread = self._spread()
        if self._row_mask is None and not spread:
            return len(self._columns[0])
        if self._row_count_cache is None:
            n = len(self._columns[0]) if self._row_mask is None \
                else int(self._row_mask.sum())
            if spread:
                n = int(self._ctx.comm.all_reduce(np.array([n]), "sum")[0])
            self._row_count_cache = n
        return self._row_count_cache

    def _spread(self) -> bool:
        """A sharded table of a context of several processes: its tensors
        hold this process's shards only."""
        return self._shard_world is not None and self._ctx.is_multiprocess()

    def _require_whole(self, what: str) -> None:
        """Raise where an op or an export would take this process's rows
        for the whole table."""
        if self._spread():
            raise CylonError(
                Code.Invalid,
                f"{what} of a table spread over "
                f"{self._ctx.get_process_count()} processes would see only "
                f"this process's rows: use the distributed ops, or "
                f"to_pydict_local() for this process's rows")

    def rows(self) -> int:
        """Reference: Table::Rows (table.hpp:134)."""
        return self.row_count

    def __len__(self) -> int:
        return self.row_count

    @property
    def capacity(self) -> int:
        """Physical (padded) row slots."""
        return len(self._columns[0]) if self._columns else 0

    def buffers(self) -> List[torch.Tensor]:
        """Every device tensor this table references (row mask, data,
        validity, varbytes words and starts): the enumeration behind
        ``nbytes`` and the telemetry ledger's identity set, so zero-copy
        views (project and filter outputs share their input's columns)
        do not count their buffers twice."""
        out = [] if self._row_mask is None else [self._row_mask]
        for c in self._columns:
            out.append(c.data)
            if c.validity is not None:
                out.append(c.validity)
            if c.is_varbytes:
                out.append(c.varbytes.words)
                out.append(c.varbytes.starts)
        return out

    @property
    def nbytes(self) -> int:
        """Device bytes this table's buffers span: shape x itemsize on
        the host, no device sync."""
        return sum(int(a.element_size()) * int(a.numel())
                   for a in self.buffers())

    def clear(self) -> None:
        """Drop the columns and retire the table's ledger entry.
        Idempotent: a second call is a no-op, never a second ledger
        event."""
        if getattr(self, "_cleared", False):
            return
        self._cleared = True
        _ledger.release(self)
        self._columns = []
        self._row_mask = None
        self._row_count_cache = None

    def retain_memory(self, retain: bool = True) -> None:
        """Reference: Table::retainMemory (table.hpp:178). With
        ``retain=False`` the next distributed operator that consumes this
        table (shuffle, the shuffle, ring and broadcast joins) clears it
        after use (reference: Shuffle frees non-retained inputs,
        table.cpp:207), so its device memory returns to the allocator as
        soon as nothing else holds it."""
        self._retain = bool(retain)

    def is_retain(self) -> bool:
        """Reference: Table::IsRetain (table.hpp:183)."""
        return getattr(self, "_retain", True)

    def _free_if_unretained(self) -> None:
        if not self.is_retain():
            self.clear()

    def finalize(self) -> None:
        self.clear()

    def emit_mask(self) -> torch.Tensor:
        if self._row_mask is None:
            return torch.ones(self.capacity, dtype=torch.bool,
                              device=self._ctx.device)
        return self._row_mask

    # -- constructors (pycylon table.pyx:556-624) --

    @staticmethod
    def from_arrow(ctx: CylonContext, pa_table) -> "Table":
        return Table([Column.from_pyarrow(pa_table.column(i),
                                          pa_table.column_names[i],
                                          ctx.device)
                      for i in range(pa_table.num_columns)], ctx)

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

    @staticmethod
    def from_list(ctx: CylonContext, col_names: Sequence[str],
                  data: Sequence[Sequence]) -> "Table":
        return Table.from_numpy(ctx, col_names, [np.asarray(v) for v in data])

    # -- exporters (table.pyx:626-693) --

    def compact(self) -> "Table":
        """Drop masked rows; returns a dense local table."""
        self._require_whole("compact")
        return self._compact_rows()

    def _compact_rows(self) -> "Table":
        """The live rows this process holds, as a dense local table."""
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

    def to_pydict_local(self) -> Dict[str, np.ndarray]:
        """This process's shards' live rows as host numpy, in shard order
        (every row in the virtual world): the per-process handoff out of
        a distributed table, e.g. to feed each process's training loop
        (parallel/shard.extract_process_local)."""
        from ..parallel import shard as _shard

        return _shard.extract_process_local(self, self._ctx)

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

    def to_arrow(self):
        import pyarrow as pa

        t = self.compact()
        return pa.table([c.to_pyarrow() for c in t._columns],
                        names=[c.name for c in t._columns])

    def to_csv(self, path: str, options: Optional[CSVWriteOptions] = None
               ) -> None:
        from ..io.csv import write_csv

        write_csv(self, path, options)

    def to_parquet(self, path: str) -> None:
        from ..io.parquet import write_parquet

        write_parquet(self, path)

    # -- row selection and projection --

    def take(self, indices) -> "Table":
        """Gather rows by logical index (live rows in order); -1 gives a
        null row. A masked table compacts first, so an index never
        addresses a filtered-out row."""
        t = self.compact()
        idx = torch.as_tensor(indices, device=self._ctx.device)
        return Table([c.take(idx) for c in t._columns], self._ctx)

    def project(self, columns: Sequence[Union[int, str]]) -> "Table":
        """Zero-copy column subset (reference: Project,
        table.cpp:1066-1085). The hash-placement witness survives, its
        positions remapped, when every witnessed key column is kept."""
        idxs = [self._col_index(c) for c in columns]
        t = Table([self._columns[i] for i in idxs], self._ctx,
                  self._row_mask)
        t._shard_world = self._shard_world
        hp = self._hash_partitioned
        if hp is not None and all(k in idxs for k in hp[0]):
            t._hash_partitioned = (tuple(idxs.index(k) for k in hp[0]),
                                   ) + tuple(hp[1:])
        return t

    def select(self, predicate) -> "Table":
        """Row-lambda filter (reference: Select, table.cpp:698-727, a host
        row loop there too; a mask filter is the fast path)."""
        from .row import Row

        t = self.compact()
        data = [c.to_numpy() for c in t._columns]
        n = len(data[0]) if data else 0
        mask = np.zeros(n, dtype=bool)
        for i in range(n):
            mask[i] = bool(predicate(Row(t, i, _cache=data)))
        return t.filter_mask(torch.from_numpy(mask).to(self._ctx.device))

    def filter_mask(self, mask: torch.Tensor) -> "Table":
        """Filter by a bool mask: folds into ``row_mask`` (no gather)."""
        t = Table(list(self._columns), self._ctx, mask & self.emit_mask())
        t._shard_world = self._shard_world
        t._hash_partitioned = self._hash_partitioned
        return t

    def slice(self, start: int, stop: int) -> "Table":
        t = self.compact()
        return Table([c.slice(start, stop) for c in t._columns], self._ctx)

    def _col_index(self, c: Union[int, str]) -> int:
        if isinstance(c, (int, np.integer)):
            return int(c)
        try:
            return self.column_names.index(c)
        except ValueError:
            raise CylonError(Code.KeyError, f"no column named {c!r}")

    # -- sort / merge --

    def sort(self, order_by, ascending=True) -> "Table":
        """Local sort (reference: Sort, util/arrow_utils.cpp:144-184):
        one stable lexsort of the key columns' ordered bits (per-key
        ``ascending``, nulls last), then a gather of every column. Varbytes
        keys sort on big-endian prefix words and the length; rows past
        SORT_PREFIX_WORDS words take the host sort."""
        t = self.compact()
        by = order_by if isinstance(order_by, (list, tuple)) else [order_by]
        cols = [t._columns[t._col_index(c)] for c in by]
        asc = list(ascending) if isinstance(ascending, (list, tuple)) \
            else [ascending] * len(cols)
        keys = _sort_keys_mixed(cols, asc)
        if keys is None:
            return t.take(_host_sort_perm(cols, asc, self._ctx.device))
        return t.take(_order.lexsort_indices(keys))

    def merge(self, other_or_list) -> "Table":
        """Concatenate tables (reference: Merge, table.hpp:250)."""
        others = other_or_list if isinstance(other_or_list, (list, tuple)) \
            else [other_or_list]
        return concat_tables([self.compact()] + [o.compact() for o in others],
                             self._ctx)

    # -- joins --

    def join(self, table: "Table", join_type: str = "inner",
             algorithm: str = "auto", **kwargs) -> "Table":
        """Local join; self is the LEFT table (pycylon table.pyx:373-390).
        algorithm: "auto" (the fastest applicable route), "sort" or
        "hash" (reference join_config.hpp:25). ``probe_block_rows`` runs
        the blocked join (``join_blocked``)."""
        blk = kwargs.pop("probe_block_rows", None)
        cfg = self._make_join_config(table, join_type, algorithm, kwargs)
        return join(self, table, cfg, probe_block_rows=blk)

    def distributed_join(self, table: "Table", join_type: str = "inner",
                         algorithm: str = "auto", **kwargs) -> "Table":
        """comm="shuffle" (default): both sides repartition by key hash
        through the counted padded exchange, then every shard joins
        locally (``force_exchange`` runs the exchange even where it could
        be skipped: a one-shard world, co-partitioned inputs);
        comm="ring" streams the build side around the ring of shards;
        comm="broadcast" replicates ``build_side`` (0 = left, 1 = right,
        the default) to every shard and probes locally, with no
        exchange."""
        from ..parallel import dist_ops

        comm = kwargs.pop("comm", "shuffle")
        build_side = kwargs.pop("build_side", 1)
        force = bool(kwargs.pop("force_exchange", False))
        cfg = self._make_join_config(table, join_type, algorithm, kwargs)
        if comm == "ring":
            return dist_ops.distributed_join_ring(self, table, cfg)
        if comm == "broadcast":
            return dist_ops.broadcast_hash_join(self, table, cfg,
                                                build_side=int(build_side))
        if comm != "shuffle":
            raise CylonError(Code.Invalid,
                             f"unknown comm mode {comm!r} "
                             "(expected 'shuffle', 'ring' or "
                             "'broadcast')")
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
        """One scalar aggregate as a one-row table. A distributed table's
        flat columns hold every shard of this process: one reduction
        spans them all. A table spread over several processes reduces
        each process's rows and combines the partials, in rank order, in
        every process (every process must ask; each gets the same
        table)."""
        col = column if isinstance(column, Column) \
            else self._columns[self._col_index(column)]
        if self.row_mask is not None:
            col = col.with_validity(col.valid_mask() & self.emit_mask())
        from ..parallel import comm as _comm

        # a table that is not spread is whole in this process: a comm of
        # one process gathers only its own partial
        cm = self._ctx.comm if self._spread() else _comm.VirtualComm(1)
        value = _aggregates.agg_scalar(
            col, op, lambda a: _comm.all_gather_rows(cm, a),
            lambda items: _comm.all_gather_bytes(cm, items))
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

    # -- pandas-style sugar (pycylon table.pyx:749-798) --

    def __getitem__(self, key):
        if isinstance(key, Table):  # a one-column bool mask table
            if key.column_count != 1:
                raise CylonError(Code.Invalid,
                                 "mask table must have one column")
            return self.filter_mask(key._columns[0].data.to(torch.bool)
                                    & key.emit_mask())
        if isinstance(key, slice):
            return self.slice(key.start or 0, key.stop if key.stop is not None
                              else self.row_count)
        if isinstance(key, int):
            return self.slice(key, key + 1)
        if isinstance(key, str):
            return self.project([key])
        if isinstance(key, (list, tuple)):
            return self.project(list(key))
        raise CylonError(Code.Invalid, f"unsupported key {key!r}")

    def _compare(self, other, op: str) -> "Table":
        """Elementwise compare of every column with a scalar: a table of
        bool columns keeping this table's capacity and row mask (so
        ``t[t["c"] > x]`` lines up). Strings compare equal/unequal with a
        str; a dictionary column has no ordering against a str."""
        out_cols = []
        for c in self._columns:
            if c.is_string:
                if not isinstance(other, (str, bytes)):
                    raise CylonError(Code.TypeError, "string col vs non-str")
                if op not in ("eq", "ne"):
                    raise CylonError(Code.TypeError,
                                     "ordering vs str is not supported")
                if c.is_varbytes:
                    res = c.varbytes.equals_literal(other)
                else:
                    code = int(np.searchsorted(c.dictionary, other))
                    hit = code < len(c.dictionary) \
                        and c.dictionary[code] == other
                    res = c.data == code if hit else torch.zeros(
                        len(c), dtype=torch.bool, device=c.data.device)
                if op == "ne":
                    res = ~res
            else:
                res = _CMP[op](c.data, other)
            out_cols.append(Column(res & c.valid_mask(), dtypes.Bool(), None,
                                   c.name))
        t = Table(out_cols, self._ctx, self._row_mask)
        t._shard_world = self._shard_world
        return t

    def __eq__(self, other):  # type: ignore[override]
        if isinstance(other, Table):
            return NotImplemented
        return self._compare(other, "eq")

    def __ne__(self, other):  # type: ignore[override]
        if isinstance(other, Table):
            return NotImplemented
        return self._compare(other, "ne")

    def __lt__(self, other):
        return self._compare(other, "lt")

    def __gt__(self, other):
        return self._compare(other, "gt")

    def __le__(self, other):
        return self._compare(other, "le")

    def __ge__(self, other):
        return self._compare(other, "ge")

    def __hash__(self):
        return id(self)

    def _bool_binop(self, other: "Table", fn) -> "Table":
        cols = [Column(fn(a.data.to(torch.bool), b.data.to(torch.bool)),
                       dtypes.Bool(), None, a.name)
                for a, b in zip(self._columns, other._columns)]
        return Table(cols, self._ctx, self._row_mask)

    def __and__(self, other: "Table") -> "Table":
        return self._bool_binop(other, torch.logical_and)

    def __or__(self, other: "Table") -> "Table":
        return self._bool_binop(other, torch.logical_or)

    def __invert__(self) -> "Table":
        return Table([Column(~c.data.to(torch.bool), dtypes.Bool(), None,
                             c.name) for c in self._columns], self._ctx)

    def __repr__(self) -> str:
        return f"Table({self.row_count}x{self.column_count} " \
               f"cols={self.column_names})"

    def show(self, row1: int = 0, row2: int = -1, col1: int = 0,
             col2: int = -1) -> None:
        """Print rows [row1, row2) of columns [col1, col2) (-1: to the
        end), one tab-separated line a row after the header (pycylon
        table.pyx show/show_by_range; numpy only, no pandas)."""
        data = self.to_pydict()
        names = list(data)[col1:None if col2 == -1 else col2]
        n = len(next(iter(data.values()))) if data else 0
        print("\t".join(names))
        for i in range(row1, n if row2 == -1 else min(row2, n)):
            print("\t".join(str(data[k][i]) for k in names))


_CMP = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "ge": lambda a, b: a >= b,
}

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
# sort keys
# ---------------------------------------------------------------------------


def _sort_keys_mixed(cols: Sequence[Column], asc: Sequence[bool]):
    """Sort keys (compared unsigned) for plain, dictionary and varbytes
    columns, or None when a varbytes column holds rows past the device
    prefix bound (the caller takes the host sort)."""
    keys = []
    for c, a in zip(cols, asc):
        if not c.is_varbytes:
            keys.extend(_order.sort_keys([c], [a]))
            continue
        if not c.varbytes.sortable_on_device:
            return None
        ks = c.varbytes.sort_prefix_keys()
        if not a:
            ks = [~k for k in ks]
        if c.validity is not None:  # nulls last: all ones on every key
            ks = [torch.where(c.validity, k, -1) for k in ks]
        keys.extend(ks)
    return keys


def _host_rank_codes(c: Column, ascending: bool) -> np.ndarray:
    """A column's stable sort rank on the host: equal values share a
    code, nulls last in either direction (pandas' sort_values order)."""
    return rank_codes(c.to_numpy(), ascending)


def rank_codes(vals: np.ndarray, ascending: bool) -> np.ndarray:
    """`_host_rank_codes` of a column's host values (``Column.to_numpy``:
    nulls None, or NaN in a float column)."""
    if vals.dtype != object:
        null = np.isnan(vals) if vals.dtype.kind == "f" \
            else np.zeros(len(vals), bool)
    else:
        null = np.array([v is None or (isinstance(v, float) and v != v)
                         for v in vals], dtype=bool)
    codes = np.empty(len(vals), np.int64)
    live = vals[~null]
    if vals.dtype == object:
        # np.unique(return_inverse) of objects, by a dict of the distinct
        # values (one sort of those, not of every row)
        uniq = _sorted_distinct(live)
        code = {v: i for i, v in enumerate(uniq.tolist())}
        inv = np.fromiter((code[v] for v in live.tolist()), np.int64,
                          len(live))
    else:
        uniq, inv = np.unique(live, return_inverse=True)
    inv = inv.reshape(-1)
    codes[~null] = inv if ascending else len(uniq) - 1 - inv
    codes[null] = len(uniq)
    return codes


def _host_sort_perm(cols: Sequence[Column], asc: Sequence[bool], device
                    ) -> torch.Tensor:
    """The host sort for varbytes rows past the device prefix bound
    (> 64-byte strings): decode only the sort columns, stable lexsort of
    their rank codes."""
    codes = [_host_rank_codes(c, a) for c, a in zip(cols, asc)]
    perm = np.lexsort(tuple(reversed(codes)))
    return torch.from_numpy(perm.astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# key preparation
# ---------------------------------------------------------------------------


def align_key_columns(left: Table, right: Table, lidx: List[int],
                      ridx: List[int]) -> Tuple[List[Column], List[Column]]:
    """Promote dtypes and unify string storages so both sides' key
    columns compare on the device."""
    lcols, rcols = [], []
    for li, ri in zip(lidx, ridx):
        a, b = _align_pair(left._columns[li], right._columns[ri])
        lcols.append(a)
        rcols.append(b)
    return lcols, rcols


def _align_pair(a: Column, b: Column) -> Tuple[Column, Column]:
    if a.is_string != b.is_string:
        raise CylonError(Code.TypeError,
                         f"key type mismatch: {a.name} vs {b.name}")
    if a.is_string:
        return align_string_columns(a, b)
    if a.data.dtype != b.data.dtype:
        common = dtypes.from_np_dtype(dtypes.numpy_dtype(
            torch.promote_types(a.data.dtype, b.data.dtype)))
        return a.astype(common), b.astype(common)
    return a, b


def _expanded_keys(cols: Sequence[Column],
                   paired: Optional[Sequence[Column]] = None):
    """Key arrays for join/groupby: one per plain column; string columns
    expand (``string_key_arrays``). ``paired``: the other side's aligned
    key columns, so both sides emit the same lane count. Returns (keys,
    valids, raw): ``raw`` marks arrays that already are key bits."""
    keys, valids, raw = [], [], []
    for j, c in enumerate(cols):
        if c.is_string:
            kw = pair_k_words(c, paired[j]) if paired is not None else None
            ks, vs, rs = string_key_arrays(c, kw)
            keys.extend(ks)
            valids.extend(vs)
            raw.extend(rs)
        else:
            keys.append(c.data)
            valids.append(c.validity)
            raw.append(False)
    return keys, valids, raw


def _aligned_setop_columns(left: Table, right: Table):
    """Schema-aligned column pairs for set ops: dtypes promoted, string
    storages aligned (dictionaries unified, or both varbytes)."""
    if left.column_count != right.column_count:
        raise CylonError(Code.Invalid, "set ops need equal schemas")
    idx = list(range(left.column_count))
    return align_key_columns(left, right, idx, idx)


def row_gids(left: Table, right: Table) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared dense FULL-ROW ids for set ops; nulls compare equal (validity
    is part of the key, matching set-distinct semantics)."""
    lcols, rcols = _aligned_setop_columns(left, right)
    keys_l, keys_r = [], []
    for a, b in zip(lcols, rcols):
        if a.is_varbytes:
            kw = pair_k_words(a, b)
            keys_l.extend(string_key_arrays(a, kw)[0])
            keys_r.extend(string_key_arrays(b, kw)[0])
        else:
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


def join(left: Table, right: Table, config: _join.JoinConfig,
         probe_block_rows: Optional[int] = None) -> Table:
    """Local join: two phases (plan, then materialize) with only the
    output counts crossing to the host (the op's one host sync,
    ``join.plan``); the result keeps a static capacity with padding rows
    masked by ``row_mask``. When the estimated plan memory exceeds half
    of the memory pool's free bytes and the probe side has more than 2^20
    rows, the probe side runs in blocks of ``probe_block_rows``
    (``join_blocked``; ``Table.join(probe_block_rows=)`` forces it).

    One ``join`` span a call, whatever the route, holds the stages'
    spans: ``join.prepare``, ``join.plan`` (on the stream route the
    parent of ``join.plan.hash``, ``join.plan.sort`` and
    ``join.plan.stream``), ``join.materialize`` and ``join.rebuild``."""
    with _phase("join"):
        left._require_whole("a local join")
        right._require_whole("a local join")
        if probe_block_rows:
            return join_blocked(left, right, config, int(probe_block_rows))
        est = _join_plan_bytes_estimate(left, right)
        avail = left._ctx.memory_pool.available_bytes()
        probe_cap = right.capacity if config.type == _join.JoinType.RIGHT \
            else left.capacity
        if avail and est > avail // 2 and probe_cap > (1 << 20):
            blk = max((1 << 20),
                      probe_cap // max(2 * est // max(avail, 1), 2))
            return join_blocked(left, right, config, int(blk))
        return _join_once(left, right, config)


def _join_plan_bytes_estimate(left: Table, right: Table) -> int:
    """Rough plan + materialize working-set bytes (the JAX package's
    estimate, data/table.py:865): ~24 bytes a row plus each column's
    width and validity; varbytes columns add twice their word bytes."""
    n = left.capacity + right.capacity
    width = sum(max(c.data.element_size(), 4) + 1
                for c in left._columns + right._columns)
    vb_bytes = sum(4 * int(c.varbytes.words.shape[0])
                   for c in left._columns + right._columns
                   if c.is_varbytes)
    return int(n) * (width + 24) + 2 * vb_bytes


def lane_payload(cols: Sequence[Column], skip=()) -> Tuple[tuple, tuple,
                                                           dict]:
    """Payload tensors of a join side: every column's data and validity,
    then the word lanes of its short varbytes columns (<= LANE_WORDS_MAX
    words, not in ``skip``), which ride the plan and come out as a
    strided layout. Returns (dat, val, slots: column -> (first lane
    index, lane count))."""
    dat = [c.data for c in cols]
    val = [c.validity for c in cols]
    slots = {}
    for i, c in enumerate(cols):
        if c.is_varbytes and c.varbytes.max_words <= LANE_WORDS_MAX \
                and i not in skip:
            slots[i] = (len(dat), c.varbytes.max_words)
            dat += c.varbytes.word_lanes()
            val += [None] * c.varbytes.max_words
    return tuple(dat), tuple(val), slots


def rebuild_join_columns(src: Sequence[Column], od, ov, slots: dict, idx,
                         names: Sequence[str], cm=None,
                         alias: Optional[dict] = None,
                         aliased_to: Sequence[Column] = ()) -> List[Column]:
    """Output columns of a join side from the materialized tensors (flat
    or 1-D): lane columns reassemble strided (lengths zeroed where
    ``idx`` missed), long varbytes columns gather by ``idx``. ``cm``: the
    collective backend of a sharded output (its ``shards`` per-shard
    layouts), None for a local one. ``alias``
    maps a column to the one of ``aliased_to`` whose bytes it shares (the
    right key of an INNER join on word-lane keys)."""
    alias = alias or {}
    cols = []
    for i, (c, name) in enumerate(zip(src, names)):
        if not c.is_varbytes:
            cols.append(Column(od[i], c.dtype, ov[i], name,
                               dictionary=c.dictionary))
            continue
        if i in alias:
            vb = aliased_to[alias[i]].varbytes
        elif i in slots:
            off, k = slots[i]
            vb = VarBytes.from_lanes(list(od[off:off + k]),
                                     torch.where(idx >= 0, od[i], 0),
                                     None if cm is None else cm.shards)
        else:
            vb = take_varbytes(c.varbytes, idx, cm)
        cols.append(Column(vb.lengths, c.dtype, ov[i], name, varbytes=vb))
    return cols


def take_varbytes(vb: VarBytes, idx: torch.Tensor, cm=None) -> VarBytes:
    """Varlen gather by flat indices; ``cm`` (a collective backend):
    ``idx`` is the flat ``[V * m]`` layout of shard-local indices into a
    sharded ``vb`` (one shard is a plain take)."""
    if cm is None or cm.shards <= 1:
        return vb.take(idx)
    from ..parallel.dist_ops import varlen_take_sharded

    return varlen_take_sharded(vb, idx, cm)


def _alias_right_keys(left: Table, right: Table, config) -> dict:
    """INNER joins on byte-exact (word-lane) string keys emit identical
    bytes for both key columns: right key column -> left key column whose
    output it aliases (its lanes and materialization are skipped)."""
    alias = {}
    if config.type == _join.JoinType.INNER:
        for li, rj in zip(config.left_column_idx, config.right_column_idx):
            a, b = left._columns[li], right._columns[rj]
            kp = pair_k_words(a, b)
            if kp is not None and kp <= EXACT_KEY_WORDS:
                alias[rj] = li
    return alias


def _join_once(left: Table, right: Table, config: _join.JoinConfig
               ) -> Table:
    seq = left._ctx.get_next_sequence()
    with _phase("join.prepare", seq):
        lcols, rcols = align_key_columns(left, right,
                                         config.left_column_idx,
                                         config.right_column_idx)
        lkeys, lkvalid, raw = _expanded_keys(lcols, rcols)
        rkeys, rkvalid, _ = _expanded_keys(rcols, lcols)
        lbits, lkv = _join.key_bits(_rows(lkeys), _rows(lkvalid), raw)
        rbits, rkv = _join.key_bits(_rows(rkeys), _rows(rkvalid), raw)
        lemit, remit = _row(left.row_mask), _row(right.row_mask)
        alias = _alias_right_keys(left, right, config)
        ldat, lval, lslots = lane_payload(left._columns)
        rdat, rval, rslots = lane_payload(right._columns, skip=alias)
        ldat, lval, rdat, rval = (_rows(x)
                                  for x in (ldat, lval, rdat, rval))

    jt = config.type
    # FULL_OUTER as LEFT + a tail of unmatched right rows found on the key
    # bits where a stream route could run the LEFT join, except for
    # exact=True on content-hash keys: a collision would hide unmatched
    # rows from the tail, so the plan route (verified and redone on exact
    # codes) takes those
    exact_hashed = config.exact and _long_key_pairs(config, lcols, rcols)
    if jt == _join.JoinType.FULL_OUTER and not exact_hashed and \
            _join.join_route(lbits, rbits, _join.JoinType.LEFT,
                             _join.JoinAlgorithm.AUTO) != "plan":
        sub = _join.JoinConfig(_join.JoinType.LEFT, config.left_column_idx,
                               config.right_column_idx, config.algorithm,
                               exact=config.exact)
        out = _join_once(left, right, sub)
        return _append_unmatched_right(left, right, config, out,
                                       (lcols, rcols))
    args = (lbits, lkv, lemit, rbits, rkv, remit, ldat, lval, rdat, rval, jt)
    rows = []

    def fetch(counts):
        # in the plan's last stage span, as the card finishes it
        rows[:] = counts.tolist()
        _host_sync("join.plan")

    # a 64-bit hash collision: the exact plan route plans again
    for route in (_join.join_route(lbits, rbits, jt, config.algorithm),
                  "plan"):
        with _phase("join.plan", seq):
            plan = _join.plan_join(route, *args, fetch=fetch,
                                   stage=functools.partial(_phase, seq=seq))
            host, collided = plan.read_counts(rows)
        if not collided:
            break
    n_out, n_un = host[0]
    if plan.route == "plan":
        cap = _capacity(n_out)
        cap_u = _capacity(n_un) if jt == _join.JoinType.FULL_OUTER else 0
    elif n_out < 0:
        raise CylonError(Code.ExecutionError,
                         "join output exceeds 2^31 rows per shard; "
                         "repartition over more shards")
    else:
        cap, cap_u = _join.stream_expand_capacity(n_out, plan.block_rows), 0
    with _phase("join.materialize", seq):
        res = plan.materialize(ldat, lval, rdat, rval, cap, cap_u)
    nl = left.column_count
    with _phase("join.rebuild", seq):
        # drop the one-shard batch dimension
        lod, lov, rod, rov = ([x[0] for x in part] for part in res[:4])
        emit, lidx, ridx = res[4][0], res[5][0], res[6][0]
        cols = rebuild_join_columns(left._columns, lod, lov, lslots, lidx,
                                    [f"lt-{i}" for i in range(nl)])
        cols += rebuild_join_columns(
            right._columns, rod, rov, rslots, ridx,
            [f"rt-{nl + j}" for j in range(right.column_count)],
            alias=alias, aliased_to=cols)
    if config.exact:
        emit, collided = _exact_verify_keys(config, lcols, rcols, lidx, ridx,
                                            emit)
        if collided:
            # an outer join's colliding rows would need reclassifying as
            # unmatched: redo the join on exact shared-vocabulary codes
            return _exact_dict_fallback_join(left, right, config)
    return Table(cols, left._ctx, emit)


def _long_key_pairs(config, lcols, rcols):
    """(position, left col, right col) of the varbytes key pairs that
    join on the content hash (longer than EXACT_KEY_WORDS words)."""
    out = []
    for p, (a, b) in enumerate(zip(lcols, rcols)):
        kw = pair_k_words(a, b)
        if kw is not None and kw > EXACT_KEY_WORDS:
            out.append((p, a, b))
    return out


def _exact_verify_keys(config, lcols, rcols, lidx, ridx, emit):
    """Byte verification of hash-identified varbytes join keys (the
    reference re-checks true keys after a hash match,
    arrow_hash_kernels.hpp:110-185). INNER joins drop colliding rows; an
    outer join returns ``collided=True`` for the caller's exact redo."""
    matched = (lidx >= 0) & (ridx >= 0)
    for _p, a, b in _long_key_pairs(config, lcols, rcols):
        eq = a.varbytes.take(lidx).equals_rows(b.varbytes.take(ridx))
        if config.type == _join.JoinType.INNER:
            emit = emit & (~matched | eq)
        elif bool((emit & matched & ~eq).any()):
            return emit, True
    return emit, False


def _exact_dict_fallback_join(left: Table, right: Table,
                              config: _join.JoinConfig) -> Table:
    """Collision recovery for exact outer joins on long varbytes keys:
    re-encode each long key pair over ONE shared sorted vocabulary (a host
    round trip, paid only after a detected 96-bit collision) and redo the
    join on the int32 codes, exact by construction."""
    lcols2, rcols2 = list(left._columns), list(right._columns)
    for li, rj in zip(config.left_column_idx, config.right_column_idx):
        a, b = left._columns[li], right._columns[rj]
        kw = pair_k_words(a, b)
        if kw is not None and kw > EXACT_KEY_WORDS:
            # a local table is whole in this process: nothing to gather
            lcols2[li], rcols2[rj] = _dict_encode_pair(a, b, lambda v: v)
    cfg = _join.JoinConfig(config.type, config.left_column_idx,
                           config.right_column_idx, config.algorithm,
                           exact=False)
    return _join_once(Table(lcols2, left._ctx, left.row_mask),
                      Table(rcols2, right._ctx, right.row_mask), cfg)


def _dict_encode_pair(a: Column, b: Column, gather
                      ) -> Tuple[Column, Column]:
    """Two varbytes key columns as dictionary columns over ONE shared
    sorted vocabulary (the collision recovery of exact=True, local and
    distributed). ``gather`` takes this process's distinct values (a
    host object array) and returns every process's, so that each process
    of columns spread over processes builds the same vocabulary and
    encodes its own rows (at one process it returns them as they are)."""
    filler = b"" if a.dtype.type == dtypes.Type.BINARY else ""

    def _safe_host(c):
        return np.array([filler if v is None else v
                         for v in c.to_numpy().tolist()], dtype=object)

    sa, sb = _safe_host(a), _safe_host(b)
    vocab = _sorted_distinct(gather(_sorted_distinct(
        np.concatenate([sa, sb]))))
    code = {v: i for i, v in enumerate(vocab.tolist())}

    def enc(c, s):
        codes = np.fromiter((code[v] for v in s.tolist()), np.int32,
                            len(s))
        return Column(torch.from_numpy(codes).to(c.data.device), c.dtype,
                      c.validity, c.name, dictionary=vocab)

    return enc(a, sa), enc(b, sb)


def _sorted_distinct(values: np.ndarray) -> np.ndarray:
    """``np.unique`` of a host object array (str or bytes), by a set and
    one sort of the distinct values: the same array, without sorting
    every row."""
    distinct = sorted(set(values.tolist()))
    out = np.empty(len(distinct), object)
    out[:] = distinct
    return out


def join_blocked(left: Table, right: Table, config: _join.JoinConfig,
                 probe_block_rows: int) -> Table:
    """Chunked local join for working sets beyond device memory: the
    probe side (left; right for RIGHT joins) is joined in row blocks of
    ``probe_block_rows`` against the resident build side, the results
    concatenated. FULL_OUTER runs blocked LEFT plus one key-membership
    pass that appends the unmatched build rows."""
    jt = config.type
    probe, other = (right, left) if jt == _join.JoinType.RIGHT \
        else (left, right)
    n = probe.capacity
    sub = _join.JoinConfig(
        _join.JoinType.LEFT if jt == _join.JoinType.FULL_OUTER else jt,
        config.left_column_idx, config.right_column_idx, config.algorithm,
        exact=config.exact)
    blocks = []
    for lo in range(0, max(n, 1), probe_block_rows):
        hi = min(lo + probe_block_rows, n)
        blk = Table([c.slice(lo, hi) for c in probe._columns], probe._ctx,
                    None if probe.row_mask is None
                    else probe.row_mask[lo:hi])
        blocks.append(_join_once(other, blk, sub)
                      if jt == _join.JoinType.RIGHT
                      else _join_once(blk, other, sub))
    out = concat_tables(blocks, left._ctx) if len(blocks) > 1 else blocks[0]
    if jt != _join.JoinType.FULL_OUTER:
        return out
    return _append_unmatched_right(left, right, config, out)


def _null_column(c: Column, n: int) -> Column:
    """An all-null column of ``c``'s type and storage, n rows."""
    dev = c.data.device
    z = torch.zeros(n, dtype=torch.bool, device=dev)
    if c.is_varbytes:
        zi = torch.zeros(n, dtype=torch.int32, device=dev)
        return Column.from_varbytes(
            VarBytes(torch.zeros(1, dtype=torch.int32, device=dev), zi, zi,
                     1, 0), z, c.name, c.dtype)
    return Column(torch.zeros(n, dtype=c.data.dtype, device=dev), c.dtype,
                  z, c.name, dictionary=c.dictionary)


def _append_unmatched_right(left: Table, right: Table, config, out: Table,
                            aligned=None) -> Table:
    """FULL_OUTER = LEFT output + the right rows whose key matches no
    live left row (null keys never match), appended as one tail."""
    lcols, rcols = aligned if aligned is not None else align_key_columns(
        left, right, config.left_column_idx, config.right_column_idx)
    lv = _all_valid(lcols) & left.emit_mask()
    rv = _all_valid(rcols) & right.emit_mask()
    lk, _v, raw = _expanded_keys(lcols, rcols)
    rk, _v, _r = _expanded_keys(rcols, lcols)
    gl, gr = _order.dense_ranks_two(
        [torch.where(lv, k, 0) for k in _join.key_bits(lk, [], raw)[0]],
        [torch.where(rv, k, 0) for k in _join.key_bits(rk, [], raw)[0]])
    in_l = torch.isin(torch.where(rv, gr, -2), torch.where(lv, gl, -1))
    un = right.emit_mask() & torch.where(rv, ~in_l, True)
    r_unmatched = right.filter_mask(un).compact()
    ncap = r_unmatched.capacity
    tail_cols = [_null_column(c, ncap) for c in left._columns] \
        + list(r_unmatched._columns)
    tail = Table([c.rename(nm) for c, nm in
                  zip(tail_cols, out.column_names)], left._ctx,
                 r_unmatched.emit_mask())
    return concat_tables([out, tail], left._ctx)


# ---------------------------------------------------------------------------
# local groupby (reference: LocalHashGroupBy, groupby_hash.hpp:321-359)
# ---------------------------------------------------------------------------


def _check_string_values(cols: Sequence[Column], ops) -> None:
    """Varbytes value columns carry no order or arithmetic: COUNT only
    (dictionary columns take MIN/MAX by code order)."""
    for c, op in zip(cols, ops):
        if c.is_varbytes and op != _groupby.AggregationOp.COUNT:
            raise CylonError(
                Code.NotImplemented,
                "varbytes value columns support COUNT only (MIN/MAX need "
                "a total order the content-hash identity does not carry; "
                "dictionary-encode the column for string MIN/MAX)")


def _agg_column(arr, avalid, src: Column, op) -> Column:
    """An aggregate's output column: MIN/MAX of a dictionary column keep
    its vocabulary."""
    keep = op in (_groupby.AggregationOp.MIN, _groupby.AggregationOp.MAX) \
        and src.dictionary is not None
    return Column(arr, _agg_dtype(src, op), avalid, src.name,
                  dictionary=src.dictionary if keep else None)


def _group_key_arrays(cols: Sequence[Column]) -> list:
    """Group-by keys of key columns: ordered bits (dictionary codes),
    string key arrays for varbytes, each followed by its validity byte
    when the column has a mask."""
    keys = []
    for c in cols:
        if c.is_varbytes:
            keys.extend(string_key_arrays(c)[0])
        else:
            keys.extend(_order.sort_keys([c]))
        if c.validity is not None:
            keys.append(c.valid_mask().to(torch.uint8))
    return keys


def groupby_local(table: Table, index_col, aggregate_cols: List,
                  aggregate_ops: List) -> Table:
    """Sort the rows into groups (one lexsort by dead flag and key bits,
    a key's validity a key of its own), fetch the group count (the op's
    one host sync, ``groupby.count``), then one segment reduction per
    distinct (column, op). The output holds ``pow2(groups)`` rows in key
    order, its padding dead in ``row_mask``.

    One ``groupby`` span a call holds the stages' spans:
    ``groupby.keys``, ``groupby.sort``, ``groupby.gather``,
    ``groupby.aggregate`` (the fetch first) and ``groupby.rebuild``."""
    with _phase("groupby"):
        table._require_whole("a local groupby")
        idx_cols = index_col if isinstance(index_col, (list, tuple)) \
            else [index_col]
        idx_cols = [table._col_index(c) for c in idx_cols]
        val_cols = [table._col_index(c) for c in aggregate_cols]
        ops = list(aggregate_ops)
        _check_string_values([table._columns[i] for i in val_cols], ops)
        values = [table._columns[i].data for i in val_cols]
        valids = [table._columns[i].validity for i in val_cols]
        with _phase("groupby.keys"):
            keys = _group_key_arrays([table._columns[i] for i in idx_cols])
            skeys, emit = _groupby.group_sort_keys(keys, table.emit_mask())
        with _phase("groupby.sort"):
            perm = _order.lexsort_indices(skeys)
        with _phase("groupby.gather"):
            values_s, valids_s, emit_s, iota_s, gid_s, ng = \
                _groupby.sorted_groups(perm, skeys[1:], emit, values,
                                       valids)
            del skeys, emit
        # the fetch opens the aggregate: entered while the device still
        # gathers, the span's bookkeeping keeps out of the idle window
        # that follows the sync
        with _phase("groupby.aggregate"):
            num_groups = max(int(ng[0]), 1)
            _host_sync("groupby.count")
            rep, group_valid, results = _groupby.sorted_segment_aggregate(
                gid_s, emit_s, iota_s, values_s, valids_s,
                _pow2(num_groups), ops, val_cols,
                [table._columns[i].validity is None for i in val_cols])
        with _phase("groupby.rebuild"):
            rep, group_valid = rep[0], group_valid[0]
            safe = torch.clamp(rep, max=max(table.capacity - 1, 0))
            out_cols = []
            for i in idx_cols:
                g = table._columns[i].take(safe)
                out_cols.append(g if table._columns[i].validity is None
                                else g.with_validity(g.validity
                                                     & group_valid))
            for (arr, avalid), vi, op in zip(results, val_cols, ops):
                out_cols.append(_agg_column(arr[0], avalid[0] & group_valid,
                                            table._columns[vi], op))
        return Table(out_cols, table._ctx, group_valid)


# ---------------------------------------------------------------------------
# local set ops (reference: table.cpp:729-942)
# ---------------------------------------------------------------------------


def _merge_pair(a: Column, b: Column) -> Column:
    """[a; b] as one column (aligned storages)."""
    validity = None
    if a.validity is not None or b.validity is not None:
        validity = torch.cat([a.valid_mask(), b.valid_mask()])
    if a.is_varbytes:
        return Column.from_varbytes(concat_varbytes([a.varbytes,
                                                     b.varbytes]),
                                    validity, a.name, a.dtype)
    return Column(torch.cat([a.data, b.data]), a.dtype, validity, a.name,
                  dictionary=a.dictionary)


def set_op(left: Table, right: Table, op) -> Table:
    """Local union/subtract/intersect. The stream route (one sort on a
    full-row hash, then K5/K6) takes lane-packable schemas (dictionary
    strings ride as their codes); the dense-ranks route is the general
    (varbytes) and the hash-collision fallback.

    One ``setop`` span a call holds the stages' spans: ``setop.prepare``
    (alignment, the lane plan, the route), then on the stream route
    ``setop.hash`` (K9: the tag, the lanes and the row hash from the
    columns), ``setop.sort``, ``setop.stream`` (K5 with K6, and the counts
    fetch, the route's one host sync, counted at the distributed set op's
    site ``setop.count``) and ``setop.materialize``; the dense-ranks
    route, general or after a collision, is ``setop.dense``.
    ``cylon_setop_route_total{route=stream|dense|collision}`` counts the
    route each call took."""
    with _phase("setop"):
        left._require_whole("a local set op")
        right._require_whole("a local set op")
        with _phase("setop.prepare"):
            lcols, rcols = _aligned_setop_columns(left, right)
            descs = _setops.setop_lane_descs(lcols, rcols)
            stream = _setops.setop_stream_applicable(
                left.capacity + right.capacity, descs, left._ctx.device)
        route = "dense"
        if stream:
            out = _set_op_stream(left, right, lcols, rcols, descs, op)
            route = "collision" if out is None else "stream"
        _metrics.REGISTRY.counter("cylon_setop_route_total",
                                  {"route": route}).inc()
        if route == "stream":
            return out
        with _phase("setop.dense"):
            gl, gr = row_gids(left, right)
            rows = _setops.setop_rows(gl, gr, left.emit_mask(),
                                      right.emit_mask(), op)
            return Table([_merge_pair(a, b).take(rows)
                          for a, b in zip(lcols, rcols)], left._ctx)


def _set_op_stream(left: Table, right: Table, lcols, rcols, descs, op
                   ) -> Optional[Table]:
    """The stream route's stages under their spans; None where the row
    hash collided (the caller takes the dense-ranks route)."""
    with _phase("setop.hash"):
        hashed = _setops.setop_stream_hash(descs, lcols, rcols,
                                           left.row_mask, right.row_mask)
    with _phase("setop.sort"):
        sorted_in = _setops.setop_stream_sort(*hashed)
        del hashed
    out_len = _setops.stream_out_len(left.capacity, right.capacity)
    with _phase("setop.stream"):
        counts, streams = _kernels.setop_stream(*sorted_in, int(op), out_len)
        del sorted_in
        n_out, n_coll = counts[0].tolist()
        _host_sync("setop.count")
    if n_coll > 0:
        return None
    with _phase("setop.materialize"):
        cols, emit = _setops.setop_stream_columns(descs, lcols, streams,
                                                  n_out, out_len)
        return Table(cols, left._ctx, emit)


def concat_tables(tables: Sequence[Table], ctx: CylonContext) -> Table:
    """Reference: Merge (table.cpp:388-427) — schema-aligned concat.
    String columns mixing storages concatenate as varbytes; dictionary
    columns re-code onto the union of their vocabularies."""
    first = tables[0]
    out_cols = []
    for ci in range(first.column_count):
        cs = [t._columns[ci] for t in tables]
        has_null = any(c.validity is not None for c in cs)
        validity = torch.cat([c.valid_mask() for c in cs]) if has_null \
            else None
        if any(c.is_varbytes for c in cs):
            vb = concat_varbytes([as_varbytes(c).varbytes for c in cs])
            out_cols.append(Column.from_varbytes(vb, validity, cs[0].name,
                                                 cs[0].dtype))
            continue
        vocab = None
        if cs[0].dictionary is not None:
            vocab = cs[0].dictionary
            if any(c.dictionary.shape != vocab.shape
                   or not (c.dictionary == vocab).all() for c in cs[1:]):
                vocab = np.unique(np.concatenate([c.dictionary for c in cs]))
            cs = [remap_dictionary(c, vocab) for c in cs]
        out_cols.append(Column(torch.cat([c.data for c in cs]), cs[0].dtype,
                               validity, cs[0].name, dictionary=vocab))
    mask = None
    if any(t.row_mask is not None for t in tables):
        mask = torch.cat([t.emit_mask() for t in tables])
    return Table(out_cols, ctx, mask)
