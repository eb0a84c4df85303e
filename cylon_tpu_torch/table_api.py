"""String-id table registry — the bindings-facing operator API
(counterpart of cylon_tpu.table_api).

Mirrors the reference's `table_api` (reference: cpp/src/cylon/
table_api.hpp:38-195, table_api.cpp:37-393): a global mutex-guarded
``map<string, Table>`` with id-keyed wrappers around every operator, kept
for parity with language bindings that pass handles rather than objects
(the reference's JNI layer, java/src/main/native/src/Table.cpp:37-46).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .context import CylonContext
from .data.table import Table, join as _join_free, set_op as _set_op
from .ops import join as _join
from .ops import setops as _setops
from .status import Code, CylonError, Status

_tables: Dict[str, Table] = {}
_lock = threading.Lock()


def put_table(table_id: str, table: Table) -> None:
    """Reference: PutTable (table_api.cpp:40-47)."""
    with _lock:
        _tables[table_id] = table


def get_table(table_id: str) -> Table:
    """Reference: GetTable (table_api.cpp:49-57)."""
    with _lock:
        t = _tables.get(table_id)
    if t is None:
        raise CylonError(Code.KeyError, f"no table registered as {table_id!r}")
    return t


def remove_table(table_id: str) -> None:
    """Reference: RemoveTable (table_api.cpp:59-64)."""
    with _lock:
        _tables.pop(table_id, None)


def new_table_id(prefix: str = "t") -> str:
    """Fresh unique registry id (reference: util/uuid.hpp generate_uuid —
    the reference mints ids for intermediate JNI tables; callers here may
    also pass their own)."""
    import uuid

    return f"{prefix}-{uuid.uuid4().hex[:12]}"


def registered_ids() -> List[str]:
    with _lock:
        return sorted(_tables)


# ---------------------------------------------------------------------------
# id-keyed operator wrappers (table_api.hpp:38-195)
# ---------------------------------------------------------------------------

def read_csv(ctx: CylonContext, path: str, table_id: str,
             options=None) -> Status:
    from .io.csv import read_csv as _read

    put_table(table_id, _read(ctx, path, options))
    return Status.OK()


def write_csv(table_id: str, path: str, options=None) -> Status:
    from .io.csv import write_csv as _write

    _write(get_table(table_id), path, options)
    return Status.OK()


def join_tables(left_id: str, right_id: str, join_config: _join.JoinConfig,
                out_id: str) -> Status:
    """Reference: JoinTables (table_api.cpp:131-156)."""
    put_table(out_id, _join_free(get_table(left_id), get_table(right_id),
                                 join_config))
    return Status.OK()


def distributed_join_tables(left_id: str, right_id: str,
                            join_config: _join.JoinConfig,
                            out_id: str) -> Status:
    from .parallel.dist_ops import distributed_join

    put_table(out_id, distributed_join(get_table(left_id),
                                       get_table(right_id), join_config))
    return Status.OK()


def _setop_api(op: _setops.SetOp, distributed: bool):
    def fn(left_id: str, right_id: str, out_id: str) -> Status:
        left, right = get_table(left_id), get_table(right_id)
        if distributed:
            from .parallel.dist_ops import distributed_set_op

            put_table(out_id, distributed_set_op(left, right, op))
        else:
            put_table(out_id, _set_op(left, right, op))
        return Status.OK()
    return fn


union_tables = _setop_api(_setops.SetOp.UNION, False)
distributed_union_tables = _setop_api(_setops.SetOp.UNION, True)
subtract_tables = _setop_api(_setops.SetOp.SUBTRACT, False)
distributed_subtract_tables = _setop_api(_setops.SetOp.SUBTRACT, True)
intersect_tables = _setop_api(_setops.SetOp.INTERSECT, False)
distributed_intersect_tables = _setop_api(_setops.SetOp.INTERSECT, True)


def sort_table(table_id: str, out_id: str, column, ascending=True) -> Status:
    put_table(out_id, get_table(table_id).sort(column, ascending=ascending))
    return Status.OK()


def select_table(table_id: str, out_id: str, predicate) -> Status:
    put_table(out_id, get_table(table_id).select(predicate))
    return Status.OK()


def project_table(table_id: str, out_id: str, columns) -> Status:
    put_table(out_id, get_table(table_id).project(columns))
    return Status.OK()


def shuffle_table(table_id: str, hash_columns, out_id: str) -> Status:
    from .parallel.dist_ops import shuffle

    put_table(out_id, shuffle(get_table(table_id), hash_columns))
    return Status.OK()


def hash_partition_table(table_id: str, hash_columns, num_partitions: int,
                         out_prefix: str) -> Status:
    """Partitions registered as f"{out_prefix}{i}"."""
    from .parallel.dist_ops import hash_partition

    parts = hash_partition(get_table(table_id), hash_columns, num_partitions)
    for i, t in parts.items():
        put_table(f"{out_prefix}{i}", t)
    return Status.OK()


def merge_tables(table_ids: List[str], out_id: str,
                 ctx: Optional[CylonContext] = None) -> Status:
    from .data.table import concat_tables

    tables = [get_table(i) for i in table_ids]
    put_table(out_id, concat_tables(tables, ctx or tables[0].context))
    return Status.OK()


# ---------------------------------------------------------------------------
# lazy plan facade (plan/) — id-keyed like every wrapper here
# ---------------------------------------------------------------------------

def lazy_table(table_id: str):
    """Start a lazy query plan over a registered table; build the
    pipeline with LazyTable methods and finish with
    ``execute(out_id=...)`` to register the result."""
    from .plan import scan

    return scan(table_id)


def execute_plan(lazy, out_id: str) -> Status:
    """Optimize + execute a `LazyTable` pipeline, registering the
    result under ``out_id``."""
    lazy.execute(out_id=out_id)
    return Status.OK()


def row_count(table_id: str) -> int:
    return get_table(table_id).row_count


def column_count(table_id: str) -> int:
    return get_table(table_id).column_count


def show_table(table_id: str, row1: int = 0, row2: int = -1,
               col1: int = 0, col2: int = -1) -> None:
    """Print rows [row1, row2) of columns [col1, col2) (-1: to the end),
    one tab-separated line a row after the header."""
    data = get_table(table_id).to_pydict()
    names = list(data)[col1:None if col2 == -1 else col2]
    n = len(next(iter(data.values()))) if data else 0
    print("\t".join(names))
    for i in range(row1, n if row2 == -1 else min(row2, n)):
        print("\t".join(str(data[k][i]) for k in names))
