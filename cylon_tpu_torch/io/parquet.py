"""Parquet IO through pyarrow (counterpart of cylon_tpu.io.parquet;
reference: io/arrow_io.cpp:64-113 and parquet.cpp). pyarrow is imported
inside the functions. Every file read is one arrival at the fault
injector's ``ingest`` site and runs under the bounded retry policy
(``run_retryable("ingest")``), as in the JAX package."""
from __future__ import annotations

from typing import Optional, Sequence, Union

from ..config import ParquetOptions
from ..context import CylonContext
from ..data.table import Table, concat_tables
from ..resilience import inject as _inject
from ..resilience import retry as _retry
from ..status import Code, CylonDataError, CylonError


def _read_table(path: str):
    """One parquet file -> pyarrow table. A missing file or a permission
    error is an IOError; malformed bytes a typed CylonDataError (neither
    retries); a transient failure retries under the bounded policy."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    def attempt():
        _inject.fire("ingest", detail=f"parquet {path}")
        try:
            return pq.read_table(path)
        except OSError as e:
            raise CylonError(Code.IOError, str(e))
        except (pa.ArrowInvalid, pa.ArrowException, ValueError) as e:
            raise CylonDataError(f"malformed parquet {path}: {e}") from e

    return _retry.run_retryable("ingest", attempt)


def read_parquet(ctx: CylonContext, path: Union[str, Sequence[str]],
                 options: Optional[ParquetOptions] = None) -> Table:
    if isinstance(path, (list, tuple)):
        return concat_tables([read_parquet(ctx, p, options) for p in path],
                             ctx)
    return Table.from_arrow(ctx, _read_table(path))


def read_parquet_per_rank(ctx: CylonContext, path_pattern: str,
                          options: Optional[ParquetOptions] = None
                          ) -> Table:
    """Per-rank parquet placement, as `io.csv.read_csv_per_rank`:
    ``path_pattern`` contains ``{rank}``, substituted with each shard
    index; each process reads its own shards' files and shard i of the
    result holds file i's rows. Collective: every process must call
    it."""
    from ..parallel import shard as _shard

    return _shard.assemble_process_local(
        [Table.from_arrow(ctx, _read_table(path_pattern.format(rank=i)))
         for i in ctx.local_shard_indices()], ctx)


def write_parquet(table: Table, path: str,
                  options: Optional[ParquetOptions] = None) -> None:
    import pyarrow.parquet as pq

    options = options or ParquetOptions()
    pq.write_table(table.to_arrow(), path,
                   row_group_size=options._chunk_size,
                   compression=options._compression or "snappy")
