"""CSV IO — pyarrow-backed read, pandas write (counterpart of
cylon_tpu.io.csv).

Reference: cpp/src/cylon/io/arrow_io.cpp:34-62 and table.cpp:1019-1064.
pyarrow's C++ CSV reader parses on the host; the parsed columns move to
the context's device, string columns through the ingest policy of
data/column.py (dictionary or varbytes). pyarrow and pandas are imported
inside the functions: the machine with the card has neither, and the
rest of the port does not need them. Where pyarrow is missing, a CSV of
numeric columns under a header row is read with numpy.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

from ..config import CSVReadOptions, CSVWriteOptions
from ..context import CylonContext
from ..data.column import Column
from ..data.table import Table, concat_tables
from ..resilience import inject as _inject
from ..resilience import retry as _retry
from ..status import Code, CylonDataError, CylonError


def _arrow_options(options: CSVReadOptions):
    import pyarrow.csv as pacsv

    o = options
    read_opts = pacsv.ReadOptions(
        use_threads=o._use_threads, block_size=o._block_size,
        skip_rows=o._skip_rows, column_names=o._column_names,
        autogenerate_column_names=o._autogenerate_column_names)
    parse_opts = pacsv.ParseOptions(
        delimiter=o._delimiter,
        quote_char=o._quote_char if o._quoting else '"',
        double_quote=o._double_quote,
        escape_char=o._escape_char if o._escaping else False,
        newlines_in_values=o._newlines_in_values,
        ignore_empty_lines=bool(o._ignore_empty_lines))
    convert_kwargs = dict(
        check_utf8=True, strings_can_be_null=o._strings_can_be_null,
        include_columns=o._include_columns,
        include_missing_columns=o._include_missing_columns)
    if o._null_values is not None:
        convert_kwargs["null_values"] = o._null_values
    if o._true_values is not None:
        convert_kwargs["true_values"] = o._true_values
    if o._false_values is not None:
        convert_kwargs["false_values"] = o._false_values
    if o._column_types is not None:
        import pyarrow as pa

        convert_kwargs["column_types"] = {
            name: pa.string() if dt.is_var_width()
            else pa.from_numpy_dtype(dt.np_dtype)
            for name, dt in o._column_types.items()}
    return read_opts, parse_opts, pacsv.ConvertOptions(**convert_kwargs)


def read_csv(ctx: CylonContext, path: Union[str, Sequence[str]],
             options: Optional[CSVReadOptions] = None) -> Table:
    """Reference: FromCSV (table.cpp:367-386); several paths are read one
    after another and concatenated (table.cpp:1030-1064)."""
    options = options or CSVReadOptions()
    if isinstance(path, (list, tuple)):
        paths: List[str] = list(path)
        return concat_tables([_read_one(ctx, p, options) for p in paths],
                             ctx)
    return _read_one(ctx, path, options)


def read_csv_per_rank(ctx: CylonContext, path_pattern: str,
                      options: Optional[CSVReadOptions] = None) -> Table:
    """Per-rank file placement: ``path_pattern`` contains ``{rank}``,
    substituted with each shard index (the reference's per-rank CSV
    convention, cpp/test/join_test.cpp:22-24 ``csv1_<rank>.csv``). Each
    process reads the files of its own shards (every shard's in the
    virtual world) and shard i of the result holds file i's rows
    (`shard.assemble_process_local`): collective, every process must
    call it."""
    from ..parallel import shard as _shard

    options = options or CSVReadOptions()
    return _shard.assemble_process_local(
        [_read_one(ctx, path_pattern.format(rank=i), options)
         for i in ctx.local_shard_indices()], ctx)


# read options the numpy reader honours (the rest must keep their
# defaults there)
_HOST_OPTIONS = ("_delimiter", "_use_threads", "_concurrent_file_reads",
                 "_block_size")


def _read_one(ctx: CylonContext, path: str, options: CSVReadOptions) -> Table:
    import numpy as np

    try:
        import pyarrow as pa
    except ImportError:
        # a machine without pyarrow (the one with the card): numeric
        # columns through numpy
        return _read_numeric(ctx, path, options)
    import pyarrow.csv as pacsv

    read_opts, parse_opts, convert_opts = _arrow_options(options)

    def attempt():
        # one arrival at the fault injector's ingest site per attempt;
        # IOError and malformed bytes do not retry, transient failures do
        _inject.fire("ingest", detail=f"csv {path}")
        try:
            return pacsv.read_csv(path, read_options=read_opts,
                                  parse_options=parse_opts,
                                  convert_options=convert_opts)
        except OSError as e:
            raise CylonError(Code.IOError, str(e))
        except (pa.ArrowInvalid, pa.ArrowException, ValueError) as e:
            raise CylonDataError(f"malformed CSV {path}: {e}") from e

    at = _retry.run_retryable("ingest", attempt)
    cols = []
    for i, name in enumerate(at.column_names):
        arr = at.column(i).combine_chunks()
        if pa.types.is_string(arr.type) or pa.types.is_large_string(
                arr.type) or pa.types.is_binary(arr.type):
            # the string ingest policy: dictionary or varbytes
            cols.append(Column.from_pyarrow(arr, name, ctx.device))
            continue
        validity = None
        if arr.null_count:
            validity = np.asarray(arr.is_valid())
            arr = arr.fill_null(pa.scalar(0).cast(arr.type)
                                if not pa.types.is_boolean(arr.type)
                                else False)
        cols.append(Column.from_numpy(arr.to_numpy(zero_copy_only=False),
                                      name, validity, ctx.device))
    return Table(cols, ctx)


def _read_numeric(ctx: CylonContext, path: str,
                  options: CSVReadOptions) -> Table:
    """Read a CSV of numeric columns under a header row with numpy: int64
    where every value of a column is an integer, float64 otherwise, as
    pyarrow infers them; an empty field is a null. Anything else raises
    ``Code.NotImplemented``."""
    import numpy as np

    default = CSVReadOptions()
    bad = sorted(k for k, v in vars(options).items()
                 if k not in _HOST_OPTIONS and v != getattr(default, k))
    if bad:
        raise CylonError(Code.NotImplemented,
                         f"CSV options {bad} need pyarrow")
    delim = options._delimiter

    def attempt():
        _inject.fire("ingest", detail=f"csv {path}")
        try:
            with open(path) as f:
                return [ln for ln in f.read().splitlines() if ln]
        except OSError as e:
            raise CylonError(Code.IOError, str(e))

    lines = _retry.run_retryable("ingest", attempt)
    if not lines:
        raise CylonDataError(f"malformed CSV {path}: no header row")
    names = lines[0].split(delim)
    rows = [ln.split(delim) for ln in lines[1:]]
    if any(len(r) != len(names) for r in rows):
        raise CylonDataError(f"malformed CSV {path}: ragged rows")
    cols = []
    for i, name in enumerate(names):
        raw = np.array([r[i] for r in rows], dtype=str)
        valid = raw != ""
        filled = np.where(valid, raw, "0")
        try:
            vals = filled.astype(np.int64)
        except ValueError:
            try:
                vals = filled.astype(np.float64)
            except ValueError:
                raise CylonError(Code.NotImplemented,
                                 f"CSV column {name!r} is not numeric: "
                                 f"reading it needs pyarrow") from None
        cols.append(Column.from_numpy(vals, name,
                                      None if valid.all() else valid,
                                      ctx.device))
    return Table(cols, ctx)


def write_csv(table: Table, path: str,
              options: Optional[CSVWriteOptions] = None) -> None:
    """Reference: Table::WriteCSV (table.cpp:429-440, 1091-1142), through
    pandas on the host."""
    options = options or CSVWriteOptions()
    df = table.to_pandas()
    names = options.GetColumnNames()
    if names is not None:
        df.columns = names
    df.to_csv(path, sep=options.GetDelimiter(), index=False)
