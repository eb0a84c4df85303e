"""Configuration objects for cylon_tpu_torch.

The comm configs mirror cylon_tpu.config (reference: cpp/src/cylon/net/
comm_config.hpp:22-36, comm_type.hpp:20-22). The port has two
distributed backends behind one interface (parallel/comm.py): the
*virtual world*, W logical shards on one device, each shard a row of a
``[W, cap]`` tensor, the way the JAX package's tests run a mesh of W
virtual CPU devices; and the *process group*, P processes of V shards
each (W = P * V) joined by ``torch.distributed`` (MultiHostConfig, the
counterpart of the JAX package's ``jax.distributed`` multi-host mesh).

The IO option classes are copied from cylon_tpu.config (reference:
io/csv_read_config.hpp, csv_write_config.hpp).
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

from .dtypes import DataType


class CommType(enum.IntEnum):
    """Reference: net/comm_type.hpp."""

    LOCAL = 0      # single shard, no collectives
    VIRTUAL = 1    # W shards on one device; collectives are tensor ops
    MULTIHOST = 2  # P processes x V shards; torch.distributed collectives


class CommConfig:
    """Abstract comm config (reference: net/comm_config.hpp:22-36)."""

    def comm_type(self) -> CommType:
        raise NotImplementedError


class LocalConfig(CommConfig):
    """Single-shard, non-distributed context."""

    def comm_type(self) -> CommType:
        return CommType.LOCAL


class VirtualWorldConfig(CommConfig):
    """W logical shards on one device (the counterpart of cylon_tpu's
    ``TPUConfig(world_size=W)``)."""

    def __init__(self, world_size: int = 1):
        if int(world_size) < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self.world_size = int(world_size)

    def comm_type(self) -> CommType:
        return CommType.VIRTUAL


class MultiHostConfig(CommConfig):
    """P processes of V shards each, joined by ``torch.distributed``
    (the counterpart of cylon_tpu's ``MultiHostConfig``, whose
    ``jax.distributed.initialize`` gives each controller process the
    shards of its local devices; reference: mpi_communicator.cpp:41-70).

    Args:
      coordinator_address: ``host:port`` of rank 0's store, used as
        ``tcp://host:port`` when no ``init_method`` is given.
      num_processes: P (None: ``WORLD_SIZE`` from the environment, as
        ``torchrun`` sets it).
      process_id: this process's rank (None: ``RANK``).
      backend: ``"nccl"`` or ``"gloo"``; None means NCCL on a CUDA device
        and gloo on the CPU. NCCL takes one card a rank; processes that
        share a card use gloo, which stages CUDA tensors through host
        memory.
      shards_per_process: V, the shards each process owns (the JAX
        package takes it from the local device count).
      init_method: a ``torch.distributed`` rendezvous URL, e.g.
        ``file:///path`` (no port to race for) or ``tcp://host:port``;
        None with no ``coordinator_address`` means ``env://`` (one
        process alone uses an in-memory store).
    """

    def __init__(self, coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None,
                 backend: Optional[str] = None,
                 shards_per_process: int = 1,
                 init_method: Optional[str] = None):
        if int(shards_per_process) < 1:
            raise ValueError("shards_per_process must be >= 1, got "
                             f"{shards_per_process}")
        if backend not in (None, "nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl', 'gloo' or None, "
                             f"got {backend!r}")
        self.coordinator_address = coordinator_address
        self.num_processes = num_processes
        self.process_id = process_id
        self.backend = backend
        self.shards_per_process = int(shards_per_process)
        self.init_method = init_method

    def comm_type(self) -> CommType:
        return CommType.MULTIHOST


# reference-style spelling (pycylon.net.MPIConfig)
MPIConfig = VirtualWorldConfig


class CSVReadOptions:
    """Fluent CSV read options (reference: io/csv_read_config.hpp:27-147).

    Both the reference's C++ PascalCase and pycylon's snake_case spellings
    are provided (python/pycylon/io/csv_read_config.pyx).
    """

    def __init__(self):
        self._use_threads = True
        self._concurrent_file_reads = True
        self._delimiter = ","
        self._ignore_empty_lines = False
        self._autogenerate_column_names = False
        self._column_names: Optional[List[str]] = None
        self._block_size = 1 << 20
        self._quoting = False
        self._quote_char = '"'
        self._double_quote = True
        self._escaping = False
        self._escape_char = "\\"
        self._newlines_in_values = False
        self._skip_rows = 0
        self._column_types: Optional[Dict[str, DataType]] = None
        self._null_values: Optional[List[str]] = None
        self._true_values: Optional[List[str]] = None
        self._false_values: Optional[List[str]] = None
        self._strings_can_be_null = False
        self._include_columns: Optional[List[str]] = None
        self._include_missing_columns = False
        self._slice = False

    # -- cylon-specific --
    def ConcurrentFileReads(self, v: bool) -> "CSVReadOptions":
        self._concurrent_file_reads = v
        return self

    def IsConcurrentFileReads(self) -> bool:
        return self._concurrent_file_reads

    # -- arrow-backed options --
    def UseThreads(self, v: bool) -> "CSVReadOptions":
        self._use_threads = v
        return self

    def WithDelimiter(self, d: str) -> "CSVReadOptions":
        self._delimiter = d
        return self

    def IgnoreEmptyLines(self) -> "CSVReadOptions":
        self._ignore_empty_lines = True
        return self

    def AutoGenerateColumnNames(self) -> "CSVReadOptions":
        self._autogenerate_column_names = True
        return self

    def ColumnNames(self, names: Sequence[str]) -> "CSVReadOptions":
        self._column_names = list(names)
        return self

    def BlockSize(self, n: int) -> "CSVReadOptions":
        self._block_size = n
        return self

    def UseQuoting(self) -> "CSVReadOptions":
        self._quoting = True
        return self

    def WithQuoteChar(self, c: str) -> "CSVReadOptions":
        self._quote_char = c
        return self

    def DoubleQuote(self) -> "CSVReadOptions":
        self._double_quote = True
        return self

    def UseEscaping(self) -> "CSVReadOptions":
        self._escaping = True
        return self

    def EscapingCharacter(self, c: str) -> "CSVReadOptions":
        self._escape_char = c
        return self

    def HasNewLinesInValues(self) -> "CSVReadOptions":
        self._newlines_in_values = True
        return self

    def SkipRows(self, n: int) -> "CSVReadOptions":
        self._skip_rows = n
        return self

    def WithColumnTypes(self, types: Dict[str, DataType]) -> "CSVReadOptions":
        self._column_types = dict(types)
        return self

    def NullValues(self, vals: Sequence[str]) -> "CSVReadOptions":
        self._null_values = list(vals)
        return self

    def TrueValues(self, vals: Sequence[str]) -> "CSVReadOptions":
        self._true_values = list(vals)
        return self

    def FalseValues(self, vals: Sequence[str]) -> "CSVReadOptions":
        self._false_values = list(vals)
        return self

    def StringsCanBeNull(self) -> "CSVReadOptions":
        self._strings_can_be_null = True
        return self

    def IncludeColumns(self, cols: Sequence[str]) -> "CSVReadOptions":
        self._include_columns = list(cols)
        return self

    def IncludeMissingColumns(self) -> "CSVReadOptions":
        self._include_missing_columns = True
        return self

    # -- pycylon snake_case aliases (csv_read_config.pyx:32-45) --
    def use_threads(self, v: bool) -> "CSVReadOptions":
        return self.UseThreads(v)

    def block_size(self, n: int) -> "CSVReadOptions":
        return self.BlockSize(n)

    def with_delimiter(self, d: str) -> "CSVReadOptions":
        return self.WithDelimiter(d)

    def ignore_emptylines(self) -> "CSVReadOptions":
        return self.IgnoreEmptyLines()

    def skip_rows(self, n: int) -> "CSVReadOptions":
        return self.SkipRows(n)


class CSVWriteOptions:
    """Reference: io/csv_write_config.hpp:20-52."""

    def __init__(self):
        self._delimiter = ","
        self._column_names: Optional[List[str]] = None

    def WithDelimiter(self, d: str) -> "CSVWriteOptions":
        self._delimiter = d
        return self

    def ColumnNames(self, names: Sequence[str]) -> "CSVWriteOptions":
        self._column_names = list(names)
        return self

    def GetDelimiter(self) -> str:
        return self._delimiter

    def GetColumnNames(self) -> Optional[List[str]]:
        return self._column_names

    def IsOverrideColumnNames(self) -> bool:
        return self._column_names is not None

    # pycylon snake_case
    def with_delimiter(self, d: str) -> "CSVWriteOptions":
        return self.WithDelimiter(d)


class ParquetOptions:
    """Reference: io/parquet_config.hpp (chunk size + writer properties)."""

    def __init__(self):
        self._chunk_size = 64 * 1024
        self._compression: Optional[str] = None
        self._concurrent_file_reads = True

    def ChunkSize(self, n: int) -> "ParquetOptions":
        self._chunk_size = n
        return self

    def WithCompression(self, codec: str) -> "ParquetOptions":
        self._compression = codec
        return self

    def ConcurrentFileReads(self, v: bool) -> "ParquetOptions":
        self._concurrent_file_reads = v
        return self
