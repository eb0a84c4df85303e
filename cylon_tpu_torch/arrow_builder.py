"""Raw-buffer table assembly for bindings — arrow_builder parity
(counterpart of cylon_tpu.arrow_builder).

Reference: cpp/src/cylon/arrow/arrow_builder.{hpp,cpp}:31-161 —
``BeginTable / AddColumn(type, counts, buffer addresses) / FinishTable``
assembles a *registered* table from raw Arrow-layout buffers so a
foreign runtime (the reference's JNI layer) can hand over memory by
address instead of objects. ``add_column`` reads the caller's buffers
once on the host (ctypes address + size -> numpy), while the caller
still owns them; ``finish_table`` moves the columns to the context's
device (fixed-width tensors, varbytes for STRING/BINARY via the Arrow
offsets+data layout) and registers the finished Table in the string-id
registry of `table_api`. Without a context it builds one with
``CylonContext.Init()``, which is CUDA.

Buffer conventions (Arrow layout):
* validity: LSB-ordered bitmap, 1 = valid; address 0 / size 0 = no nulls
* data: for fixed-width types, value_count items of the type's width;
  for STRING/BINARY this is the concatenated byte payload
* offsets (varlen only): int32[value_count + 1] byte offsets
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import numpy as np

from . import table_api
from .data.column import Column, _dev_mask
from .data.strings import VarBytes
from .dtypes import Type
from .status import Code, CylonError, Status

# table id -> staged host columns: (name, varbytes buffers or values,
# validity); they move to the device in finish_table
_staged: Dict[str, List[tuple]] = {}
_lock = threading.Lock()

_FIXED_NP = {
    Type.BOOL: np.uint8,  # Arrow bools arrive as a bitmap; see below
    Type.UINT8: np.uint8, Type.INT8: np.int8,
    Type.UINT16: np.uint16, Type.INT16: np.int16,
    Type.UINT32: np.uint32, Type.INT32: np.int32,
    Type.UINT64: np.uint64, Type.INT64: np.int64,
    Type.HALF_FLOAT: np.float16, Type.FLOAT: np.float32,
    Type.DOUBLE: np.float64,
    Type.DATE32: np.int32, Type.DATE64: np.int64,
    Type.TIMESTAMP: np.int64, Type.TIME32: np.int32,
    Type.TIME64: np.int64,
}


def _read_buffer(address: int, size: int) -> bytes:
    if address == 0 or size == 0:
        return b""
    return ctypes.string_at(ctypes.c_void_p(address), int(size))


def _unpack_bitmap(raw: bytes, n: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(raw, np.uint8), bitorder="little")
    return bits[:n].astype(bool)


def begin_table(table_id: str) -> Status:
    """Reference: BeginTable (arrow_builder.cpp:31-38)."""
    with _lock:
        if table_id in _staged:
            raise CylonError(Code.AlreadyExists,
                             f"table {table_id!r} already being built")
        _staged[table_id] = []
    return Status.OK()


def add_column(table_id: str, col_name: str, type_code: int,
               value_count: int, null_count: int,
               validity_address: int, validity_size: int,
               data_address: int, data_size: int,
               offset_address: int = 0, offset_size: int = 0) -> Status:
    """Reference: AddColumn (arrow_builder.cpp:40-118) — the varlen
    overload is selected by passing offset buffers."""
    with _lock:
        if table_id not in _staged:
            raise CylonError(Code.KeyError,
                             f"BeginTable({table_id!r}) was never called")
    t = Type(type_code)
    validity = None
    if null_count and validity_size:
        validity = _unpack_bitmap(
            _read_buffer(validity_address, validity_size), value_count)

    if t in (Type.STRING, Type.BINARY):
        if not offset_size:
            raise CylonError(Code.Invalid,
                             f"{t.name} column needs offset buffers")
        offsets = np.frombuffer(
            _read_buffer(offset_address, offset_size),
            np.int32)[: value_count + 1]
        staged = (offsets, _read_buffer(data_address, data_size))
    elif t == Type.BOOL:
        staged = _unpack_bitmap(_read_buffer(data_address, data_size),
                                value_count)
    else:
        np_t = _FIXED_NP.get(t)
        if np_t is None:
            raise CylonError(Code.NotImplemented,
                             f"arrow_builder: unsupported type {t.name}")
        staged = np.frombuffer(_read_buffer(data_address, data_size),
                               np_t)[:value_count].copy()
    with _lock:
        _staged[table_id].append((col_name, staged, validity))
    return Status.OK()


def _to_column(name: str, staged, validity: Optional[np.ndarray],
               device) -> Column:
    if isinstance(staged, tuple):
        vb = VarBytes.from_arrow_buffers(*staged, device=device)
        return Column.from_varbytes(vb, _dev_mask(validity, device), name)
    return Column.from_numpy(staged, name, validity, device)


def finish_table(table_id: str, ctx=None) -> Status:
    """Reference: FinishTable (arrow_builder.cpp:120-161) — the built
    table becomes visible through the table_api registry."""
    from .context import CylonContext
    from .data.table import Table

    with _lock:
        cols = _staged.pop(table_id, None)
    if cols is None:
        raise CylonError(Code.KeyError,
                         f"BeginTable({table_id!r}) was never called")
    ctx = ctx or CylonContext.Init()
    table_api.put_table(table_id, Table(
        [_to_column(*c, ctx.device) for c in cols], ctx))
    return Status.OK()
