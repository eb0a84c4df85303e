"""Data type system for cylon_tpu_torch (cylon_tpu.dtypes plus the torch
dtype map).

Mirrors the reference's stripped-down Arrow type system (reference:
cpp/src/cylon/data_types.hpp:25-175 — `Type::type` enum, `Layout`,
factory functions `Int64()`, `Double()`, ...), mapped onto device dtypes:

* fixed-width types map 1:1 to a numpy dtype and a ``torch.dtype``
  resident in device memory;
* STRING/BINARY are VARIABLE layout; the port does not carry them yet
  (data/column.py raises a typed "not yet ported" error);
* temporal types carry their unit and are stored as int32/int64 lanes.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


class Type(enum.IntEnum):
    """Reference: cpp/src/cylon/data_types.hpp `Type::type` enum."""

    BOOL = 0
    UINT8 = 1
    INT8 = 2
    UINT16 = 3
    INT16 = 4
    UINT32 = 5
    INT32 = 6
    UINT64 = 7
    INT64 = 8
    HALF_FLOAT = 9
    FLOAT = 10
    DOUBLE = 11
    STRING = 12
    BINARY = 13
    FIXED_SIZE_BINARY = 14
    DATE32 = 15
    DATE64 = 16
    TIMESTAMP = 17
    TIME32 = 18
    TIME64 = 19
    INTERVAL = 20
    DECIMAL = 21
    LIST = 22
    EXTENSION = 23
    DURATION = 24


class Layout(enum.IntEnum):
    """Reference: data_types.hpp `Layout` (FIXED_WIDTH vs VARIABLE_WIDTH)."""

    FIXED_WIDTH = 1
    VARIABLE_WIDTH = 2


class TimeUnit(enum.IntEnum):
    SECOND = 0
    MILLI = 1
    MICRO = 2
    NANO = 3


_FIXED_NP: dict[Type, np.dtype] = {
    Type.BOOL: np.dtype(np.bool_),
    Type.UINT8: np.dtype(np.uint8),
    Type.INT8: np.dtype(np.int8),
    Type.UINT16: np.dtype(np.uint16),
    Type.INT16: np.dtype(np.int16),
    Type.UINT32: np.dtype(np.uint32),
    Type.INT32: np.dtype(np.int32),
    Type.UINT64: np.dtype(np.uint64),
    Type.INT64: np.dtype(np.int64),
    Type.HALF_FLOAT: np.dtype(np.float16),
    Type.FLOAT: np.dtype(np.float32),
    Type.DOUBLE: np.dtype(np.float64),
    # temporal lanes
    Type.DATE32: np.dtype(np.int32),
    Type.DATE64: np.dtype(np.int64),
    Type.TIMESTAMP: np.dtype(np.int64),
    Type.TIME32: np.dtype(np.int32),
    Type.TIME64: np.dtype(np.int64),
    Type.DURATION: np.dtype(np.int64),
}

_NP_TO_TYPE: dict[np.dtype, Type] = {
    np.dtype(np.bool_): Type.BOOL,
    np.dtype(np.uint8): Type.UINT8,
    np.dtype(np.int8): Type.INT8,
    np.dtype(np.uint16): Type.UINT16,
    np.dtype(np.int16): Type.INT16,
    np.dtype(np.uint32): Type.UINT32,
    np.dtype(np.int32): Type.INT32,
    np.dtype(np.uint64): Type.UINT64,
    np.dtype(np.int64): Type.INT64,
    np.dtype(np.float16): Type.HALF_FLOAT,
    np.dtype(np.float32): Type.FLOAT,
    np.dtype(np.float64): Type.DOUBLE,
}


@dataclass(frozen=True)
class DataType:
    """Reference: data_types.hpp `DataType::Make(type, layout)`."""

    type: Type
    layout: Layout = Layout.FIXED_WIDTH
    unit: Optional[TimeUnit] = field(default=None)  # temporal types only
    byte_width: int = -1  # FIXED_SIZE_BINARY only

    @staticmethod
    def Make(t: Type, layout: Layout = Layout.FIXED_WIDTH) -> "DataType":
        return DataType(t, layout)

    @property
    def np_dtype(self) -> np.dtype:
        """The numpy/jnp lane dtype backing this column on device."""
        if self.type in (Type.STRING, Type.BINARY):
            return np.dtype(np.int32)  # dictionary codes
        if self.type == Type.FIXED_SIZE_BINARY:
            return np.dtype(np.int32)  # dictionary codes
        try:
            return _FIXED_NP[self.type]
        except KeyError:
            raise TypeError(f"type {self.type.name} has no device lane dtype")

    def is_numeric(self) -> bool:
        return self.type in _FIXED_NP and self.type not in (
            Type.DATE32, Type.DATE64, Type.TIMESTAMP, Type.TIME32, Type.TIME64,
            Type.DURATION,
        )

    def is_temporal(self) -> bool:
        return self.type in (Type.DATE32, Type.DATE64, Type.TIMESTAMP,
                             Type.TIME32, Type.TIME64, Type.DURATION)

    def is_var_width(self) -> bool:
        return self.layout == Layout.VARIABLE_WIDTH


# Factory functions (reference: data_types.hpp TYPE_FACTORY macros).
def Bool() -> DataType: return DataType(Type.BOOL)
def UInt8() -> DataType: return DataType(Type.UINT8)
def Int8() -> DataType: return DataType(Type.INT8)
def UInt16() -> DataType: return DataType(Type.UINT16)
def Int16() -> DataType: return DataType(Type.INT16)
def UInt32() -> DataType: return DataType(Type.UINT32)
def Int32() -> DataType: return DataType(Type.INT32)
def UInt64() -> DataType: return DataType(Type.UINT64)
def Int64() -> DataType: return DataType(Type.INT64)
def HalfFloat() -> DataType: return DataType(Type.HALF_FLOAT)
def Float() -> DataType: return DataType(Type.FLOAT)
def Double() -> DataType: return DataType(Type.DOUBLE)
def String() -> DataType: return DataType(Type.STRING, Layout.VARIABLE_WIDTH)
def Binary() -> DataType: return DataType(Type.BINARY, Layout.VARIABLE_WIDTH)
def Date32() -> DataType: return DataType(Type.DATE32)
def Date64() -> DataType: return DataType(Type.DATE64)


def Timestamp(unit: TimeUnit = TimeUnit.MICRO) -> DataType:
    return DataType(Type.TIMESTAMP, Layout.FIXED_WIDTH, unit)


def Duration(unit: TimeUnit = TimeUnit.MICRO) -> DataType:
    return DataType(Type.DURATION, Layout.FIXED_WIDTH, unit)


def FixedSizeBinary(byte_width: int) -> DataType:
    return DataType(Type.FIXED_SIZE_BINARY, Layout.FIXED_WIDTH, None, byte_width)


def from_np_dtype(dt) -> DataType:
    """Infer a cylon DataType from a numpy dtype."""
    dt = np.dtype(dt)
    if dt in _NP_TO_TYPE:
        return DataType(_NP_TO_TYPE[dt])
    if dt.kind in ("U", "S", "O"):
        return String()
    if dt.kind == "M":
        return Timestamp(TimeUnit.NANO)
    if dt.kind == "m":
        return Duration(TimeUnit.NANO)
    raise TypeError(f"unsupported numpy dtype {dt}")


_NP_TO_TORCH: dict[np.dtype, torch.dtype] = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}

_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}

# same-width signed containers: torch implements arithmetic, gathers and
# sorts for these on every device, so unsigned and floating data are
# moved and compared as their bit patterns in one of them
_SIGNED_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return _TORCH_TO_NP[dt]


def np_name(dt: torch.dtype) -> str:
    """The numpy name of a torch dtype ("int32", "float64", "bool", ...):
    the spelling of the co-partitioning witness and of the plan layer's
    type strings, the JAX package's own."""
    return str(_TORCH_TO_NP[dt])


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return _NP_TO_TORCH[np.dtype(dt)]


def bits_container(dt: torch.dtype) -> torch.dtype:
    """The signed (uint8 for one byte) dtype of the same width, used to
    carry a value's raw bits."""
    return _SIGNED_OF_WIDTH[torch.empty((), dtype=dt).element_size()]


def movable(x: torch.Tensor) -> torch.Tensor:
    """``x``, or for uint16/32/64 its bits in the signed container: torch
    has no gather for those dtypes (view the result back with
    ``.view(x.dtype)``)."""
    if x.dtype in (torch.uint16, torch.uint32, torch.uint64):
        return x.view(bits_container(x.dtype))
    return x
