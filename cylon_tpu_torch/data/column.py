"""Column — a typed, device-resident column with an optional validity mask
(counterpart of cylon_tpu.data.column).

Reference: cpp/src/cylon/column.hpp:31-113. Fixed-width data is ONE dense
torch tensor on the context's device; nullability is a separate bool
tensor (absent means all valid). STRING/BINARY columns, dictionary-encoded
or varbytes in the JAX package, are not ported yet and raise a typed
error where they would be built.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import dtypes
from ..dtypes import DataType, Type
from ..status import Code, CylonError, not_ported


class Column:
    def __init__(self, data: torch.Tensor, dtype: DataType, validity=None,
                 name: str = ""):
        self.data = data          # tensor [n]
        self.dtype = dtype
        self.validity = validity  # bool tensor [n] (True = valid) or None
        self.name = name

    # -- construction --

    @staticmethod
    def from_numpy(arr: np.ndarray, name: str = "",
                   validity: Optional[np.ndarray] = None,
                   device="cpu") -> "Column":
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            raise not_ported("string columns")
        if arr.dtype.kind in ("M", "m"):
            unit = np.datetime_data(arr.dtype)[0]
            dt = (dtypes.Timestamp if arr.dtype.kind == "M"
                  else dtypes.Duration)(_np_unit(unit))
            arr = arr.astype("int64")
        else:
            if arr.dtype.kind == "f" and validity is None \
                    and np.isnan(arr).any():
                # pandas-style: NaN means null for float columns from host
                validity = ~np.isnan(arr)
            dt = dtypes.from_np_dtype(arr.dtype)
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # torch wants a writable buffer
            arr = arr.copy()
        data = torch.from_numpy(arr).to(device)
        return Column(data, dt, _dev_mask(validity, device), name)

    # -- properties --

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.validity

    # -- transforms --

    def take(self, indices: torch.Tensor) -> "Column":
        """Gather rows; negative indices produce NULL rows (the reference's
        -1 -> null gather, util/copy_arrray.cpp:16-287)."""
        idx = indices.to(torch.int64)
        neg = idx < 0
        if self.data.shape[0] == 0:
            return Column(torch.zeros(idx.shape, dtype=self.data.dtype,
                                      device=idx.device),
                          self.dtype, torch.zeros_like(neg), self.name)
        safe = torch.where(neg, 0, idx)
        validity = self.valid_mask()[safe] & ~neg
        return Column(self.data[safe], self.dtype, validity, self.name)

    def rename(self, name: str) -> "Column":
        return Column(self.data, self.dtype, self.validity, name)

    def astype(self, dtype: DataType) -> "Column":
        """Value cast to ``dtype`` (validity kept)."""
        if self.dtype.is_var_width() or dtype.is_var_width():
            raise not_ported("string columns")
        return Column(self.data.to(dtypes.torch_dtype(dtype.np_dtype)), dtype,
                      self.validity, self.name)

    # -- export --

    def _host_mask(self) -> Optional[np.ndarray]:
        """Validity as a host array, collapsing all-True to None."""
        if self.validity is None:
            return None
        mask = self.validity.cpu().numpy()
        return None if mask.all() else mask

    def to_numpy(self) -> np.ndarray:
        data = self.data.cpu().numpy()
        mask = self._host_mask()
        if mask is not None:
            if data.dtype.kind == "f":
                out = data.copy()
                out[~mask] = np.nan
                return out
            out = data.astype(object)
            out[~mask] = None
            return out
        if self.dtype.is_temporal():
            unit = _unit_str(self.dtype.unit)
            if self.dtype.type == Type.TIMESTAMP:
                return data.astype(f"datetime64[{unit}]")
            if self.dtype.type == Type.DURATION:
                return data.astype(f"timedelta64[{unit}]")
        return data


def _dev_mask(validity: Optional[np.ndarray], device):
    if validity is None:
        return None
    v = np.array(validity, dtype=bool)  # a writable copy for torch
    if v.all():
        return None
    return torch.from_numpy(v).to(device)


def _np_unit(unit: str):
    from ..dtypes import TimeUnit

    try:
        return {"s": TimeUnit.SECOND, "ms": TimeUnit.MILLI,
                "us": TimeUnit.MICRO, "ns": TimeUnit.NANO}[unit]
    except KeyError:
        raise CylonError(Code.TypeError, f"unsupported time unit {unit!r}")


def _unit_str(unit) -> str:
    from ..dtypes import TimeUnit

    if unit is None:
        return "us"
    return {TimeUnit.SECOND: "s", TimeUnit.MILLI: "ms",
            TimeUnit.MICRO: "us", TimeUnit.NANO: "ns"}[unit]
