"""Column — a typed, device-resident column with an optional validity mask
(counterpart of cylon_tpu.data.column).

Reference: cpp/src/cylon/column.hpp:31-113. Fixed-width data is ONE dense
torch tensor on the context's device; nullability is a separate bool
tensor (absent means all valid). STRING/BINARY columns are stored one of
two ways, chosen at ingest as the JAX package chooses:

* dictionary: a *sorted* host vocabulary (numpy array of str) and int32
  codes on the device, so code order is lexicographic order and sorts,
  joins and groupbys on such strings are integer ops. Cross-table ops
  unify the vocabularies on the host (``unify_dictionaries``);
* varbytes (data/strings.py): the bytes live on the device, word-aligned;
  ``data`` then holds the byte lengths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import dtypes
from ..dtypes import DataType, Type
from ..status import Code, CylonError


class Column:
    def __init__(self, data: torch.Tensor, dtype: DataType, validity=None,
                 name: str = "", dictionary=None, varbytes=None):
        self.data = data              # tensor [n] (codes for a dictionary
        #                               string, byte lengths for varbytes)
        self.dtype = dtype
        self.validity = validity      # bool tensor [n] (True = valid) or None
        self.name = name
        self.dictionary = dictionary  # sorted numpy vocabulary, or None
        self.varbytes = varbytes      # strings.VarBytes, or None

    # -- construction --

    @staticmethod
    def from_numpy(arr: np.ndarray, name: str = "",
                   validity: Optional[np.ndarray] = None,
                   device="cpu") -> "Column":
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            return Column._encode_strings(arr, name, validity, device)
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

    @staticmethod
    def _encode_strings(arr: np.ndarray, name: str,
                        validity: Optional[np.ndarray], device) -> "Column":
        """The ingest policy: a small vocabulary is dictionary-encoded,
        anything else (or any bytes value: BINARY) becomes varbytes. A
        chunked distinct probe bails out early, so the varbytes case never
        pays np.unique's host string sort."""
        from . import strings

        obj = arr.astype(object)
        if validity is None:
            validity = np.array([v is not None and v == v for v in obj],
                                dtype=bool)
        validity = np.asarray(validity, dtype=bool)
        safe = np.array([v if ok else "" for v, ok in zip(obj, validity)],
                        dtype=object)
        n = len(obj)
        thresh = min(strings.DICT_MAX_VOCAB,
                     max(16, int(n * strings.DICT_MAX_RATIO)))
        mask = _dev_mask(validity, device)

        def varbytes(binary: bool) -> "Column":
            vb = strings.VarBytes.from_host(safe, device=device)
            return Column.from_varbytes(vb, mask, name,
                                        dtypes.Binary() if binary else None)

        seen: set = set()
        for lo in range(0, n, 1 << 16):
            chunk = safe[lo: lo + (1 << 16)]
            seen.update(chunk)
            if any(isinstance(v, bytes) for v in chunk):
                return varbytes(True)
            if len(seen) > thresh:
                return varbytes(any(isinstance(v, bytes)
                                    for v in safe[lo + (1 << 16):]))
        vocab, codes = np.unique(safe.astype(str), return_inverse=True)
        return Column(torch.from_numpy(codes.reshape(-1).astype(np.int32)).to(
            device), dtypes.String(), mask, name, dictionary=vocab)

    @staticmethod
    def from_varbytes(vb, validity=None, name: str = "",
                      dtype: Optional[DataType] = None) -> "Column":
        """Wrap device varbytes storage; ``data`` carries the byte
        lengths so the generic row plumbing works."""
        return Column(vb.lengths, dtype or dtypes.String(), validity, name,
                      varbytes=vb)

    @staticmethod
    def from_pyarrow(pa_arr, name: str = "", device="cpu") -> "Column":
        """Build from a pyarrow Array/ChunkedArray (chunks combined).
        String and binary arrays of high cardinality (and all binary
        arrays) build varbytes straight from the Arrow buffers."""
        import pyarrow as pa
        import pyarrow.compute as pac

        from . import strings

        if isinstance(pa_arr, pa.ChunkedArray):
            pa_arr = pa_arr.combine_chunks() if pa_arr.num_chunks \
                else pa.array([], type=pa_arr.type)
        t = pa_arr.type
        nulls = pa_arr.null_count > 0
        if pa.types.is_dictionary(t):
            return Column.from_pyarrow(pa_arr.dictionary_decode(), name,
                                       device)
        is_bin = pa.types.is_binary(t) or pa.types.is_large_binary(t)
        if is_bin or pa.types.is_string(t) or pa.types.is_large_string(t):
            n = len(pa_arr)
            nuniq = pac.count_distinct(pa_arr).as_py() if n else 0
            if is_bin or nuniq > min(strings.DICT_MAX_VOCAB,
                                     max(16, int(n * strings.DICT_MAX_RATIO))):
                validity = None
                if nulls:
                    validity = np.asarray(pa_arr.is_valid())
                    pa_arr = pac.fill_null(pa_arr, b"" if is_bin else "")
                bufs = pa_arr.buffers()
                large = pa.types.is_large_string(t) \
                    or pa.types.is_large_binary(t)
                offsets = np.frombuffer(bufs[1], np.int64 if large
                                        else np.int32)[
                    pa_arr.offset: pa_arr.offset + n + 1]
                data = bufs[2].to_pybytes() if bufs[2] is not None else b""
                vb = strings.VarBytes.from_arrow_buffers(offsets, data,
                                                         device)
                return Column.from_varbytes(
                    vb, _dev_mask(validity, device), name,
                    dtypes.Binary() if is_bin else None)
            np_obj = pa_arr.to_numpy(zero_copy_only=False)
            validity = np.array([v is not None for v in np_obj]) \
                if nulls else None
            return Column._encode_strings(np.asarray(np_obj, dtype=object),
                                          name, validity, device)
        np_arr = pa_arr.to_numpy(zero_copy_only=False)
        validity = None
        if nulls:
            validity = np.asarray(pa_arr.is_valid())
            if np_arr.dtype.kind == "f":
                np_arr = np.nan_to_num(np_arr)  # finite data where null
            elif np_arr.dtype == object:
                np_arr = np.array([v if ok else 0
                                   for v, ok in zip(np_arr, validity)])
        return Column.from_numpy(np_arr, name, validity, device)

    # -- properties --

    def __len__(self) -> int:
        return int(self.data.shape[0])

    @property
    def is_string(self) -> bool:
        return self.dictionary is not None or self.varbytes is not None

    @property
    def is_varbytes(self) -> bool:
        return self.varbytes is not None

    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return int((~self.validity).sum())

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.data.shape[0], dtype=torch.bool,
                              device=self.data.device)
        return self.validity

    # -- transforms --

    def take(self, indices: torch.Tensor) -> "Column":
        """Gather rows; negative indices produce NULL rows (the reference's
        -1 -> null gather, util/copy_arrray.cpp:16-287)."""
        idx = torch.as_tensor(indices, device=self.data.device).to(
            torch.int64)
        neg = idx < 0
        if self.data.shape[0] == 0 and not self.is_varbytes:
            return Column(torch.zeros(idx.shape, dtype=self.data.dtype,
                                      device=idx.device),
                          self.dtype, torch.zeros_like(neg), self.name,
                          dictionary=self.dictionary)
        safe = torch.where(neg, 0, idx)
        if self.data.shape[0] == 0:
            validity = torch.zeros_like(neg)
        else:
            validity = self.valid_mask()[safe] & ~neg
        if self.is_varbytes:
            vb = self.varbytes.take(idx)  # negatives -> empty rows
            return Column(vb.lengths, self.dtype, validity, self.name,
                          varbytes=vb)
        return Column(self.data[safe], self.dtype, validity, self.name,
                      dictionary=self.dictionary)

    def slice(self, start: int, stop: int) -> "Column":
        v = None if self.validity is None else self.validity[start:stop]
        if self.is_varbytes:
            vb = self.varbytes.slice(start, stop)
            return Column(vb.lengths, self.dtype, v, self.name, varbytes=vb)
        return Column(self.data[start:stop], self.dtype, v, self.name,
                      dictionary=self.dictionary)

    def rename(self, name: str) -> "Column":
        return Column(self.data, self.dtype, self.validity, name,
                      dictionary=self.dictionary, varbytes=self.varbytes)

    def with_validity(self, validity) -> "Column":
        """The same column with another validity mask."""
        return Column(self.data, self.dtype, validity, self.name,
                      dictionary=self.dictionary, varbytes=self.varbytes)

    def astype(self, dtype: DataType) -> "Column":
        """Value cast to ``dtype`` (validity kept)."""
        if self.is_string or self.dtype.is_var_width() \
                or dtype.is_var_width():
            raise CylonError(Code.TypeError, "cannot cast string column")
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
        mask = self._host_mask()
        if self.is_varbytes:
            out = self.varbytes.to_host(as_str=self.dtype.type != Type.BINARY)
            if mask is not None:
                out[~mask] = None
            return out
        data = self.data.cpu().numpy()
        if self.dictionary is not None:
            out = self.dictionary[data].astype(object)
            if mask is not None:
                out[~mask] = None
            return out
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

    def to_pyarrow(self):
        import pyarrow as pa

        valid = self._host_mask()
        mask = None if valid is None else ~valid
        if self.is_varbytes:
            if self.dtype.type == Type.BINARY:
                return pa.array(self.varbytes.to_host(as_str=False),
                                type=pa.binary(), mask=mask)
            return pa.array(self.varbytes.to_host(), type=pa.string(),
                            mask=mask)
        data = self.data.cpu().numpy()
        if self.dictionary is not None:
            return pa.array(self.dictionary[data], type=pa.string(),
                            mask=mask)
        return pa.array(data, mask=mask)


def as_varbytes(col: Column) -> Column:
    """Lift a string column to varbytes storage: a dictionary column
    builds its (small) vocabulary's VarBytes once, then one varlen
    gather by the codes."""
    from .strings import VarBytes

    if col.is_varbytes:
        return col
    if not col.is_string:
        raise CylonError(Code.TypeError, "as_varbytes needs a string column")
    vb = VarBytes.from_host(col.dictionary, device=col.data.device).take(
        col.data)
    return Column(vb.lengths, col.dtype, col.validity, col.name, varbytes=vb)


def align_string_columns(a: Column, b: Column) -> Tuple[Column, Column]:
    """Make two string columns comparable on the device: if either side
    is varbytes, lift both; two dictionary columns unify vocabularies."""
    if a.is_varbytes or b.is_varbytes:
        return as_varbytes(a), as_varbytes(b)
    return unify_dictionaries(a, b)


def string_key_arrays(col: Column, k_words: Optional[int] = None):
    """Key arrays standing in for one string key column, as (keys,
    valids, raw) lists ready to extend a join/groupby key list:

    * varbytes, short (<= EXACT_KEY_WORDS words, at least ``k_words``
      lanes so two joined columns emit aligned lanes): the raw word lanes
      plus the byte length — byte-exact;
    * varbytes, long: the (h1, h2, h3, len) content-hash identity;
    * dictionary: the codes.

    ``raw`` True marks arrays that already are the key bits (the JAX
    package's string flag: no ordered-bits transform)."""
    from .strings import EXACT_KEY_WORDS

    if col.is_varbytes:
        vb = col.varbytes
        k = vb.max_words if k_words is None \
            else max(int(k_words), vb.max_words)
        ks = vb.word_lanes(k) + [vb.lengths] if k <= EXACT_KEY_WORDS \
            else list(vb.hash_keys())
        return ks, [col.validity] + [None] * (len(ks) - 1), [True] * len(ks)
    return [col.data], [col.validity], [True]


def unify_dictionaries(a: Column, b: Column) -> Tuple[Column, Column]:
    """Re-encode two dictionary string columns onto one shared sorted
    vocabulary, so their codes compare directly: O(|vocab|) on the host,
    one gather per column on the device."""
    if not (a.dictionary is not None and b.dictionary is not None):
        raise CylonError(Code.TypeError,
                         "unify_dictionaries needs dictionary columns")
    if a.dictionary.shape == b.dictionary.shape and \
            (a.dictionary == b.dictionary).all():
        return a, b
    union = np.union1d(a.dictionary, b.dictionary)
    return remap_dictionary(a, union), remap_dictionary(b, union)


def remap_dictionary(col: Column, vocab: np.ndarray) -> Column:
    """``col``'s codes re-expressed in ``vocab`` (a sorted superset of its
    own vocabulary)."""
    if col.dictionary is vocab:
        return col
    m = torch.from_numpy(np.searchsorted(vocab, col.dictionary).astype(
        np.int32)).to(col.data.device)
    data = m[col.data.to(torch.int64)] if len(m) \
        else torch.zeros_like(col.data)
    return Column(data, col.dtype, col.validity, col.name, dictionary=vocab)


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
