"""Row — a cursor over a Table with typed getters (counterpart of
cylon_tpu.data.row).

Reference: cpp/src/cylon/row.hpp:23-51, used by ``Table.select``'s row
lambda. Host-side by design: row access is the slow path of a columnar
engine; masks are the fast path.
"""
from __future__ import annotations


class Row:
    def __init__(self, table, index: int, _cache=None):
        self._table = table
        self._index = index
        self._cache = _cache or [c.to_numpy() for c in table._columns]

    def get(self, col: int):
        return self._cache[col][self._index]

    def __getitem__(self, col):
        if isinstance(col, str):
            col = self._table.column_names.index(col)
        return self.get(col)

    # typed getters (row.hpp parity)
    def get_bool(self, col: int) -> bool: return bool(self.get(col))
    def get_int8(self, col: int) -> int: return int(self.get(col))
    def get_uint8(self, col: int) -> int: return int(self.get(col))
    def get_int16(self, col: int) -> int: return int(self.get(col))
    def get_uint16(self, col: int) -> int: return int(self.get(col))
    def get_int32(self, col: int) -> int: return int(self.get(col))
    def get_uint32(self, col: int) -> int: return int(self.get(col))
    def get_int64(self, col: int) -> int: return int(self.get(col))
    def get_uint64(self, col: int) -> int: return int(self.get(col))
    def get_half_float(self, col: int) -> float: return float(self.get(col))
    def get_float(self, col: int) -> float: return float(self.get(col))
    def get_double(self, col: int) -> float: return float(self.get(col))
    def get_string(self, col: int) -> str: return str(self.get(col))
