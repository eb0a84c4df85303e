"""The one general generator: a configuration's tables, drawn on the
device from the seed.

A configuration file lists its tables, each with a row count and its
columns in order; a column names its dtype and its distribution:

* ``{"dist": "uniform_int", "low": a, "high": b}``: integers in [a, b).
* ``{"dist": "uniform_float", "low": a, "high": b, "decimals": d}``:
  floats in [a, b), rounded to ``d`` decimals when ``d`` is given.
* ``{"dtype": "string", "dist": "uniform_int", "low": a, "high": b,
  "prefix": p, "digits": d}``: the strings ``p`` followed by an integer
  of [a, b) written with ``d`` digits, zero-padded (``sprintf("id%03d")``
  of db-benchmark's generator is prefix "id", 3 digits). Every value has
  the same width, so the values' order is their integers' order.

One ``torch.Generator`` on the device, seeded with the run's seed,
draws every column in file order, one call a column, so a seed gives
the same tables on every run and every process. Nothing here imports
the program.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

import torch

DTYPES = {"int32": torch.int32, "int64": torch.int64,
          "float32": torch.float32, "float64": torch.float64}

# {table: [(column, a tensor, or Strings for a string column)]}
Tables = Dict[str, List[Tuple[str, object]]]


@dataclass
class Strings:
    """A string column as drawn: the integer of each row (``values``,
    int32) and how it is written, ``prefix`` then ``digits`` digits; the
    integers lie in [low, high). The port's table is built from it on
    the device (``vocab`` and ``utf8``), with no string made on the host
    a row."""
    values: torch.Tensor
    prefix: str
    digits: int
    low: int
    high: int

    @staticmethod
    def draw(spec: dict, n: int, g: torch.Generator, device) -> "Strings":
        if spec["dist"] != "uniform_int":
            raise ValueError(f"a string column draws uniform_int: {spec}")
        low, high = int(spec["low"]), int(spec["high"])
        if low < 0 or high > 10 ** int(spec["digits"]):
            raise ValueError(f"{spec}: a value needs more digits")
        return Strings(torch.randint(low, high, (n,), generator=g,
                                     device=device, dtype=torch.int32),
                       str(spec["prefix"]), int(spec["digits"]), low, high)

    def __len__(self) -> int:
        return len(self.values)

    def __getitem__(self, rows: slice) -> "Strings":
        return replace(self, values=self.values[rows])

    @property
    def width(self) -> int:
        return len(self.prefix.encode()) + self.digits

    def vocab(self) -> List[str]:
        """Every value the column can hold, in order."""
        return [f"{self.prefix}{v:0{self.digits}d}"
                for v in range(self.low, self.high)]

    def utf8(self, pad_to: int = 1) -> torch.Tensor:
        """The rows' bytes as a uint8 tensor [rows, width rounded up to
        ``pad_to``], zero past the width."""
        n, p = len(self.values), len(self.prefix.encode())
        out = torch.zeros((n, -(-self.width // pad_to) * pad_to),
                          dtype=torch.uint8, device=self.values.device)
        out[:, :p] = torch.tensor(list(self.prefix.encode()),
                                  dtype=torch.uint8, device=out.device)
        v = self.values.to(torch.int64)
        for k in range(self.digits):
            out[:, p + self.digits - 1 - k] = (v % 10 + 48).to(torch.uint8)
            v = v // 10
        return out


def _draw(spec: dict, n: int, g: torch.Generator, device):
    if spec["dtype"] == "string":
        return Strings.draw(spec, n, g, device)
    dt = DTYPES[spec["dtype"]]
    dist = spec["dist"]
    if dist == "uniform_int":
        x = torch.randint(int(spec["low"]), int(spec["high"]), (n,),
                          generator=g, device=device, dtype=torch.int64)
    elif dist == "uniform_float":
        x = torch.rand(n, generator=g, device=device, dtype=torch.float64)
        x = x * (float(spec["high"]) - float(spec["low"])) \
            + float(spec["low"])
        if "decimals" in spec:
            scale = 10.0 ** int(spec["decimals"])
            x = torch.round(x * scale) / scale
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return x.to(dt)


def make_tables(config: dict, seed: int, device) -> Tables:
    """Every table of ``config`` in full: {table: [(column, tensor)]}."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out: Tables = {}
    for tname, t in config["tables"].items():
        n = int(t["rows"])
        out[tname] = [(cname, _draw(c, n, g, device))
                      for cname, c in t["columns"].items()]
    return out


def rank_slice(tables: Tables, rank: int, nproc: int) -> Tables:
    """Process ``rank``'s contiguous share of every table's rows."""
    out: Tables = {}
    for tname, cols in tables.items():
        n = len(cols[0][1])
        lo, hi = n * rank // nproc, n * (rank + 1) // nproc
        out[tname] = [(c, x[lo:hi]) for c, x in cols]
    return out


