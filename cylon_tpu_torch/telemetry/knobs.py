"""The declared ``CYLON_*`` environment-knob registry (counterpart of
cylon_tpu.telemetry.knobs, with the same parse policy, names, defaults
and floors).

Every knob the port reads is declared here and read through :func:`get`.
Reads are live (each :func:`get` consults ``os.environ``), so a knob may
be flipped at any time; nothing is latched at import. Only the knobs the
port reads are declared.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

_TRUTHY = ("1", "true", "yes", "on")
_FALSY = ("0", "false", "no", "off")


def parse_number(raw: Optional[str], default, lo=None,
                 as_int: bool = False):
    """The numeric parse policy: ``None`` or malformed reads as
    ``default``, ``lo`` floors the result."""
    if raw is None:
        return default
    try:
        v = int(raw) if as_int else float(raw)
    except ValueError:
        return default
    return max(v, lo) if lo is not None else v


@dataclass(frozen=True)
class Knob:
    """One declared environment knob: ``kind`` is ``int`` / ``float`` /
    ``bool`` / ``str``; unset or malformed values read as ``default``;
    ``lo`` floors numeric values."""

    name: str
    default: object
    kind: str
    doc: str
    lo: Optional[float] = None

    def parse(self, raw: Optional[str]):
        if raw is None:
            return self.default
        if self.kind == "str":
            return raw
        if self.kind == "bool":
            v = raw.strip().lower()
            if v in _TRUTHY:
                return True
            if v in _FALSY:
                return False
            return self.default
        return parse_number(raw, self.default, lo=self.lo,
                            as_int=self.kind == "int")

    def get(self):
        return self.parse(os.environ.get(self.name))


# name -> Knob, in declaration order
KNOBS: "Dict[str, Knob]" = {}


def declare(name: str, default, kind: str, doc: str,
            lo: Optional[float] = None) -> Knob:
    """Register one knob; declaring a name twice is an error."""
    if kind not in ("int", "float", "bool", "str"):
        raise ValueError(f"knob {name!r}: unknown kind {kind!r}")
    if name in KNOBS:
        raise ValueError(f"knob {name!r} already declared")
    k = Knob(name, default, kind, doc, lo)
    KNOBS[name] = k
    return k


def _require(name: str) -> Knob:
    k = KNOBS.get(name)
    if k is None:
        raise KeyError(f"{name!r} is not a declared knob; declared: "
                       f"{sorted(KNOBS)}")
    return k


def get(name: str):
    """The current value of a declared knob (a live ``os.environ`` read;
    unset or malformed -> the declared default)."""
    return _require(name).get()


def default(name: str):
    """A declared knob's default."""
    return _require(name).default


declare("CYLON_SKEW_WARN_FACTOR", 2.0, "float",
        "exchange imbalance factor (max/mean destination rows) beyond "
        "which a destination counts as hot for the salted shuffle",
        lo=1.0)
declare("CYLON_EXCHANGE_OVERLAP", True, "bool",
        "chunk the padded-mode exchange into CYLON_EXCHANGE_CHUNK_BYTES "
        "pieces; 0 runs the single-shot exchange")
declare("CYLON_EXCHANGE_CHUNK_BYTES", 1 << 26, "int",
        "target payload bytes per exchange chunk and per shard (across "
        "all destinations); the chunk block is pow2-floored from it and "
        "the chunk count is capped at MAX_CHUNKS per exchange",
        lo=1 << 12)
declare("CYLON_SALT_FACTOR", 4, "int",
        "hot-key salting spread of the salted shuffle: each hot "
        "destination's rows split across this many consecutive shards "
        "(pow2-floored); 0 or 1 disables salting", lo=0)
