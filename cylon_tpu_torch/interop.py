"""Carry a cylon_tpu table's state into the port, from numpy arrays only.

``from_reference_arrays`` is the counterpart of loading weights: given
the host copies of a cylon_tpu table's column arrays (string columns
as their codes and vocabulary, or their varbytes buffers), validity
masks and row mask — including a *distributed* table after
``cylon_tpu.parallel.shard.distribute``, with its padded per-shard layout
and its emit mask — it builds a port Table that holds the same state. It
takes numpy arrays, never a cylon_tpu object, so the port imports
nothing of the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .context import CylonContext
from .data.column import Column
from .data.table import Table
from .status import Code, CylonError


def from_reference_arrays(ctx: CylonContext, columns: Sequence[np.ndarray],
                          validity: Sequence[Optional[np.ndarray]],
                          row_mask: Optional[np.ndarray], world: int = 1,
                          names: Optional[Sequence[str]] = None) -> Table:
    """A port Table from a reference table's arrays.

    ``columns[i]``/``validity[i]`` are column i's data and validity (None
    = all valid), ``row_mask`` the table's row mask (None = all live).
    ``world`` > 1 declares the arrays to be the flat ``[world * cap]``
    layout of a distributed table; it must equal the context's world
    size.

    A string column is a dict: ``{"codes", "dictionary"}`` for a
    dictionary column (int32 codes, the sorted vocabulary), or
    ``{"words", "starts", "lengths", "max_words", "total_words",
    "stride", "shard_geom"}`` for a varbytes column (words as uint32 or
    int32 bits), either with an optional ``"binary": True``."""
    if world > 1 and world != ctx.get_world_size():
        raise CylonError(Code.Invalid,
                         f"arrays of a world-{world} table, context world "
                         f"{ctx.get_world_size()}")
    names = list(names) if names is not None \
        else [f"c{i}" for i in range(len(columns))]
    cols = []
    for name, data, valid in zip(names, columns, validity):
        if isinstance(data, dict):
            c = _string_column(ctx, name, data)
            if valid is not None:
                c.validity = torch.from_numpy(np.array(valid, dtype=bool)).to(
                    ctx.device)
            cols.append(c)
            continue
        data = np.asarray(data)
        # an all-valid mask: the state is carried as it is, a NaN stays a
        # value (from_numpy would read it as a null)
        c = Column.from_numpy(data, name, np.ones(len(data), dtype=bool),
                              ctx.device)
        if valid is not None:
            c.validity = torch.from_numpy(np.array(valid, dtype=bool)).to(
                ctx.device)
        cols.append(c)
    n = len(cols[0]) if cols else 0
    if world > 1 and n % world:
        raise CylonError(Code.Invalid,
                         f"{n} rows do not split into {world} equal shards")
    mask = None if row_mask is None else torch.from_numpy(
        np.array(row_mask, dtype=bool)).to(ctx.device)
    t = Table(cols, ctx, mask)
    if world > 1:
        t._shard_world = world
    return t


def _string_column(ctx: CylonContext, name: str, spec: dict) -> Column:
    from . import dtypes
    from .data.strings import VarBytes

    dt = dtypes.Binary() if spec.get("binary") else dtypes.String()

    def dev(x, np_dtype):  # a writable copy for torch
        return torch.from_numpy(np.array(np.asarray(x).view(np_dtype))).to(
            ctx.device)

    if "codes" in spec:
        return Column(dev(np.asarray(spec["codes"]).astype(np.int32),
                          np.int32), dt, None, name,
                      dictionary=np.asarray(spec["dictionary"]))
    geom = spec.get("shard_geom")
    vb = VarBytes(dev(spec["words"], np.int32), dev(spec["starts"], np.int32),
                  dev(spec["lengths"], np.int32), int(spec["max_words"]),
                  int(spec["total_words"]),
                  shard_geom=None if geom is None else tuple(
                      int(g) for g in geom),
                  stride=spec.get("stride"))
    return Column.from_varbytes(vb, None, name, dt)
