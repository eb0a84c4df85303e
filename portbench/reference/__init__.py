"""The plain reference of each query kind, one module an ``op``
(``reference/<op>.py``), in plain PyTorch. It imports nothing of the
program and takes only the tables the generator made: the same inputs
the program is given.

Each module has ``compute(tables, query, low=None)``, returning
``(columns, scales, stats)``: the result's columns in the program's
column order, for each column the scale a float column's gap is
measured against (None for a column compared exactly), and counts the
roofline readers use. ``low`` names a float dtype: the control, the
same computation with every float in that lower precision.
"""
from __future__ import annotations

import importlib


def module(op: str):
    return importlib.import_module(f"{__name__}.{op}")


def column(cols, name: str):
    for c, x in cols:
        if c == name:
            return x
    raise KeyError(name)


def lowered(x, low):
    """``x`` computed in the lower float dtype ``low`` and read back."""
    if low is None or not x.is_floating_point():
        return x
    import torch

    return x.to(getattr(torch, low)).to(x.dtype)
