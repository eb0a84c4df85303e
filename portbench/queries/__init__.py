"""The program's side of each query kind, one module an ``op``
(``queries/<op>.py``): ``run(tables, query)`` calls the port's public
API on the tables the harness ingested ({name: Table}) and returns its
result table, as a user's program would."""
from __future__ import annotations

import importlib


def module(op: str):
    return importlib.import_module(f"{__name__}.{op}")
