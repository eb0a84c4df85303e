"""The benchmark's byte count of the set ops' hash stage (kernel K9,
``portbench/rooflines/setop_hash_rows.py``) on the cells' own statistics:
the union cell's 2 x 1e8 rows of an int64 and a float64 column move 44
bytes a row, and the join and the group-by have no such stage."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parent.parent / "portbench"


def cell_stats(cell):
    """The statistics a run of ``cell`` gives its rooflines, from the
    cell's files: the query, and each table's rows and bytes a row of
    each column (a string column counted at its digits' width)."""
    wl = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{wl['config']}.json")
                     .read_text())

    def width(c):
        return c.get("digits", 0) + len(c.get("prefix", "")) \
            if c["dtype"] == "string" else np.dtype(c["dtype"]).itemsize

    tables = {name: {"rows": t["rows"],
                     "columns": {c: width(d) for c, d in
                                 t["columns"].items()}}
              for name, t in cfg["tables"].items()}
    q = wl["query"]
    return {"op": q["op"], "query": q, "tables": tables}


def roofline():
    return harness.roofline_modules()["setop_hash_rows"]


def test_union_cell_stage_bytes():
    """(8 + 8) column bytes + 4 x (1 + 4) stack words + 2 x 4 hash
    bytes = 44 bytes a row, over 2e8 rows."""
    assert roofline().stage_bytes(cell_stats("cylon_union_200m.union")) \
        == 8_800_000_000


@pytest.mark.parametrize("cell", ["cylon_join_200m.inner",
                                  "h2o_groupby_1e8.q5"])
def test_no_stage_outside_the_union(cell):
    assert roofline().stage_bytes(cell_stats(cell)) is None


def test_symbol_is_listed():
    """K9's device symbol reaches the trace's kernel list, so its time
    never counts as a torch op."""
    assert harness.kernel_symbols()["setop_hash_rows"] == [
        r"(^|[\s:])setop_hash_rows_kernel\("]
