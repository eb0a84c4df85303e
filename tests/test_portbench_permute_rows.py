"""The benchmark's byte count of the stream routes' sort stage (kernel
K10, ``portbench/rooflines/permute_rows.py``) on the cells' own
statistics: the join cell moves 48 bytes a row (an index and five
words), the union cell 64 (an index and seven words), and the group-by
and a join on one int32 key have no such count."""
import copy

import pytest

from portbench import harness
from test_portbench_setop_hash_rows import cell_stats


def roofline():
    return harness.roofline_modules()["permute_rows"]


@pytest.mark.parametrize("cell,expect", [
    ("cylon_join_200m.inner", 9_600_000_000),
    ("cylon_union_200m.union", 12_800_000_000)])
def test_cell_stage_bytes(cell, expect):
    assert roofline().stage_bytes(cell_stats(cell)) == expect


def test_join_payload_lanes_count():
    """A 4-byte payload column of the wider side rides as a lane: one
    more word a row."""
    stats = copy.deepcopy(cell_stats("cylon_join_200m.inner"))
    stats["tables"]["right"]["columns"]["x"] = 4
    assert roofline().stage_bytes(stats) == 2e8 * (8 + 8 * 6)


def test_no_stage_without_records():
    assert roofline().stage_bytes(cell_stats("h2o_groupby_1e8.q5")) is None
    stats = copy.deepcopy(cell_stats("cylon_join_200m.inner"))
    for side in ("left", "right"):
        stats["tables"][side]["columns"]["k"] = 4
    assert roofline().stage_bytes(stats) is None


def test_symbol_is_listed():
    """K10's device symbol (a template: its record width and rows a
    thread) reaches the trace's kernel list, so its time never counts as
    a torch op."""
    import re

    pattern = harness.kernel_symbols()["permute_rows"]
    assert pattern == [r"(^|[\s:])permute_rows_kernel<"]
    assert re.search(pattern[0], "void (anonymous namespace)::"
                     "permute_rows_kernel<2, 4>((anonymous namespace)::Args)")
