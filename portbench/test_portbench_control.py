"""The comparison fails what it must: the control (the reference in the
next lower precision, in the program's place) and each fault a cell can
have, planted where the answer is produced, come out not correct; sound
runs come out correct. The control's readings at the cells' own size
come from ``control.py`` on the card (PERF.md)."""
import pytest

from portbench import check, control, testing

CELLS = ["cylon_join_200m.inner", "h2o_groupby_1e8.q5"]
SEEDS = [2 ** 31 + 201, 2 ** 31 + 202, 2 ** 31 + 203]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return testing.tiny_checkout(tmp_path_factory.mktemp("c"), rows=8192)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_program_passes(root, cell):
    for r in control.readings(cell, SEEDS, device="cpu", root=root):
        assert check.verdict(r["program"], r["limits"]), r
        assert not check.verdict(r["control"], r["limits"]), r


ALTER = """
from portbench.queries import {op} as Q
_orig = Q.run
def run(tables, q):
    out = _orig(tables, q)
    c = out.columns()[-1]
    i = int(__import__("torch").nonzero(out.emit_mask())[0])
    c.data[i] = c.data[i] + 1
    return out
Q.run = run
"""

HALF = """
from portbench.queries import {op} as Q
import torch
_orig = Q.run
def run(tables, q):
    out = _orig(tables, q)
    live = torch.nonzero(out.emit_mask()).flatten()
    mask = torch.zeros(out.capacity, dtype=torch.bool)
    mask[live[: len(live) // 2]] = True
    out._row_mask = mask
    return out
Q.run = run
"""


@pytest.mark.parametrize("fault", ["alter", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(root, cell, fault):
    op = "join" if "join" in cell else "groupby"
    code = (ALTER if fault == "alter" else HALF).format(op=op)
    res = testing.result(testing.run_cpu(
        root, ["--workload", cell, "--seed", str(SEEDS[0]), "--seconds",
               "0.3"], prelude=code))
    assert res["correct"] is False, res
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    res = testing.result(testing.run_cpu(
        root, ["--workload", cell, "--seed", str(SEEDS[1]), "--seconds",
               "0.3"]))
    assert res["correct"] is True and res["failed"] == 0
