"""The share of the ``setop`` span's device time that its leaf stages'
spans hold (``LEAVES``: both routes' stages, a stage that never ran
counting 0): the guard on the set op's spans, which falls where work
runs outside every stage."""
from portbench import spans

UNIT, LAYER, MOVES = "%", "entry point", "input_rows_per_s"
LEAVES = ("setop.prepare", "setop.hash", "setop.sort", "setop.stream",
          "setop.materialize", "setop.dense")


def read(r):
    t = spans.op_times(r, "setop")
    if t is None or t["setop"][0] <= 0:
        return None
    return 100.0 * sum(t[s][0] for s in LEAVES if s in t) / t["setop"][0]
