"""The share of the op span's device time (``join``, ``groupby``) that
its leaf stages' spans hold (``spans.LEAVES``): the guard on the spans
themselves, which falls where work runs outside every stage."""
from portbench import spans

UNIT, LAYER, MOVES = "%", "entry point", "input_rows_per_s"


def read(r):
    return spans.cover_pct(r)
