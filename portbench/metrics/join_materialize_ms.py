"""Device milliseconds a query in the span ``join.materialize``: K4 and the
unpacking of its lanes (with the gathers of the columns that ride no
lane)."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "kernels", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "join.materialize")
