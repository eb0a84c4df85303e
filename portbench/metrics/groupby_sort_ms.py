"""Device milliseconds a query in the span ``groupby.sort``: the lexsort of
the dead flag and the key bits."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "sort", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "groupby.sort")
