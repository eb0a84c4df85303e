"""Device milliseconds a query in the span ``groupby.gather``: the gathers
of every operand by the sort's permutation, the group boundaries and
ids, and the group count on the device."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "groupby.gather")
