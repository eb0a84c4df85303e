"""Device milliseconds a query in the span ``join.prepare``: the join's key
alignment, key bits and payload lanes of both sides."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "join.prepare")
