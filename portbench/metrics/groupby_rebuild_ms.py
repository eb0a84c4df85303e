"""Device milliseconds a query in the span ``groupby.rebuild``: the key
takes at each group's first row and the aggregate columns."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "groupby.rebuild")
