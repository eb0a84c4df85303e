"""Device milliseconds a query in the span ``setop.materialize``: the
result's columns rebuilt from K6's compacted lanes, and its emit mask."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "setop.materialize")
