"""Device milliseconds a query in the span ``join.rebuild``: the output
columns rebuilt from the materialized tensors."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "join.rebuild")
