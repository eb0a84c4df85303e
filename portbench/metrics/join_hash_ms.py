"""Device milliseconds a query in the span ``join.plan.hash``: the hash
stream's int64 glue: row tags, the key bits' u32 lanes, their two hash
streams and the packed sort key."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "join.plan.hash")
