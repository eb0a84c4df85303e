"""Device milliseconds a query in the span ``join.plan.sort``: the stream
route's sorts and the gathers of key bits, tags and payload lanes by
their permutation."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "sort", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "join.plan.sort")
