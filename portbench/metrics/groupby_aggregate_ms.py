"""Device milliseconds a query in the span ``groupby.aggregate``: the group
count's fetch (the query's one host sync), K7's float sums and the
boundary integer sums."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "kernels", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "groupby.aggregate")
