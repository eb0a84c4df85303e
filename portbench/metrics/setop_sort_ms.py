"""Device milliseconds a query in the span ``setop.sort``: the set op's
two stable sorts, the packed hash key, and the gathers of both hash
words and the lane stack by the permutation."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "sort", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "setop.sort")
