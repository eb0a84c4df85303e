"""Device milliseconds a query in the span ``setop.hash``: the set op's
tag stream, the stack of its lanes, and the 2x32-bit row hash
(``ops/hash.hash2_streams``, int64 torch ops)."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "setop.hash")
