"""Device milliseconds a query in the span ``setop.stream``: K5 with K6
for its compaction, and the counts fetch (the set op's one host sync)."""
from portbench import spans

UNIT, LAYER, MOVES = "ms", "kernels", "input_rows_per_s"


def read(r):
    return spans.ms_per_query(r, "setop.stream")
