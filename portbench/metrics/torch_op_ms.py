"""Device milliseconds a query in every other device operation: the
join's and the group-by's torch ops (int64 glue, gathers, scans,
copies, sets), neither a hand-written kernel nor a sort."""
from portbench import trace
from portbench.metrics import sort_ms

UNIT, LAYER, MOVES = "ms", "join and group-by bodies", "input_rows_per_s"


def read(r):
    if r.trace is None or not r.queries:
        return None
    s = trace.device_seconds(r.trace, None, exclude=tuple(
        r.kernel_symbols()) + sort_ms.PATTERNS)
    return 1e3 * s / r.queries if s > 0 else None
