"""Device milliseconds a query in the port's hand-written kernels (the
symbols of every ``rooflines/<kernel>.py``)."""
from portbench import trace

UNIT, LAYER, MOVES = "ms", "kernels", "input_rows_per_s"


def read(r):
    if r.trace is None or not r.queries:
        return None
    s = trace.device_seconds(r.trace, r.kernel_symbols())
    return 1e3 * s / r.queries if s > 0 else None
