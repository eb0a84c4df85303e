"""The share of the traced window in which nothing ran on the card."""
from portbench import trace

UNIT, LAYER, MOVES = "%", "device", "input_rows_per_s"


def read(r):
    if r.trace is None:
        return None
    busy = trace.busy_s(r.trace)
    return 100.0 * (1.0 - busy / r.trace.window_s) if busy > 0 else None
