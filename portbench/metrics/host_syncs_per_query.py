"""Blocking CUDA runtime calls a query (stream, device and event
synchronizes, synchronous copies) among the traced run's runtime
events, less the one synchronize a query the harness makes."""
from portbench import trace

UNIT, LAYER, MOVES = "syncs/query", "entry point", "query_p90_ms"


def read(r):
    if r.trace is None or not r.trace.runtime or not r.queries:
        return None
    return (trace.sync_calls(r.trace) - r.queries) / r.queries
