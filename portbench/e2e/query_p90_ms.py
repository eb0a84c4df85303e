"""The 90th percentile of every query's latency in the window (host
clock, from the call to the result's synchronize), from the raw times."""
from portbench import stats

UNIT = "ms"


def read(r):
    return 1e3 * stats.percentile(r.latencies, 90) if r.latencies else None
