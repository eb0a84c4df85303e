"""The whole query's share of the card's memory rate: the bytes a query
must move (its input columns read once, its result written once) at
3.35 TB/s, over the traced window's time a query. It bounds what the
kernels' shares can claim: a kernel taken off the path leaves its own
share silent, not this one."""
UNIT, LAYER, MOVES = "%", "device", "input_rows_per_s"


def read(r):
    if r.trace is None or not r.trace.device or not r.queries:
        return None
    least = r.stats["query_bytes"] * r.stats.get("share", 1.0) \
        / r.peaks["hbm_bytes_per_s"]
    return 100.0 * least / (r.trace.window_s / r.queries)
