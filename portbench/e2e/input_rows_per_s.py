"""Input rows of every query completed in the window over the window's
seconds (the window ends when its last query's result is back)."""
UNIT = "rows/s"


def read(r):
    return r.rows_per_query * r.queries / r.window_s if r.queries else None
