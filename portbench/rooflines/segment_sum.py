"""K7, the float sums of a group-by in row order: it must read each
row's value of every float SUM/MEAN column and its 4-byte group id
once, and write one sum a group and column."""


def stage_bytes(stats):
    if stats["op"] != "groupby":
        return None
    q, t = stats["query"], stats["tables"][stats["query"]["table"]]
    cols = [c for c, op in zip(q["columns"], q["aggs"])
            if op in ("sum", "mean") and c in t["float_columns"]]
    if not cols:
        return None
    per_row = sum(t["columns"][c] for c in cols) + 4
    return t["rows"] * per_row + 8 * len(cols) * stats["out_rows"]
