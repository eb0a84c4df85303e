"""K4, the join's expansion of the plan into output rows: it must read
the plan (a row id of each matched row on both sides) and write one
pair of 4-byte row ids an output row."""


def stage_bytes(stats):
    if stats["op"] != "join":
        return None
    return 4 * (stats["left_matched"] + stats["right_matched"]) \
        + 8 * stats["out_rows"]
