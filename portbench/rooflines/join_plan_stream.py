"""K3, the join's plan over the sorted stream of both sides' keys: it
must read each row's key and its 4-byte row id once, and write the row
ids of the rows that meet a match on the other side."""


def stage_bytes(stats):
    if stats["op"] != "join":
        return None
    q, t = stats["query"], stats["tables"]
    rows = 0
    for side in (q["left"], q["right"]):
        rows += t[side]["rows"] * (t[side]["columns"][q["on"]] + 4)
    return rows + 4 * (stats["left_matched"] + stats["right_matched"])
