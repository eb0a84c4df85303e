"""K6, the compaction stage of a union: it must read the keep bit of
every row, and read and write the 4-byte lanes of each kept row (two for
an 8-byte column, one for a narrower one)."""


def stage_bytes(stats):
    if stats["op"] != "union":
        return None
    q, t = stats["query"], stats["tables"]
    n = t[q["left"]]["rows"] + t[q["right"]]["rows"]
    lanes = sum(2 if w == 8 else 1
                for w in t[q["left"]]["columns"].values())
    return n / 8 + 8 * lanes * stats["out_rows"]
