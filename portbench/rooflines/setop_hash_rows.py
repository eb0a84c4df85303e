"""K9, the hash stage of a union's stream route: it must read each row's
columns once and write, as 4-byte values, the row's tag, its canonical
u32 lanes (two for an 8-byte column, one for a narrower one) and its two
32-bit hashes. The cell's columns carry no validity and no emit mask."""

SYMBOLS = (r"(^|[\s:])setop_hash_rows_kernel\(",)


def stage_bytes(stats):
    if stats["op"] != "union":
        return None
    q, t = stats["query"], stats["tables"]
    total = 0
    for side in (q["left"], q["right"]):
        widths = t[side]["columns"].values()
        lanes = sum(2 if w == 8 else 1 for w in widths)
        total += t[side]["rows"] * (sum(widths) + 4 * (1 + lanes) + 8)
    return total
