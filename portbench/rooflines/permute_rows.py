"""K10, the sort stage of the stream routes: it must read each row's final
index (8 bytes) and read once and write once each 32-bit word it hands
the next kernel (8 bytes a word). A join hands K3 the tag, the two
hashes, its key's u32 lanes (two for an 8-byte column, one for a
narrower one) and the largest side's 4-byte payload columns (at most
eight); a union hands K5 the two hashes, the tag and each column's lanes.
A join on one key of 4 bytes or less takes the sort stream, whose stage
this count does not cover, and a group-by has no such stage."""

SYMBOLS = (r"(^|[\s:])permute_rows_kernel<",)

SHARED_LANES = 8    # ops/join.MAX_SHARED_LANES


def _lanes(widths):
    return sum(2 if w == 8 else 1 for w in widths)


def stage_bytes(stats):
    q, t = stats["query"], stats["tables"]
    if stats["op"] == "union":
        words = 3 + _lanes(t[q["left"]]["columns"].values())
    elif stats["op"] == "join":
        on = q["on"] if isinstance(q["on"], list) else [q["on"]]
        keys = [t[q["left"]]["columns"][c] for c in on]
        if len(on) == 1 and keys[0] <= 4:
            return None
        payload = max(sum(1 for c, w in t[s]["columns"].items()
                          if w == 4 and c not in on)
                      for s in (q["left"], q["right"]))
        words = 3 + _lanes(keys) + min(payload, SHARED_LANES)
    else:
        return None
    rows = sum(t[s]["rows"] for s in (q["left"], q["right"]))
    return rows * (8 + 8 * words)
