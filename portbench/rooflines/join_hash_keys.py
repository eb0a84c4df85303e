"""K8, the hash stage of the join's hash stream: it must read each row's
key columns once and write the packed 8-byte sort key and, as 4-byte
values, the row's tag, its two 32-bit hashes and its key's u32 lanes (an
8-byte column gives two, a narrower one one). A join on one key of 4
bytes or less takes the sort stream instead, which has no hash stage."""

SYMBOLS = (r"(^|[\s:])join_hash_keys_kernel\(",)


def stage_bytes(stats):
    if stats["op"] != "join":
        return None
    q, t = stats["query"], stats["tables"]
    on = q["on"] if isinstance(q["on"], list) else [q["on"]]
    widths = [t[q["left"]]["columns"][c] for c in on]
    if len(on) == 1 and widths[0] <= 4:
        return None
    lanes = sum(2 if w == 8 else 1 for w in widths)
    total = 0
    for side in (q["left"], q["right"]):
        key = sum(t[side]["columns"][c] for c in on)
        total += t[side]["rows"] * (key + 8 + 4 * (3 + lanes))
    return total
