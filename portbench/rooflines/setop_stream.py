"""K5, the emit stage of a union over the stream sorted by the 2x32-bit
row hash: it must read each row's two hash words and its 4-byte tag
once, the 4-byte lanes of each row that repeats its predecessor's hash
(the audit that the two rows are equal), and write one bit a row, which
rows the compaction keeps. A row's lanes: two for an 8-byte column, one
for a narrower one."""


def stage_bytes(stats):
    if stats["op"] != "union":
        return None
    q, t = stats["query"], stats["tables"]
    n = t[q["left"]]["rows"] + t[q["right"]]["rows"]
    lanes = sum(2 if w == 8 else 1
                for w in t[q["left"]]["columns"].values())
    return 12 * n + 4 * lanes * (n - stats["out_rows"]) + n / 8
