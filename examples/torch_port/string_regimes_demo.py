"""The three string-column regimes and when each engages, on the card
(the port's counterpart of examples/string_regimes_demo.py).

1. DICTIONARY (low cardinality): sorted host vocab + int32 codes —
   exact ordering, cheapest sorts.
2. WORD LANES (high cardinality, rows <= 20 bytes): raw prefix words +
   length are the join/group identity — byte-EXACT with zero hashing.
3. CONTENT HASH (longer rows): 96-bit polynomial triple + length; pass
   ``join(..., exact=True)`` for a byte-verification pass over matched
   pairs (K3 runs in hash mode with verify lanes).

    python examples/torch_port/string_regimes_demo.py [--device cpu]
"""
import argparse

import numpy as np

import cylon_tpu_torch as ct
from cylon_tpu_torch.data import strings as _strings


def main(device=None) -> dict:
    """Prints the regimes, and returns the two joins' row counts."""
    ctx = ct.CylonContext.Init(device)
    rng = np.random.default_rng(0)
    n = 5000

    # 1. dictionary: few distinct values
    cities = np.array(["paris", "tokyo", "lima", "oslo"], object)
    t1 = ct.Table.from_pydict(ctx, {"city": cities[rng.integers(0, 4, n)],
                                    "v": rng.normal(size=n)})
    print("dictionary regime:", t1.get_column(0).dictionary is not None)

    # 2. word lanes: high-cardinality short ids (byte-exact keys)
    ids = np.array([f"acct-{i:08d}" for i in range(n)], object)
    t2 = ct.Table.from_pydict(ctx, {"id": ids, "v": np.arange(n)})
    c = t2.get_column(0)
    print("varbytes:", c.is_varbytes,
          "| exact lanes:",
          c.varbytes.max_words <= _strings.EXACT_KEY_WORDS)
    j = t2.join(t2, "inner", on="id")
    print("self-join rows:", j.row_count, "(byte-exact, no hashing)")

    # 3. content hash + exact=True for long keys
    urls = np.array([f"https://example.com/item/{i:012d}/view"
                     for i in range(n)], object)
    t3 = ct.Table.from_pydict(ctx, {"url": urls, "v": np.arange(n)})
    print("long keys words:", t3.get_column(0).varbytes.max_words,
          "(> EXACT_KEY_WORDS -> 96-bit hash identity)")
    jv = t3.join(t3, "inner", on="url", exact=True)
    print("exact-verified join rows:", jv.row_count)
    return {"self_join": j.row_count, "exact_join": jv.row_count}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
