"""Union / intersect / subtract on the card (reference:
cpp/src/examples/union_example.cpp, intersect_example.cpp,
subtract_example.cpp; the port's counterpart of
examples/set_ops_example.py).

Set ops are full-row distinct operations: union deduplicates the
concatenation, intersect keeps distinct rows present in both, subtract
keeps distinct left rows absent from the right. On one shard (the
default) each runs the stream route: K5 emits the rows over the
hash-sorted stream and K6 compacts them; ``--world W`` runs the
distributed set ops over a virtual world of W shards.

    python examples/torch_port/set_ops_example.py [--device cpu] [--world W]
"""
import argparse

import numpy as np

import cylon_tpu_torch as ct


def main(device=None, world: int = 1) -> dict:
    """Prints and returns the three results' row counts."""
    ctx = (ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                           device=device)
           if world > 1 else ct.CylonContext.Init(device))

    rng = np.random.default_rng(3)
    a = ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, 50, 200).astype(np.int32),
        "g": rng.integers(0, 4, 200).astype(np.int32),
    })
    b = ct.Table.from_pydict(ctx, {
        "k": rng.integers(25, 75, 200).astype(np.int32),
        "g": rng.integers(0, 4, 200).astype(np.int32),
    })

    if world > 1:
        u, i, s = (a.distributed_union(b), a.distributed_intersect(b),
                   a.distributed_subtract(b))
    else:
        u, i, s = a.union(b), a.intersect(b), a.subtract(b)
    print("union:", u.row_count, "intersect:", i.row_count,
          "subtract:", s.row_count)
    return {"union": u.row_count, "intersect": i.row_count,
            "subtract": s.row_count}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--world", type=int, default=1)
    args = ap.parse_args()
    main(args.device, args.world)
