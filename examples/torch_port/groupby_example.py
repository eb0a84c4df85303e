"""GroupBy aggregation on the card (reference:
cpp/src/examples/groupby_perf_example.cpp and groupby_example.cpp; the
port's counterpart of examples/groupby_example.py).

Distributed groupby = hash-shuffle on the key (K1/K2) + one segmented
aggregation pass per shard: the shuffle co-locates all rows of a key, so
COUNT is exact. ``--world 1`` groups on one shard.

    python examples/torch_port/groupby_example.py [--device cpu] [--world W]
"""
import argparse

import numpy as np

import cylon_tpu_torch as ct


def main(device=None, world: int = 4) -> dict:
    """Prints and returns the group count and the total of ``sales``."""
    ctx = (ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                           device=device)
           if world > 1 else ct.CylonContext.Init(device))

    rng = np.random.default_rng(11)
    n = 500_000
    t = ct.Table.from_pydict(ctx, {
        "store": rng.integers(0, 1000, n).astype(np.int32),
        "sales": rng.exponential(50.0, n),
        "units": rng.integers(1, 20, n).astype(np.int32),
    })

    if world > 1:
        out = ct.distributed_groupby(t, "store", ["sales", "units", "sales"],
                                     ["sum", "count", "mean"])
    else:
        out = t.groupby(0, ["sales", "units", "sales"],
                        ["sum", "count", "mean"])
    print(f"{out.row_count} groups from {n} rows")
    out.sort("store").show(0, 5)

    # a scalar aggregate reduces over every shard
    total = float(next(iter(t.sum("sales").to_pydict().values()))[0])
    print("total sales:", total)
    return {"groups": out.row_count, "total_sales": total}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    main(args.device, args.world)
