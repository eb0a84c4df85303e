"""Distributed join example on the card (reference:
cpp/src/examples/join_example.cpp; the port's counterpart of
examples/join_example.py).

Two tables are built on the host and distributed over a virtual world of
shards on one card (``--world``, default 4; ``--world 1`` joins locally),
hash-shuffled and joined: kernels K1/K2 place the rows, K3/K4 plan and
expand each shard's join.

    python examples/torch_port/join_example.py [--device cpu] [--world W]
"""
import argparse

import numpy as np

import cylon_tpu_torch as ct


def main(device=None, world: int = 4) -> dict:
    """Prints and returns each join type's row count."""
    ctx = (ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                           device=device)
           if world > 1 else ct.CylonContext.Init(device))

    rng = np.random.default_rng(7)
    n = 100_000
    left = ct.Table.from_pydict(ctx, {
        "id": rng.integers(0, n // 2, n).astype(np.int64),
        "price": rng.normal(100.0, 15.0, n),
    })
    right = ct.Table.from_pydict(ctx, {
        "id": rng.integers(0, n // 2, n).astype(np.int64),
        "qty": rng.integers(1, 10, n).astype(np.int32),
    })

    rows = {}
    for jt in ("inner", "left", "right", "outer"):
        if world > 1:
            out = left.distributed_join(right, jt, on="id")
        else:
            out = left.join(right, jt, on="id")
        rows[jt] = out.row_count
        print(f"{jt:>6} join: {out.row_count} rows, "
              f"world={ctx.get_world_size()}")
    out.show(0, 5)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    main(args.device, args.world)
