"""Lazy query plan on the card: join -> groupby with ONE shuffle (the
port's counterpart of examples/plan_pipeline_example.py).

The filter is pushed below the shuffle, and the groupby on the join's key
needs no second exchange; K1/K2 shuffle, K3/K4 join, on a virtual world
of ``--world`` shards (default 4).

    python examples/torch_port/plan_pipeline_example.py [--device cpu]
        [--world W]
"""
import argparse

import numpy as np

import cylon_tpu_torch as ct
from cylon_tpu_torch import plan, telemetry
from cylon_tpu_torch.plan import col


def main(device=None, world: int = 4) -> dict:
    """Prints the plan, and prints and returns the result's row count and
    its exchange stages."""
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                          device=device)
    rng = np.random.default_rng(0)
    n = 100_000

    orders = ct.Table.from_pydict(ctx, {
        "user": rng.integers(0, n // 8, n).astype(np.int32),
        "amount": rng.exponential(40.0, n).astype(np.float32),
        "region": rng.integers(0, 5, n).astype(np.int32)})
    users = ct.Table.from_pydict(ctx, {
        "user": np.arange(n // 8, dtype=np.int32),
        "score": rng.integers(0, 100, n // 8).astype(np.int32)})

    pipe = (plan.scan(orders)
            .filter(col("region") < 3)          # pushed below the shuffle
            .join(plan.scan(users), on="user")
            .groupby("lt-0", ["lt-1"], ["sum"]))  # same keys: no 2nd shuffle

    print(pipe.explain())
    print()
    with telemetry.collect_phases() as cp:
        result = pipe.execute()
    stages = cp.count("plan.shuffle")
    print(f"rows: {result.row_count}, exchange stages: {stages}")
    return {"rows": result.row_count, "exchange_stages": stages}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--world", type=int, default=4)
    args = ap.parse_args()
    main(args.device, args.world)
