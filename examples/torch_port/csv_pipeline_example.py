"""CSV in -> relational pipeline -> CSV out on the card (reference:
python/examples/table_relational_algebra.py and the per-rank CSV
convention of cpp/test/join_test.cpp:22-24; the port's counterpart of
examples/csv_pipeline_example.py).

Writes two CSVs (the host library's numeric writer), reads them back with
options, joins, groups and writes the result.

    python examples/torch_port/csv_pipeline_example.py [--device cpu]
        [--folder DIR]
"""
import argparse
import os
import tempfile

import numpy as np

import cylon_tpu_torch as ct


def main(device=None, folder=None) -> dict:
    """Prints and returns the output's path and row count. The CSVs go to
    ``folder`` (default: a new temporary directory)."""
    ctx = ct.CylonContext.Init(device)
    rng = np.random.default_rng(1)
    d = folder or tempfile.mkdtemp()
    orders_path = os.path.join(d, "orders.csv")
    items_path = os.path.join(d, "items.csv")

    ct.Table.from_pydict(ctx, {
        "order_id": np.arange(1000, dtype=np.int64),
        "customer": rng.integers(0, 100, 1000).astype(np.int64),
    }).to_csv(orders_path)
    ct.Table.from_pydict(ctx, {
        "order_id": rng.integers(0, 1000, 5000).astype(np.int64),
        "amount": rng.exponential(30.0, 5000),
    }).to_csv(items_path)

    opts = ct.CSVReadOptions().use_threads(True).block_size(1 << 20)
    orders = ct.read_csv(ctx, orders_path, opts)
    items = ct.read_csv(ctx, items_path, opts)

    joined = orders.join(items, "inner", on="order_id")
    by_customer = joined.groupby(1, [3], ["sum"])  # customer, sum(amount)
    out_path = os.path.join(d, "spend.csv")
    by_customer.sort(0).to_csv(out_path)
    print("wrote", out_path, "rows:", by_customer.row_count)
    return {"path": out_path, "rows": by_customer.row_count}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--folder", default=None)
    args = ap.parse_args()
    main(args.device, args.folder)
