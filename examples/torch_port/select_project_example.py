"""Select / project / sort / pandas-style masks on the card (reference:
cpp/src/examples/select_example.cpp, project_example.cpp, and the pycylon
mask dunders in python/pycylon/data/table.pyx:749-798; the port's
counterpart of examples/select_project_example.py).

    python examples/torch_port/select_project_example.py [--device cpu]
"""
import argparse

import numpy as np

import cylon_tpu_torch as ct


def main(device=None) -> dict:
    """Prints and returns the two filters' row counts and the projected
    column names."""
    ctx = ct.CylonContext.Init(device)
    rng = np.random.default_rng(5)
    t = ct.Table.from_pydict(ctx, {
        "a": rng.integers(0, 100, 1000).astype(np.int64),
        "b": rng.normal(size=1000),
        "c": rng.integers(0, 2, 1000).astype(np.int32),
    })

    # row-lambda select (reference row-loop style — use masks on hot paths)
    small = t.select(lambda row: row.get_int64(0) < 10)
    print("select a<10:", small.row_count)

    # vectorized mask path (pandas-style)
    hot = t[t["a"] > 90]
    print("mask a>90:", hot.row_count)

    proj = t.project(["a", "c"])
    print("projected columns:", proj.column_names)

    print("sorted by b (desc), first rows:")
    t.sort("b", ascending=False).show(0, 3)
    return {"select": small.row_count, "mask": hot.row_count,
            "projected": proj.column_names}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
