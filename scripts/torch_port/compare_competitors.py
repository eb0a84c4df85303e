#!/usr/bin/env python
"""Same-host comparison of the port with the dataframe engines
(counterpart of scripts/compare_competitors.py).

One workload, the JAX script's: an inner join, a groupby-aggregate
(sum, count, mean) and a sort, at the same row count on the same machine,
on the same data (``default_rng(0)``), by every engine present:

* ``cylon_tpu_torch`` on ``--device`` (the join through K3/K4 and the
  groupby's float sums through K7 on the card);
* pandas, pyarrow (Table.join / group_by / sort_by), duckdb and dask,
  each where it imports; otherwise ``{"absent": true}``.

Each time is the best of 3 runs after one warm-up; the port's runs end in
``torch.cuda.synchronize()``, the host engines are synchronous. Each
engine that ran also reports the join's row count and the number of
groups, counted outside the timed runs; both must equal numpy's and
every other engine's. ``speedup_vs_pandas`` is pandas' time over the
port's, where pandas ran.

    python scripts/torch_port/compare_competitors.py [rows_log2=22]
        [--device cuda|cpu] [--cpu] [--out PATH]

(``--cpu`` is ``--device cpu``, the JAX script's spelling.) The last
stdout line is the JSON summary, with the kernel launches; a file is
written only to ``--out``.
"""
import numpy as np

import drill_common

OPS = ("join_s", "groupby_s", "sort_s")


def make_data(n: int) -> dict:
    """The JAX script's draws."""
    rng = np.random.default_rng(0)
    return {
        "lk": rng.integers(0, n, n).astype(np.int32),
        "lv": rng.normal(size=n).astype(np.float32),
        "rk": rng.integers(0, n, n).astype(np.int32),
        "rv": rng.normal(size=n).astype(np.float32),
        "g": rng.integers(0, 1 << 20, n).astype(np.int32),
        "sk": rng.integers(0, 1 << 31, n).astype(np.int32),
    }


def run_cylon(d: dict, iters: int, device) -> dict:
    import cylon_tpu_torch as ct

    ctx = ct.CylonContext.Init(device=device)
    left = ct.Table.from_pydict(ctx, {"k": d["lk"], "v": d["lv"]})
    right = ct.Table.from_pydict(ctx, {"k": d["rk"], "w": d["rv"]})
    gt = ct.Table.from_pydict(ctx, {"g": d["g"], "x": d["lv"],
                                    "y": d["g"]})
    st = ct.Table.from_pydict(ctx, {"k": d["sk"], "v": d["lv"]})

    def join():
        return left.join(right, "inner", on="k")

    def groupby():
        return gt.groupby(0, [1, 2, 1], ["sum", "count", "mean"])

    def best(fn):
        return drill_common.best_of(fn, device, iters)

    return {"backend": device.type,
            "join_s": best(join), "groupby_s": best(groupby),
            "sort_s": best(lambda: st.sort("k")),
            "join_rows": join().row_count, "groups": groupby().row_count}


def _host_best(fn, iters: int) -> float:
    """A host engine's best of ``iters`` (synchronous: nothing to wait
    for)."""
    return drill_common.best_of(fn, drill_common.device_of("cpu"), iters)


def run_pandas(d: dict, iters: int, device) -> dict:
    import pandas as pd

    ldf = pd.DataFrame({"k": d["lk"], "v": d["lv"]})
    rdf = pd.DataFrame({"k": d["rk"], "w": d["rv"]})
    gdf = pd.DataFrame({"g": d["g"], "x": d["lv"], "y": d["g"]})
    sdf = pd.DataFrame({"k": d["sk"], "v": d["lv"]})

    def groupby():
        return gdf.groupby("g").agg(x_sum=("x", "sum"),
                                    y_count=("y", "count"),
                                    x_mean=("x", "mean"))

    return {"join_s": _host_best(lambda: ldf.merge(rdf, on="k"), iters),
            "groupby_s": _host_best(groupby, iters),
            "sort_s": _host_best(lambda: sdf.sort_values("k"), iters),
            "join_rows": len(ldf.merge(rdf, on="k")),
            "groups": len(groupby())}


def run_pyarrow(d: dict, iters: int, device) -> dict:
    import pyarrow as pa

    lt = pa.table({"k": d["lk"], "v": d["lv"]})
    rt = pa.table({"k": d["rk"], "w": d["rv"]})
    gt = pa.table({"g": d["g"], "x": d["lv"], "y": d["g"]})
    st = pa.table({"k": d["sk"], "v": d["lv"]})

    def groupby():
        return gt.group_by("g").aggregate([("x", "sum"), ("y", "count"),
                                           ("x", "mean")])

    return {"join_s": _host_best(lambda: lt.join(rt, "k", join_type="inner"),
                                 iters),
            "groupby_s": _host_best(groupby, iters),
            "sort_s": _host_best(lambda: st.sort_by("k"), iters),
            "join_rows": lt.join(rt, "k", join_type="inner").num_rows,
            "groups": groupby().num_rows}


def run_duckdb(d: dict, iters: int, device) -> dict:
    import duckdb
    import pandas as pd

    con = duckdb.connect()
    con.register("l", pd.DataFrame({"k": d["lk"], "v": d["lv"]}))
    con.register("r", pd.DataFrame({"k": d["rk"], "w": d["rv"]}))
    con.register("g", pd.DataFrame({"g": d["g"], "x": d["lv"]}))
    con.register("s", pd.DataFrame({"k": d["sk"], "v": d["lv"]}))
    join = "SELECT count(*) FROM l JOIN r USING (k)"
    group = "SELECT g, sum(x), count(x), avg(x) FROM g GROUP BY g"
    return {"join_s": _host_best(lambda: con.execute(join).fetchall(),
                                 iters),
            "groupby_s": _host_best(lambda: con.execute(group).fetchall(),
                                    iters),
            "sort_s": _host_best(lambda: con.execute(
                "SELECT * FROM s ORDER BY k").arrow(), iters),
            "join_rows": con.execute(join).fetchall()[0][0],
            "groups": len(con.execute(group).fetchall())}


def run_dask(d: dict, iters: int, device) -> dict:
    import dask.dataframe as dd
    import pandas as pd

    ldf = dd.from_pandas(pd.DataFrame({"k": d["lk"], "v": d["lv"]}),
                         npartitions=8)
    rdf = dd.from_pandas(pd.DataFrame({"k": d["rk"], "w": d["rv"]}),
                         npartitions=8)

    def join():
        return ldf.merge(rdf, on="k").shape[0].compute()

    return {"join_s": _host_best(join, iters), "join_rows": int(join())}


ENGINES = {
    "cylon_tpu_torch": run_cylon,
    "pandas": run_pandas,
    "pyarrow": run_pyarrow,
    "duckdb": run_duckdb,
    "dask": run_dask,
}


def expected(d: dict, n: int) -> dict:
    """numpy's join row count and number of groups."""
    return {"join_rows": int((np.bincount(d["lk"], minlength=n).astype(
        np.int64) * np.bincount(d["rk"], minlength=n)).sum()),
            "groups": int(np.unique(d["g"]).size)}


def main(argv=None) -> dict:
    p = drill_common.tool_parser(__doc__.split("\n")[0], 22, "the rows")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    p.add_argument("--iters", type=int, default=3,
                   help="timed runs after the warm-up (default 3)")
    args = p.parse_args(argv)
    device = drill_common.device_of("cpu" if args.cpu else args.device)
    launches0 = drill_common.launches()
    n = 1 << args.rows_log2
    d = make_data(n)
    want = expected(d, n)
    res = {"n_rows": n, "device": drill_common.card_name(device),
           "expected": want, "engines": {}}
    for name, fn in ENGINES.items():
        if name == "cylon_tpu_torch":
            r = fn(d, args.iters, device)
            r["launches"] = drill_common.launch_delta(launches0)
        else:
            try:
                r = fn(d, args.iters, device)
            except ImportError:
                r = {"absent": True}
        res["engines"][name] = r
        print(name, r, flush=True)
    for name, r in res["engines"].items():
        for k, v in want.items():
            if k in r and r[k] != v:
                raise AssertionError(f"{name}: {k} {r[k]} != numpy's {v}")
    cy = res["engines"]["cylon_tpu_torch"]
    pdr = res["engines"]["pandas"]
    for op in OPS:
        if op in cy and op in pdr:
            res.setdefault("speedup_vs_pandas", {})[op] = pdr[op] / cy[op]
    return drill_common.finish(res, args.out, launches0)


if __name__ == "__main__":
    main()
