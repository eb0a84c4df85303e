"""One process of a cylon_tpu_torch process group on the CPU, for
tests/test_torch_port_multiprocess.py and tests/test_torch_port_ingest.py.

    python tests/torch_port_mp_child.py ops RANK NPROC SHARDS RDV OUT ROUTE [DEVICE]
    python tests/torch_port_mp_child.py ingest RANK NPROC SHARDS RDV OUT DIR
    python tests/torch_port_mp_child.py tasks RANK NPROC SHARDS RDV OUT ROUTE

Each process joins a gloo process group through the ``file://``
rendezvous RDV (no port to race for) with SHARDS shards of its own, W =
NPROC * SHARDS. ``ops`` builds this process's shards of every case in
CASES from the case's seed, runs the case, and writes its shards' live
rows and the case's global row count to ``OUT/rank<RANK>.pkl`` (the agg
case writes its scalars instead: every process must get the same);
``exact_redo`` forces content-hash collisions (`pair_colliding`), so the
exact join redoes itself on one vocabulary gathered from every process;
``long_sort`` sorts keys past the device prefix bound on the host; ROUTE
"kernel" forces the kernel wrappers (their plain versions on the CPU),
"default" keeps the device's routes; DEVICE is "cpu" (the default) or a
CUDA device that every process shares (gloo stages its tensors through
host memory). ``ingest`` reads the per-rank CSV and Parquet files in DIR
and writes what it read. ``tasks`` runs ``plan.task_exchange`` of one
global table with its global task ids (TASK_ROWS rows, TASK_COUNT tasks),
then with one unknown id among process 0's rows (every process must
raise KeyError), then once more (the group is still in step). The
parent test starts the processes
(`start`, `finish`) and runs the same cases on the virtual world
(``run_case`` with a one-process context) and on cylon_tpu.

This module imports numpy, torch and cylon_tpu_torch only.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

WORLD = 4
JOIN_CASES = {
    "join_inner": ("inner", "shuffle"), "join_outer": ("outer", "shuffle"),
    "ring_inner": ("inner", "ring"), "ring_outer": ("outer", "ring"),
    "bcast_inner": ("inner", "broadcast"),
    "bcast_outer": ("outer", "broadcast"),
}
SETOP_CASES = ("union", "subtract", "intersect")
SMALL_CASES = {"small0": 0, "small1": 1, "small3": 3}
CASES = (["shuffle"] + list(JOIN_CASES) + list(SETOP_CASES)
         + ["groupby", "sort", "salted", "chunked", "strings"]
         + list(SMALL_CASES) + ["agg", "exact_redo", "long_sort"])
# the agg case: each column's scalar aggregates
AGG_OPS = {"k": ("sum", "count", "min", "max", "mean"),
           "v": ("sum", "count", "min", "max", "mean"),
           "x": ("sum", "count", "min", "max", "mean"),
           "y": ("sum", "count", "min", "max", "mean"),
           "z": ("sum", "min", "max"),
           "s": ("count", "min", "max")}
# PERF.md section 2: a float SUM within SUM_RTOL * sum |x| + SUM_ATOL of
# another order's, a MEAN within MEAN_RTOL * sum |x| / count
SUM_RTOL, SUM_ATOL, MEAN_RTOL = 1e-5, 1e-30, 1e-12
# the long keys of exact_redo and long_sort: 76 bytes (19 words), past
# EXACT_KEY_WORDS and SORT_PREFIX_WORDS; their last byte is a digit
LONG_KEY = "L" * 68 + "{:08d}"
# the chunked case's CYLON_EXCHANGE_CHUNK_BYTES: several chunks at 2,000
# rows
CHUNK_BYTES = "4096"


def _floats(rng, n, dtype):
    """Normal floats with -0.0 and NaN among them."""
    x = rng.normal(size=n).astype(dtype)
    x[::7] = -0.0
    x[3::11] = np.nan
    return x


def case_data(name: str) -> dict:
    """The case's global inputs: {side: ({column: array}, {column:
    validity})}, made from a seed with numpy, the same in every
    process."""
    rng = np.random.default_rng(CASES.index(name) + 100)
    if name in ("shuffle", "chunked"):
        n = 600 if name == "shuffle" else 2000
        return {"t": ({"k": rng.integers(0, 90, n).astype(np.int32),
                       "v": _floats(rng, n, np.float32),
                       "w": rng.integers(-9, 9, n).astype(np.int64)},
                      {"k": rng.random(n) < 0.9})}
    if name in JOIN_CASES or name in SMALL_CASES:
        nl, nr, hi = (400, 350, 60) if name in JOIN_CASES \
            else (SMALL_CASES[name],) * 2 + (2,)
        return {"l": ({"k": rng.integers(0, hi, nl).astype(np.int32),
                       "v": _floats(rng, nl, np.float32)},
                      {"k": rng.random(nl) < 0.9}),
                "r": ({"k": rng.integers(0, hi, nr).astype(np.int32),
                       "x": _floats(rng, nr, np.float64)},
                      {"k": rng.random(nr) < 0.9})}
    if name in SETOP_CASES:
        def side(n):
            return ({"k": rng.integers(0, 40, n).astype(np.int32),
                     "g": rng.integers(0, 3, n).astype(np.int64)},
                    {"g": rng.random(n) < 0.85})
        return {"l": side(500), "r": side(450)}
    if name == "groupby":
        n = 700
        x = rng.integers(-50, 50, n).astype(np.float64)
        x[5::13] = np.nan
        return {"t": ({"k": rng.integers(0, 50, n).astype(np.int32),
                       "v": rng.integers(-100, 100, n).astype(np.int64),
                       "x": x},
                      {"k": rng.random(n) < 0.9})}
    if name == "sort":
        n = 900
        return {"t": ({"k": rng.integers(-(1 << 40), 1 << 40,
                                         n).astype(np.int64),
                       "v": _floats(rng, n, np.float32)},
                      {"k": rng.random(n) < 0.95})}
    if name == "salted":
        n = 1200
        k = rng.integers(0, 1000, n).astype(np.int32)
        k[rng.random(n) < 0.7] = 7
        return {"t": ({"k": k, "v": _floats(rng, n, np.float32)}, {})}
    if name == "strings":
        def side(n, pay):
            ks = np.array([f"key-{int(i):05d}" for i in
                           rng.integers(0, 70, n)], object)
            cols = {"k": ks, pay: rng.integers(0, 1000, n).astype(np.int64)}
            if pay == "v":
                # payloads past LANE_WORDS_MAX words take the word exchange
                cols["s"] = np.array(["p" * int(m) + f"{i}" for i, m in
                                      enumerate(rng.integers(0, 60, n))],
                                     object)
            return cols, {"k": rng.random(n) < 0.9}
        return {"l": side(300, "v"), "r": side(260, "w")}
    if name == "agg":
        n = 600
        # v: NaN is a null (no validity given); x: a valid NaN (NaN
        # wins SUM, MIN and MAX); y: -0.0 among nulls; z: zeros of both
        # signs (MIN -0.0, MAX +0.0)
        y = rng.normal(size=n)
        y[::9] = -0.0
        return {"t": ({"k": rng.integers(-90, 90, n).astype(np.int32),
                       "v": _floats(rng, n, np.float32),
                       "x": _floats(rng, n, np.float64), "y": y,
                       "z": np.where(rng.random(n) < 0.5, -0.0, 0.0),
                       "s": np.array([f"s{int(i):03d}" + "é" * int(i % 3)
                                      for i in rng.integers(0, 400, n)],
                                     object)},
                      {"k": rng.random(n) < 0.9, "x": rng.random(n) < 0.95,
                       "y": rng.random(n) < 0.8, "s": rng.random(n) < 0.9})}
    if name == "exact_redo":
        def side(n, span, pay):
            keys = np.array([LONG_KEY.format(int(i)) for i in
                             rng.integers(0, span, n)], object)
            return ({"k": keys, pay: rng.integers(0, 1000, n).astype(
                np.int64)}, {"k": rng.random(n) < 0.9})
        return {"l": side(300, 200, "v"), "r": side(260, 200, "w")}
    if name == "long_sort":
        n = 500
        keys = np.array([LONG_KEY.format(int(i)) + "x" * int(i % 5)
                         for i in rng.integers(0, 150, n)], object)
        return {"t": ({"k": keys, "v": rng.integers(-5, 5, n).astype(
            np.int32), "f": _floats(rng, n, np.float32)},
            {"k": rng.random(n) < 0.9})}
    raise KeyError(name)


def pair_colliding(real):
    """A content hash under which two long keys that differ only in the
    lowest bit of their last byte collide (the 76-byte LONG_KEY rows: the
    digits 2m and 2m + 1), every other pair keeping its real hash: the
    exact join's collision redo then runs without an output of every
    row pair."""
    import torch

    def hashed(words, starts, lengths, max_words):
        nw = (lengths.to(torch.int64) + 3) >> 2
        last = (starts.to(torch.int64) + nw - 1)[lengths > 0]
        w = words.clone()
        w[last] = w[last] & ~(1 << 24)
        return real(w, starts, lengths, max_words)

    return hashed


def shard_slices(n: int, world: int) -> list:
    """Global row range of each shard (the layout `distribute` gives)."""
    cap = -(-max(n, 1) // world)
    cap = -(-cap // 8) * 8
    return [(min(s * cap, n), min((s + 1) * cap, n)) for s in range(world)]


def build(ct, ctx, side, how: str = "assemble"):
    """A side's distributed table in ``ctx``: per-shard tables of this
    process's shards through ``assemble_process_local``, or the whole
    table through ``distribute``."""
    from cylon_tpu_torch.parallel import shard

    cols, valid = side

    def table(lo, hi):
        return ct.Table([ct.Column.from_numpy(
            a[lo:hi], k, None if valid.get(k) is None else valid[k][lo:hi],
            ctx.device) for k, a in cols.items()], ctx)

    n = len(next(iter(cols.values())))
    if how == "distribute":
        return shard.distribute(table(0, n), ctx)
    sl = shard_slices(n, ctx.get_world_size())
    return shard.assemble_process_local(
        [table(*sl[s]) for s in ctx.local_shard_indices()], ctx)


def run_case(ct, ctx, name: str):
    """The case's result table and extras (the sort's splitters, the
    chunked exchange's chunk counts) in ``ctx``."""
    from cylon_tpu_torch.ops.groupby import AggregationOp
    from cylon_tpu_torch.parallel import dist_ops, shuffle

    data = case_data(name)
    extra = {}
    if name == "shuffle":
        return dist_ops.shuffle(build(ct, ctx, data["t"], "distribute"),
                                ["k"]), extra
    if name == "chunked":
        seen = []
        real = shuffle._chunk_plan

        def spy(*a):
            out = real(*a)
            seen.append(out[1])
            return out

        old = os.environ.get("CYLON_EXCHANGE_CHUNK_BYTES")
        os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = CHUNK_BYTES
        shuffle._chunk_plan = spy
        try:
            out = dist_ops.shuffle(build(ct, ctx, data["t"]), ["k"])
        finally:
            shuffle._chunk_plan = real
            if old is None:
                del os.environ["CYLON_EXCHANGE_CHUNK_BYTES"]
            else:
                os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = old
        extra["chunks"] = seen
        return out, extra
    if name == "salted":
        return dist_ops.shuffle(build(ct, ctx, data["t"]), ["k"],
                                salted=True), extra
    if name in JOIN_CASES or name in SMALL_CASES or name == "strings":
        how, comm = JOIN_CASES.get(name, ("inner", "shuffle"))
        left, right = build(ct, ctx, data["l"]), build(ct, ctx, data["r"])
        return left.distributed_join(right, how, on=["k"], comm=comm,
                                     force_exchange=comm == "shuffle"), extra
    if name in SETOP_CASES:
        left, right = build(ct, ctx, data["l"]), build(ct, ctx, data["r"])
        return getattr(left, f"distributed_{name}")(right), extra
    if name == "groupby":
        A = AggregationOp
        return dist_ops.distributed_groupby(
            build(ct, ctx, data["t"]), 0, [1, 1, 2, 2, 2],
            [A.SUM, A.COUNT, A.SUM, A.MIN, A.MAX]), extra
    if name == "agg":
        t = build(ct, ctx, data["t"])
        extra["agg"] = {f"{op}({c})": _scalar(getattr(t, op)(c), c)
                        for c, ops in AGG_OPS.items() for op in ops}
        return None, extra
    if name == "exact_redo":
        from cylon_tpu_torch.data import strings

        real, redo = strings._hash_rows, dist_ops._exact_dict_redo
        redos = []

        def spy(*a):
            redos.append(1)
            return redo(*a)

        strings._hash_rows = pair_colliding(real)
        dist_ops._exact_dict_redo = spy
        try:
            left, right = build(ct, ctx, data["l"]), build(ct, ctx,
                                                           data["r"])
            out = left.distributed_join(right, "left", on=["k"],
                                        exact=True, force_exchange=True)
        finally:
            strings._hash_rows, dist_ops._exact_dict_redo = real, redo
        extra["redo"] = len(redos)
        return out, extra
    if name == "long_sort":
        from cylon_tpu_torch.telemetry import metrics

        t = build(ct, ctx, data["t"])
        before = metrics.metrics_snapshot()
        out = dist_ops.distributed_sort(t, ["k", "v"], [False, True])
        after = metrics.metrics_snapshot()
        site = 'cylon_host_syncs_total{site="distributed_sort.host_keys"}'
        # the key gather across processes: one host sync a sort, however
        # many key columns; the virtual world sorts on its host without it
        extra["host_keys"] = after.get(site, 0) - before.get(site, 0)
        assert extra["host_keys"] == int(ctx.is_multiprocess()), extra
        return out, extra
    if name == "sort":
        from cylon_tpu_torch.ops import order

        t = build(ct, ctx, data["t"])
        lanes = order.sort_keys([t._columns[0]], [True])
        extra["splitters"] = [tuple(int(x) for x in s) for s in
                              dist_ops._range_splitters(ctx, lanes,
                                                        t.emit_mask())]
        return dist_ops.distributed_sort(t, "k"), extra
    raise KeyError(name)


def scalar_value(v):
    """A scalar aggregate's value as a JSON-able token that compares: a
    float as ["f", its float64 bits] (NaN and -0.0 compare), a numpy
    integer as int, anything else as it is."""
    if isinstance(v, (float, np.floating)):
        return ["f", int(np.float64(v).view(np.int64))]
    if isinstance(v, (np.integer, np.bool_)):
        return v.item()
    return v


def _scalar(table, name: str):
    """The value of a one-row scalar table, as `scalar_value` gives it."""
    assert table.row_count == 1 and table.column_names == [name], \
        (table.row_count, table.column_names)
    return scalar_value(table.to_pydict()[name][0])


def float_bounds(cols: dict, valid: dict, ops: dict) -> dict:
    """{aggregate: allowed difference} of the scalar aggregates ``ops``
    ({column: names}) of ``cols`` (validity ``valid``; a NaN of the input
    is a null): a float SUM's and MEAN's PERF.md section 2 bounds, from
    the input; 0 (exact) for every other."""
    out = {}
    for c, names in ops.items():
        a = cols[c]
        out.update({f"{op}({c})": 0.0 for op in names})
        if a.dtype.kind != "f":
            continue
        m = valid.get(c, np.ones(len(a), bool)) & ~np.isnan(a)
        s = float(np.abs(a[m].astype(np.float64)).sum())
        for op in names:
            if op == "sum":
                out[f"{op}({c})"] = SUM_RTOL * s + SUM_ATOL
            elif op == "mean":
                out[f"{op}({c})"] = MEAN_RTOL * s / max(int(m.sum()), 1)
    return out


def agg_bounds() -> dict:
    """`float_bounds` of the agg case's input."""
    cols, valid = case_data("agg")["t"]
    return float_bounds(cols, valid, AGG_OPS)


def _as_float(v) -> float:
    return float(np.int64(v[1]).view(np.float64))


def assert_aggs_close(got: dict, exp: dict, bounds: dict,
                      what: str) -> None:
    """Two sets of scalars as `scalar_value` gives them: the same
    aggregates; floats within ``bounds`` where it gives one above 0 (NaN
    equals NaN), everything else equal (floats bit for bit, -0.0 apart
    from +0.0)."""
    assert sorted(got) == sorted(exp), what
    for k, e in exp.items():
        g = got[k]
        if isinstance(e, list) and bounds.get(k, 0.0) > 0:
            a, b = _as_float(g), _as_float(e)
            assert (a != a and b != b) or abs(a - b) <= bounds[k], \
                (what, k, a, b, bounds[k])
        else:
            assert g == e, (what, k, g, e)


def export(table, ctx) -> dict:
    """This process's shards' live rows: the global shard of each row
    and every column's values (``to_pydict_local``, slot order), plus
    the table's global row count."""
    emit = table.emit_mask().cpu().numpy()
    v = ctx.local_shard_count()
    cap = emit.shape[0] // v if v else 0
    sid = np.array(ctx.local_shard_indices())[np.flatnonzero(emit) // cap] \
        if cap else np.zeros(0, np.int64)
    return {"sid": sid, "cols": table.to_pydict_local(),
            "names": table.column_names, "rows": table.row_count}


def run_export(ct, ctx, name: str) -> dict:
    """`run_case` and `export` of its result: this process's shards and
    the case's extras (the agg case: its scalars only)."""
    table, extra = run_case(ct, ctx, name)
    return extra if table is None else dict(export(table, ctx), **extra)


def set_route(route: str) -> None:
    from cylon_tpu_torch.ops import join
    from cylon_tpu_torch.parallel import shuffle

    forced = True if route == "kernel" else None
    join.STREAM_PLAN = shuffle.PARTITION_KERNEL = forced


def merged(parts: list) -> dict:
    """The processes' exports as one, in global shard order (process p
    holds the shards after process p - 1's)."""
    return {"sid": np.concatenate([p["sid"] for p in parts]),
            "cols": {k: np.concatenate([p["cols"][k] for p in parts])
                     for k in parts[0]["cols"]}}


def float_bits(a: np.ndarray) -> np.ndarray:
    return a.view({4: np.int32, 8: np.int64}[a.dtype.itemsize]) \
        if a.dtype.kind == "f" else a


def assert_same_export(parts: list, exp: dict) -> None:
    """Every process's shards (``parts``, one export a process) equal the
    one-process export ``exp`` shard for shard, bit for bit and in order,
    and every process counts the global rows."""
    if "agg" in exp:
        # the same scalar table in every process; within the contract's
        # bound of the virtual world's
        for p in parts:
            assert p["agg"] == parts[0]["agg"]
        assert_aggs_close(parts[0]["agg"], exp["agg"], agg_bounds(),
                          "processes against the virtual world")
        return
    for p in parts:
        assert p["rows"] == exp["rows"], (p["rows"], exp["rows"])
        assert p["names"] == exp["names"]
        for key in ("splitters", "chunks", "redo"):
            assert p.get(key) == exp.get(key), key
    got = merged(parts)
    assert np.array_equal(got["sid"], exp["sid"])
    for name, a in exp["cols"].items():
        g = got["cols"][name]
        assert g.dtype == a.dtype, name
        if a.dtype == object:
            assert list(map(repr, g)) == list(map(repr, a)), name
        else:
            assert np.array_equal(float_bits(g), float_bits(a)), name


def start(folder: Path, nproc: int, shards: int, mode: str, *args) -> list:
    """Start the ``nproc`` processes of one group running this module."""
    folder.mkdir(parents=True, exist_ok=True)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), mode, str(r),
         str(nproc), str(shards), str(folder / "rdv"), str(folder),
         *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nproc)]


def finish(folder: Path, procs: list, timeout: float = 300) -> list:
    """Each process's result, after every process exited 0 within
    ``timeout`` seconds (all are killed at the first timeout)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out[-6000:]}"
    results = []
    for r in range(len(procs)):
        with open(folder / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _context(ct, rank, nproc, shards, rdv, device):
    ctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
        num_processes=nproc, process_id=rank, backend="gloo",
        shards_per_process=shards, init_method=f"file://{rdv}"),
        device=device)
    assert ctx.get_process_rank() == rank
    assert ctx.get_process_count() == nproc
    assert ctx.get_world_size() == nproc * shards
    assert ctx.local_shard_indices() == list(range(rank * shards,
                                                   (rank + 1) * shards))
    assert ctx.get_rank() == rank * shards
    assert ctx.get_rank() not in ctx.get_neighbours()
    return ctx


def run_ops(ct, ctx, route: str) -> dict:
    set_route(route)
    out = {}
    for name in CASES:
        out[name] = run_export(ct, ctx, name)
    return out


def run_ingest(ct, ctx, folder: str) -> dict:
    """The per-rank readers on DIR's files, the exports of a table spread
    over the processes, and distribute_by_key of a table every process
    holds."""
    from cylon_tpu_torch.parallel import shard

    out = {}
    for kind, reader in (("csv", ct.read_csv_per_rank),
                         ("parquet", ct.read_parquet_per_rank)):
        t = reader(ctx, os.path.join(folder, f"part_{{rank}}.{kind}"))
        out[kind] = export(t, ctx)
        for fn in ("to_pandas", "to_pydict", "to_numpy", "to_arrow"):
            try:
                getattr(t, fn)()
            except ct.CylonError as e:
                assert e.code == ct.Code.Invalid, e
            else:
                raise AssertionError(f"{fn} of a spread table returned")
    rng = np.random.default_rng(6)
    n = 500
    whole = ct.Table.from_pydict(ctx, {
        "k": rng.integers(0, 40, n).astype(np.int32),
        "v": rng.integers(0, 1000, n).astype(np.int32)})
    d = shard.distribute_by_key(whole, ctx, ["k"])
    out["by_key"] = export(d, ctx)
    out["by_key_skips"] = ct.parallel.dist_ops.shuffle(d, ["k"]) is d
    from cylon_tpu_torch.data import strings

    old, strings.DICT_MAX_VOCAB = strings.DICT_MAX_VOCAB, 0  # varbytes
    try:
        strs = ct.Table.from_pydict(ctx, {
            "s": np.array([f"{'Q' * 40}{i % 50:04d}" for i in range(n)]),
            "v": np.arange(n)})
    finally:
        strings.DICT_MAX_VOCAB = old
    try:
        shard.distribute_by_key(strs, ctx, ["s"])
    except ct.CylonError as e:
        out["by_key_varbytes"] = int(e.code)
    return out


TASK_ROWS, TASK_COUNT = 3001, 9


def task_inputs():
    """(columns, task ids, plan map, the ids with one unknown id) of the
    task exchange, the same in every process."""
    rng = np.random.default_rng(13)
    n = TASK_ROWS
    cols = {"v": np.arange(n, dtype=np.int64),
            "z": _floats(rng, n, np.float32),
            "k": rng.integers(-50, 50, n).astype(np.int32)}
    tasks = rng.integers(0, TASK_COUNT, n)
    bad = tasks.copy()
    bad[17] = TASK_COUNT + 4  # global row 17 lies in shard 0
    return cols, tasks, {t: (3 * t + 1) % WORLD for t in range(TASK_COUNT)}, \
        bad


def run_tasks(ct, ctx, route: str) -> dict:
    from cylon_tpu_torch.plan.tasks import LogicalTaskPlan, task_exchange

    set_route(route)
    cols, tasks, mapping, bad = task_inputs()
    plan = LogicalTaskPlan(mapping, ctx.get_world_size())
    out = {"routed": export(task_exchange(ct.Table.from_pydict(ctx, cols),
                                          tasks, plan, ctx), ctx)}
    try:
        task_exchange(ct.Table.from_pydict(ctx, cols), bad, plan, ctx)
    except ct.CylonError as e:
        out["unknown"] = (e.code.name, str(e))
    out["after"] = export(task_exchange(ct.Table.from_pydict(ctx, cols),
                                        tasks, plan, ctx), ctx)
    return out


def main(argv) -> int:
    mode, rank, nproc, shards, rdv, out_dir, arg = argv[:7]
    device = argv[7] if len(argv) > 7 else "cpu"
    rank, nproc, shards = int(rank), int(nproc), int(shards)
    import torch

    torch.set_num_threads(1)
    import cylon_tpu_torch as ct
    import cylon_tpu_torch.parallel.dist_ops  # noqa: F401 (ct.parallel)

    ctx = _context(ct, rank, nproc, shards, rdv, device)
    result = {"ops": run_ops, "ingest": run_ingest,
              "tasks": run_tasks}[mode](ct, ctx, arg)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    ctx.barrier()
    ctx.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
