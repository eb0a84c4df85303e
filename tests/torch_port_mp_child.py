"""One process of a cylon_tpu_torch process group on the CPU, for
tests/test_torch_port_multiprocess.py and tests/test_torch_port_ingest.py.

    python tests/torch_port_mp_child.py ops RANK NPROC SHARDS RDV OUT ROUTE [DEVICE]
    python tests/torch_port_mp_child.py ingest RANK NPROC SHARDS RDV OUT DIR
    python tests/torch_port_mp_child.py tasks RANK NPROC SHARDS RDV OUT ROUTE

Each process joins a gloo process group through the ``file://``
rendezvous RDV (no port to race for) with SHARDS shards of its own, W =
NPROC * SHARDS. ``ops`` builds this process's shards of every case in
CASES from the case's seed, runs the case, and writes its shards' live
rows and the case's global row count to ``OUT/rank<RANK>.pkl``; ROUTE
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
         + list(SMALL_CASES))
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
    raise KeyError(name)


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
    if name == "sort":
        from cylon_tpu_torch.ops import order

        t = build(ct, ctx, data["t"])
        lanes = order.sort_keys([t._columns[0]], [True])
        extra["splitters"] = [tuple(int(x) for x in s) for s in
                              dist_ops._range_splitters(ctx, lanes,
                                                        t.emit_mask())]
        return dist_ops.distributed_sort(t, "k"), extra
    raise KeyError(name)


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
    for p in parts:
        assert p["rows"] == exp["rows"], (p["rows"], exp["rows"])
        assert p["names"] == exp["names"]
        for key in ("splitters", "chunks"):
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
        table, extra = run_case(ct, ctx, name)
        out[name] = dict(export(table, ctx), **extra)
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
