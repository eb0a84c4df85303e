"""Run one cell once: find the card, draw the tables from the seed, warm
the cell's query, run a closed loop of one client for the window, check
a sampled result against the plain reference, print the result line.

Everything that belongs to one configuration, cell, metric or kernel is
a file the harness finds by name: ``configs/<config>.json`` (the file
``BENCHMARK.json`` names), ``workloads/<cell>.json``, ``e2e/<metric>.py``,
``metrics/<metric>.py``, ``rooflines/<kernel>.py``, ``queries/<op>.py``
and ``reference/<op>.py``; ``kernels.json`` names the device symbols of
each of the port's hand-written kernels. A cell of several processes
(its chips times its ``processes_per_chip``) starts one process a rank,
joined by the port's ``MultiHostConfig`` (NCCL on the card, gloo on the
CPU); rank 0
prints the line. A cell of one process runs a virtual world of its
``shards_per_process`` shards (V, default 1; the name and meaning of
``MultiHostConfig(shards_per_process=)``): at V > 1 set-up splits each
table into V contiguous blocks of rows (``shard.distribute``) and the
queries take the port's distributed path at world V on the one device;
V = 1 is the plain one-shard run. A cell of several processes with V >
1 is refused before any run.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import random
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cylon_tpu")
CHILD_TIMEOUT_S = 300
# when torch and then the port had been imported (set-up's first marks)
IMPORTED: Dict[str, float] = {}


def fail(msg: str, code: int = 2) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def forbidden_modules() -> List[str]:
    """Loaded modules of JAX or of the JAX package, by whole top-level
    name (``cylon_tpu_torch`` is not ``cylon_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A reader file by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench._found." + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def processes(self) -> int:
        return self.chips * int(self.workload.get("processes_per_chip", 1))

    @property
    def shards(self) -> int:
        """V, the shards of each process (``shards_per_process``)."""
        return self.workload.get("shards_per_process", 1)


def layout_refusal(cell: Cell) -> Optional[str]:
    """Why the harness cannot lay out the cell's shards, or None."""
    v = cell.shards
    if isinstance(v, bool) or not isinstance(v, int) or v < 1:
        return (f"cell {cell.name}: shards_per_process must be a positive "
                f"integer, got {v!r}")
    if v > 1 and cell.processes > 1:
        return (f"cell {cell.name}: shards_per_process {v} in a cell of "
                f"{cell.processes} processes: the harness runs V > 1 "
                "shards in one process only")
    return None


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    wl = load_json(root / "portbench" / "workloads" / f"{name}.json")
    if wl.get("loop", "closed") != "closed" or wl.get("clients", 1) != 1:
        raise ValueError(f"cell {name}: the harness runs a closed loop of "
                         "one client only")
    return Cell(name, int(entry["chips"]), wl,
                load_json(root / cfg_entry["file"]),
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


@dataclass
class Reading:
    """What one run measured, as the metric readers see it."""
    queries: int
    window_s: float
    latencies: List[float]
    setup_s: float
    rows_per_query: int
    window_peak_bytes: int
    stats: dict
    peaks: dict
    trace: object = None
    rooflines: Dict[str, object] = field(default_factory=dict)
    kernels: Dict[str, List[str]] = field(default_factory=dict)

    def kernel_symbols(self) -> List[str]:
        return [p for ps in self.kernels.values() for p in ps]


def kernel_symbols(here: Path = HERE) -> Dict[str, List[str]]:
    """Each hand-written kernel's device symbol patterns: ``kernels.json``,
    and the ``SYMBOLS`` of a roofline file whose kernel it lacks."""
    out = {k: list(v) for k, v in load_json(here / "kernels.json").items()}
    for p in sorted((here / "rooflines").glob("*.py")):
        if p.stem != "__init__":
            out.setdefault(p.stem, list(getattr(load_module(p), "SYMBOLS",
                                                ())))
    return out


def roofline_modules(here: Path = HERE) -> Dict[str, object]:
    return {p.stem: load_module(p) for p in sorted(
        (here / "rooflines").glob("*.py")) if p.stem != "__init__"}


class Device:
    """The few calls that differ between the card and the CPU."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.cuda = dev.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.dev)

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated(self.dev) \
            if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats(self.dev)

    def free(self):
        if self.cuda:
            self.torch.cuda.empty_cache()

    def kind(self) -> str:
        return self.torch.cuda.get_device_name(self.dev) if self.cuda \
            else "cpu"


def query_tables(cell: Cell) -> List[str]:
    q = cell.workload["query"]
    return [v for k, v in q.items() if k in ("left", "right", "table")]


def table_stats(tables) -> dict:
    """Rows, bytes a row of each column (a string's own bytes) and the
    float columns of each table."""
    import torch

    def tensor(x):
        return isinstance(x, torch.Tensor)

    return {t: {"rows": len(cols[0][1]),
                "columns": {c: x.element_size() if tensor(x) else x.width
                            for c, x in cols},
                "float_columns": [c for c, x in cols
                                  if tensor(x) and x.is_floating_point()]}
            for t, cols in tables.items()}


def string_column(ct, x, name: str):
    """The port's column of a drawn string column (``gen.Strings``),
    built on the device in the form the port's own ingest gives such
    values: a sorted vocabulary and int32 codes where the vocabulary is
    small (``Column._encode_strings``'s rule), word-aligned varbytes
    otherwise."""
    import numpy as np
    import torch
    from cylon_tpu_torch.data import strings
    from cylon_tpu_torch.util import capacity

    n = len(x)
    if x.high - x.low <= min(strings.DICT_MAX_VOCAB,
                             max(16, int(n * strings.DICT_MAX_RATIO))):
        return ct.Column((x.values - x.low).to(torch.int32),
                         ct.dtypes.String(), None, name,
                         dictionary=np.array(x.vocab()))
    rows = x.utf8(pad_to=4)
    nw = rows.shape[1] // 4
    total = n * nw
    dev = rows.device
    words = torch.zeros(capacity(max(total, 1)), dtype=torch.int32,
                        device=dev)
    words[:total] = rows.view(torch.int32).reshape(-1)
    del rows
    vb = strings.VarBytes(
        words, torch.arange(0, total, nw, dtype=torch.int32, device=dev),
        torch.full((n,), x.width, dtype=torch.int32, device=dev), nw, total)
    return ct.Column.from_varbytes(vb, None, name)


def ingest(ct, ctx, tables, nproc: int):
    """The program's tables from the drawn columns: each process's
    share assembled into one sharded table across processes; in a
    virtual world of one process, each table split into its shards'
    contiguous blocks of rows."""
    import numpy as np
    import torch

    def column(c, x):
        if not isinstance(x, torch.Tensor):
            return string_column(ct, x, c)
        return ct.Column(x, ct.dtypes.from_np_dtype(
            np.dtype(str(x.dtype).split(".")[-1])), None, c)

    out = {}
    for tname, cols in tables.items():
        t = ct.Table([column(c, x) for c, x in cols], ctx)
        if nproc > 1 or ctx.get_world_size() > 1:
            from cylon_tpu_torch.parallel import shard

            t = shard.assemble_process_local([t], ctx) if nproc > 1 \
                else shard.distribute(t, ctx)
        out[tname] = t
    return out


def live_columns(table) -> list:
    """A result table's live rows, column by column."""
    import torch

    cols = [c.data for c in table.columns()]
    mask = table.row_mask
    if mask is not None:
        idx = torch.nonzero(mask).flatten()
        cols = [x[idx] for x in cols]
    return cols


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # set by the harness for the ranks it starts, never by hand
    p.add_argument("--rank", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--rdv", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "portbench" / "_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def start_ranks(argv, nproc: int, device: str) -> tuple:
    rdv = f"tcp://localhost:{free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "run.py"), *argv, "--rank", str(r),
         "--rdv", rdv, "--device", device],
        stdout=subprocess.DEVNULL, cwd=str(ROOT))
        for r in range(1, nproc)]
    return rdv, procs


def wait_ranks(procs) -> List[int]:
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=CHILD_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs


def program_inside(root: Path) -> Optional[str]:
    """Why the port cannot be measured from this checkout, or None: it
    must import, and from the checkout, not from an installed copy."""
    import torch  # noqa: F401

    IMPORTED["torch"] = time.perf_counter()
    try:
        import cylon_tpu_torch as ct
    except ImportError as e:
        return f"the port does not import: {e}"
    IMPORTED["port"] = time.perf_counter()
    got = os.path.abspath(ct.__file__)
    if not got.startswith(os.path.abspath(root) + os.sep):
        return f"cylon_tpu_torch came from {got}, outside {root}"
    return None


def main(argv, started: float, device: str = "cuda",
         root: Path = ROOT) -> int:
    """Run the cell of ``argv`` once on ``device`` ("cuda" from run.py;
    the tests drive the same run on "cpu") and print its line."""
    args = parse(argv)
    cell = load_cell(args.workload, root)
    why = layout_refusal(cell)
    if why:
        return fail(why)
    nproc = cell.processes
    cache_dirs(root)
    import torch

    child = args.rank is not None and args.rank > 0
    dev_kind = args.device if child else device
    if dev_kind == "cuda":
        if not torch.cuda.is_available():
            return fail("no CUDA device: the benchmark runs on the card "
                        "only")
        if torch.cuda.device_count() < cell.chips:
            return fail(f"cell {cell.name} needs {cell.chips} cards, found "
                        f"{torch.cuda.device_count()}")
    procs = []
    rank, rdv = args.rank or 0, args.rdv
    if nproc > 1 and args.rank is None:
        rdv, procs = start_ranks(argv, nproc, dev_kind)
    try:
        rc = run_rank(args, cell, started, dev_kind, rank, rdv, root)
    finally:
        rcs = wait_ranks(procs)
    if any(rcs):
        return fail(f"ranks ended with {rcs}")
    return rc


def run_rank(args, cell: Cell, started: float, dev_kind: str, rank: int,
             rdv: Optional[str], root: Path) -> int:
    import torch

    nproc = cell.processes
    now = time.perf_counter()
    marks = [("start", started)] + [
        (k, max(started, IMPORTED.get(k, now))) for k in ("torch", "port")]
    torch.set_num_threads(min(torch.get_num_threads(), 4))
    if dev_kind == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    else:
        dev = torch.device("cpu")
    marks.append(("cuda", time.perf_counter()))
    D = Device(torch, dev)
    import cylon_tpu_torch as ct


    if nproc > 1:
        ctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
            num_processes=nproc, process_id=rank, init_method=rdv,
            backend="nccl" if D.cuda else "gloo"), device=dev)
    else:
        ctx = ct.CylonContext.InitDistributed(
            ct.VirtualWorldConfig(cell.shards), device=dev)
    import portbench.gen as gen
    from portbench import check, queries, reference

    marks.append(("context", time.perf_counter()))
    wl, cfg = cell.workload, cell.config
    q = wl["query"]
    names = query_tables(cell)
    drawn = {t: c for t, c in gen.make_tables(cfg, args.seed, dev).items()
             if t in names}
    tstats = table_stats(drawn)
    if nproc > 1:
        drawn = gen.rank_slice(drawn, rank, nproc)
    tables = ingest(ct, ctx, drawn, nproc)
    del drawn
    D.sync()
    marks.append(("tables", time.perf_counter()))
    runner = queries.module(q["op"])
    for _ in range(int(wl.get("warmup_queries", 2))):
        runner.run(tables, q)
        D.sync()
    marks.append(("warm", time.perf_counter()))
    setup_s = marks[-1][1] - started
    print("portbench: setup " + " ".join(
        f"{b[0]}={b[1] - a[1]:.3f}s" for a, b in zip(marks, marks[1:])),
        file=sys.stderr)
    print(f"portbench: world {ctx.get_world_size()} shards in {nproc} "
          f"process{'es' if nproc > 1 else ''}", file=sys.stderr)
    setup_peak = D.peak()
    D.reset_peak()

    pick = random.Random(args.seed)
    lat: List[float] = []
    failed = 0
    sample = None
    prof = None
    stop = torch.zeros(1, dtype=torch.float64, device=dev)
    mark_query = contextlib.nullcontext
    if args.trace:
        from torch.profiler import record_function

        from portbench import trace as _trace

        def mark_query():
            return record_function(_trace.QUERY_LABEL)

    def window():
        nonlocal failed, sample
        t0 = time.perf_counter()
        now = t0
        while True:
            a = time.perf_counter()
            try:
                with mark_query():
                    out = runner.run(tables, q)
                    D.sync()
            except (RuntimeError, ValueError, ct.CylonError) as e:
                failed += 1
                print(f"portbench: query failed: {e!r}", file=sys.stderr)
                out = None
            now = time.perf_counter()
            lat.append(now - a)
            if out is not None and pick.random() * len(lat) < 1.0:
                sample = out
            out = None
            if nproc > 1:
                stop.fill_(float(now - t0 >= args.seconds))
                torch.distributed.all_reduce(
                    stop, op=torch.distributed.ReduceOp.MAX)
                if stop.item() > 0:
                    break
            elif now - t0 >= args.seconds:
                break
        return now - t0

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if D.cuda else [])
        with profile(activities=acts) as prof:
            with record_function(_trace.WINDOW_LABEL):
                window_s = window()
    else:
        window_s = window()
    window_peak = D.peak()
    prog = live_columns(sample) if sample is not None else None
    sample = None
    del tables
    D.free()
    full = gen.make_tables(cfg, args.seed, dev)
    ref_cols, scales, rstats = reference.module(q["op"]).compute(
        {t: full[t] for t in names}, q)
    ref_rows = rstats["out_rows"]
    if prog is not None:
        loc = check.local_numbers(prog, ref_cols, scales, wl["check"])
    else:
        loc = {"rows": 0.0, "mismatched": float(ref_rows),
               "gap": float("inf")}
    del full, ref_cols, scales, prog
    summed = dict(loc)
    agg = {"failed": float(failed),
           "peak": float(max(setup_peak, window_peak))}
    if nproc > 1:
        summed = reduce(torch, dev, loc, {"rows": "sum", "mismatched": "sum",
                                          "gap": "max"})
        agg = reduce(torch, dev, agg, {"failed": "sum", "peak": "max"})
    nums = check.numbers(summed, ref_rows, wl["check"])
    limits = {k: float(wl["limits"][k]) for k in nums}
    correct = check.verdict(nums, limits) and agg["failed"] == 0
    # a process of several does its share of each query's work
    stats = dict(rstats, op=q["op"], query=q, tables=tstats,
                 share=1.0 / nproc)
    reading = Reading(len(lat), window_s, lat, setup_s,
                      sum(tstats[t]["rows"] for t in names), window_peak,
                      stats, load_json(HERE / "peaks.json"))
    metrics, extra = {}, {}
    if args.trace:
        from portbench import trace as _trace

        tr = _trace.from_profiler(prof)
        reading.trace = tr
        reading.rooflines = roofline_modules()
        reading.kernels = kernel_symbols()
        busy = _trace.busy_s(tr)
        if nproc > 1:
            m = reduce(torch, dev, {"b": busy, "w": tr.window_s},
                       {"b": "sum", "w": "sum"})
            busy, win = m["b"] / nproc, m["w"] / nproc
        else:
            win = tr.window_s
        extra = {"busy_s": busy, "window_s": win}
        for m in cell.per_layer:
            v = load_module(HERE / "metrics" / f"{m['name']}.py").read(
                reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": _trace.top_device_ops(tr),
                     "idle_gaps": _trace.gap_owners(tr)}
    else:
        for m in cell.end_to_end:
            v = load_module(HERE / "e2e" / f"{m['name']}.py").read(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the last look, once everything the run loads has loaded: no result
    # from a process, or a process beside it, that holds JAX
    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: JAX or the JAX package loaded: {leaked}",
              file=sys.stderr, flush=True)
    n_leaked = float(len(leaked))
    if nproc > 1:
        n_leaked = reduce(torch, dev, {"n": n_leaked}, {"n": "sum"})["n"]
        ctx.finalize()
    if n_leaked:
        return fail("no result: JAX or the JAX package is loaded", 3)
    if rank != 0:
        return 0
    line = {"correct": bool(correct), "attempted": len(lat),
            "failed": int(agg["failed"]), "metrics": metrics,
            "device": {"platform": "gpu" if D.cuda else "cpu",
                       "kind": D.kind(), "count": cell.chips,
                       "memory_peak_bytes": int(agg["peak"]), **extra}}
    if args.trace:
        line["breakdown"] = breakdown
    line["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                      for k in nums}
    for k in nums:
        print(f"check {k} {nums[k]!r} limit {limits[k]!r}", file=sys.stderr)
    print(f"check failed_queries {int(agg['failed'])} limit 0",
          file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def reduce(torch, dev, vals: Dict[str, float], how: Dict[str, str]):
    """``vals`` summed or maxed over the processes."""
    out = {}
    for k, v in vals.items():
        t = torch.tensor([v], dtype=torch.float64, device=dev)
        op = torch.distributed.ReduceOp.SUM if how[k] == "sum" \
            else torch.distributed.ReduceOp.MAX
        torch.distributed.all_reduce(t, op=op)
        out[k] = float(t.item())
    return out
