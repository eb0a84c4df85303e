"""Compare the kernels K1 partition_hist, K2 partition_scatter, K3
join_plan_stream, K4 join_expand_stream, K5 setop_stream and K6
stream_compact of two checkouts on one card, and split each wrapper
call's device time.

    python3 scripts/stream_kernels_ab.py --trees OLD,NEW,NEW,OLD
        [--rows N] [--setop-rows M] [--out PATH]

Each tree is a checkout root holding ``cylon_tpu_torch/`` and
``chip_smoke.py``. The trees run in the order given, each in a fresh
process (so list them in turns: old, new, new, old). In each process:

* build the tree's kernels;
* run ``chip_smoke.py``'s world-4 join (2 x N rows, ``force_exchange``)
  once on the kernel route, recording K1's, K2's, K3's and K4's inputs
  (each wrapper's first call), then time 5 steady walls of it;
* the same for the local UNION of 2 x M rows (K5's and K6's inputs);
* time each wrapper at those inputs (median of 7 CUDA-event-timed calls,
  as ``chip_smoke.py`` phase 8 does) and profile one wrapper call under
  ``torch.profiler``: its device time split into the port's own kernels
  (the ``__global__`` functions of the tree's ``csrc/``), copies and
  memsets, and other torch kernels (the glue between launches; the
  profiler can drop events of such short windows, so the port's own
  kernels are also timed by CUDA events around each launch).

Prints one JSON line per tree and the card's name and power limit; with
``--out`` also writes them to a file. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path


KERNELS = ("partition_hist", "partition_scatter", "join_plan_stream",
           "join_expand_stream", "setop_stream", "stream_compact")


def _dev_us(e) -> float:
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else getattr(e, "self_cuda_time_total", 0)


def own_kernel_names(tree: Path) -> set:
    """The ``__global__`` function names of the tree's CUDA sources."""
    names = set()
    for src in sorted((tree / "cylon_tpu_torch" / "csrc").glob("*.cu*")):
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            src.read_text()))
    return names


def classify(key: str, own: set) -> str:
    base = re.sub(r"^.*::", "", key.split("(")[0].split("<")[0]).strip()
    if base in own or any(f"{n}(" in key or f"{n}<" in key for n in own):
        return "kernel"
    low = key.lower()
    if "memset" in low:
        return "memset"
    if "memcpy" in low or "copy" in low:
        return "copy"
    return "glue"


def profile_split(torch, fn, own: set) -> dict:
    """One call of fn() under torch.profiler: device ms by category and
    the device events themselves."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the spans' ``cylon:`` ranges enclose kernels: not device work
    events = [(e.key, _dev_us(e) / 1e3, e.count)
              for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith("cylon:")]
    split = {"kernel": 0.0, "copy": 0.0, "memset": 0.0, "glue": 0.0}
    launches = {"kernel": 0, "copy": 0, "memset": 0, "glue": 0}
    for key, ms, count in events:
        c = classify(key, own)
        split[c] += ms
        launches[c] += count
    return {"ms": split, "launches": launches,
            "events": [(k[:100], ms, c) for k, ms, c in
                       sorted(events, key=lambda x: -x[1])]}


def launch_ms(torch, K, fn, reps: int = 5) -> float:
    """Median over ``reps`` calls of fn() of the summed CUDA-event time
    around each kernel launch the call makes (``kernels._launch``): the
    wrapper's own kernels without its copies and torch glue."""
    real = K._launch
    spans = []

    def timed(*args):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        real(*args)
        e.record()
        spans.append((s, e))

    sums = []
    K._launch = timed
    try:
        for _ in range(reps):
            spans.clear()
            fn()
            torch.cuda.synchronize()
            sums.append(sum(s.elapsed_time(e) for s, e in spans))
    finally:
        K._launch = real
    return statistics.median(sums)


def child(tree: Path, rows: int, setop_rows: int) -> dict:
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K

    assert Path(K.__file__).resolve().is_relative_to(tree.resolve()), \
        K.__file__
    own = own_kernel_names(tree)
    t0 = time.perf_counter()
    K.build()
    build_s = time.perf_counter() - t0
    res = {"tree": str(tree), "build_s": build_s}

    def walls(fn, reps=5):
        out = []
        for _ in range(reps):
            t = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t)
            del r
        return out

    def wrapper(name, call):
        res[name] = {"ms": cs.cuda_ms(call),
                     "kernel_ms": launch_ms(torch, K, call),
                     "profile": profile_split(torch, call, own)}

    # the join path: K1-K4's inputs from the world-4 join's first call
    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    left, right, _h = cs.make_tables(ct, dctx, rows, 0)
    torch.cuda.synchronize()

    def join():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    with cs.Recorder(K) as rec:
        first = join()
        torch.cuda.synchronize()
    res["join_rows_out"] = first.row_count
    del first
    res["join_walls_s"] = walls(join)
    _a, kw = rec.calls["join_plan_stream"]
    wrapper("join_plan_stream", lambda: K.join_plan_stream(**kw))
    k2, k2kw = rec.calls["partition_scatter"]
    wrapper("partition_scatter", lambda: K.partition_scatter(*k2, **k2kw))
    k1, k1kw = rec.calls["partition_hist"]
    wrapper("partition_hist", lambda: K.partition_hist(*k1, **k1kw))
    k4, k4kw = rec.calls["join_expand_stream"]
    wrapper("join_expand_stream",
            lambda: K.join_expand_stream(*k4, **k4kw))
    del rec, kw, k1, k1kw, k2, k2kw, k4, k4kw, left, right

    # the set-op path: K5's inputs from the local UNION's first call
    lctx = ct.CylonContext.Init()
    a, b, _p = cs.make_setop_tables(ct, lctx, setop_rows, 3)
    torch.cuda.synchronize()
    with cs.Recorder(K) as rec:
        first = a.union(b)
        torch.cuda.synchronize()
    res["union_rows_out"] = first.row_count
    del first
    res["union_walls_s"] = walls(lambda: a.union(b))
    args, kw = rec.calls["setop_stream"]
    wrapper("setop_stream", lambda: K.setop_stream(*args, **kw))
    k6, k6kw = rec.calls["stream_compact"]
    wrapper("stream_compact", lambda: K.stream_compact(*k6, **k6kw))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", help="comma-separated checkout roots")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--setop-rows", type=int, default=1 << 23)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.child:
        print("AB_RESULT " + json.dumps(child(Path(args.child), args.rows,
                                              args.setop_rows)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("stream_kernels_ab: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    results = []
    for tree in args.trees.split(","):
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             os.path.abspath(tree), "--rows", str(args.rows),
             "--setop-rows", str(args.setop_rows)],
            capture_output=True, text=True, timeout=1200)
        line = [x for x in p.stdout.splitlines()
                if x.startswith("AB_RESULT ")]
        if p.returncode != 0 or not line:
            print(p.stdout[-4000:], p.stderr[-8000:], file=sys.stderr)
            return 1
        r = json.loads(line[0][len("AB_RESULT "):])
        results.append(r)
        print(json.dumps({
            "tree": tree, "build_s": r["build_s"],
            "join_wall_median_s": statistics.median(r["join_walls_s"]),
            "union_wall_median_s": statistics.median(r["union_walls_s"]),
            **{k: {"ms": r[k]["ms"], "kernel_ms": r[k]["kernel_ms"],
                   "split_ms": r[k]["profile"]["ms"],
                   "split_launches": r[k]["profile"]["launches"]}
               for k in KERNELS}}),
            flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "results": results}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
