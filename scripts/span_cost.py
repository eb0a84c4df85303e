"""What the port's telemetry costs on the card: one ``MemoryPool``
snapshot and its parts (the allocator's nested stats, the device
properties), a ``torch.profiler.record_function`` range entered with no
profiler running (the spans skip it then), one empty span with its
per-span memory attributes on and off (``CYLON_HBM_SPAN_ATTRS``), and
chip_smoke.py's world-4 join (phase 2: 2 x N rows, ``force_exchange``)
with the attributes on and off in turns, with the number of spans one
join opens.

    python3 scripts/span_cost.py [--rows N] [--out PATH]

Prints one JSON line and the card's name and power limit. Needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def per_call_us(fn, calls: int = 20000) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("span_cost: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import telemetry

    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    pool = dctx.memory_pool
    snapshot_us = per_call_us(pool.snapshot)
    dev = pool.device
    parts_us = {
        "memory_stats_as_nested_dict": per_call_us(
            lambda: torch.cuda.memory_stats_as_nested_dict(dev)),
        "get_device_properties": per_call_us(
            lambda: torch.cuda.get_device_properties(dev)),
        "memory_allocated": per_call_us(
            lambda: torch.cuda.memory_allocated(dev)),
    }

    def bare_record_function():
        with torch.profiler.record_function("cylon:span_cost"):
            pass

    record_function_us = per_call_us(bare_record_function)

    def empty_span():
        with telemetry.span("span_cost.empty"):
            pass

    span_us = {}
    for knob in ("1", "0"):
        os.environ["CYLON_HBM_SPAN_ATTRS"] = knob
        span_us[knob] = per_call_us(empty_span, 5000)
    os.environ.pop("CYLON_HBM_SPAN_ATTRS", None)

    left, right, _h = cs.make_tables(ct, dctx, args.rows, 0)

    def join():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    with telemetry.collect_phases() as cp:
        join()
        torch.cuda.synchronize()
    walls = {"1": [], "0": []}
    for knob in ("1", "0"):
        os.environ["CYLON_HBM_SPAN_ATTRS"] = knob
        join()
        torch.cuda.synchronize()
    for i in range(args.rounds):
        for knob in (("1", "0") if i % 2 == 0 else ("0", "1")):
            os.environ["CYLON_HBM_SPAN_ATTRS"] = knob
            t0 = time.perf_counter()
            out = join()
            torch.cuda.synchronize()
            walls[knob].append(time.perf_counter() - t0)
            del out
    os.environ.pop("CYLON_HBM_SPAN_ATTRS", None)
    res = {"rows": args.rows, "snapshot_us": snapshot_us,
           "snapshot_parts_us": parts_us,
           "record_function_us": record_function_us,
           "empty_span_us": {"hbm_attrs_on": span_us["1"],
                             "hbm_attrs_off": span_us["0"]},
           "join_spans": len(cp.labels), "join_labels": cp.labels,
           "join_walls_s": {"hbm_attrs_on": walls["1"],
                            "hbm_attrs_off": walls["0"]},
           "join_median_ms": {
               "hbm_attrs_on": statistics.median(walls["1"]) * 1e3,
               "hbm_attrs_off": statistics.median(walls["0"]) * 1e3}}
    card = cs.card_line()
    print(json.dumps(res), flush=True)
    print(card, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, card=card), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
