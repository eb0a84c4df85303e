"""Where the time of cylon_tpu_torch's groupby and sort paths goes, on one
NVIDIA H100.

    python3 scripts/profile_port_groupby.py [--pipeline-rows P]
        [--groupby-rows G] [--out PATH]

For each path of chip_smoke.py's phases 10-12 (the same tables, seeds and
calls): the median wall of 5 steady runs after one warm-up, then one run
under torch.profiler with its device busy time, idle share and top device
entries. The join -> groupby pipeline is also split into its join and its
groupby (the groupby timed on a join output made beforehand), and the
groupby into phase A (per-shard partials) and phase B (their exchange
and merge). Needs CUDA; exits 1 without it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as CS  # noqa: E402


def median_wall(fn, reps: int = 5) -> float:
    return statistics.median(CS.steady(fn, reps))


def record(name: str, fn, out: dict) -> None:
    wall = median_wall(fn)
    prof = CS.profile_once(fn)
    out[name] = {"median_wall_ms": wall * 1e3, "profile": prof}
    CS.log(f"{name}: median wall {wall * 1e3:.3f} ms; profiled wall "
           f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
           f"(idle share {prof['idle_share']:.4f}); top device time:")
    for k, ms, c in prof["top"]:
        CS.log(f"    {ms:9.3f} ms  x{c:<4d} {k}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pipeline-rows", type=int, default=1 << 23)
    ap.add_argument("--groupby-rows", type=int, default=1 << 24)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port_groupby: CUDA is not available", file=sys.stderr)
        return 1
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K
    from cylon_tpu_torch.ops import order
    from cylon_tpu_torch.parallel import dist_ops as D

    card = CS.card_line()
    CS.log(card)
    K.build()
    out = {"card": card}
    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(CS.WORLD))
    lctx = ct.CylonContext.Init()

    # join -> groupby (phase 10's tables)
    n = args.pipeline_rows
    rng = np.random.default_rng(9)
    left = ct.Table.from_pydict(dctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "v": rng.normal(size=n).astype(np.float32),
        "z": rng.integers(0, 50, n).astype(np.int32)})
    right = ct.Table.from_pydict(dctx, {
        "k": rng.integers(0, n // 4, n).astype(np.int32),
        "w": rng.normal(size=n).astype(np.float32)})
    cfg = ct.JoinConfig(ct.JoinType.INNER, [0], [0])
    agg = [ct.AggregationOp.SUM]

    def join():
        return D.distributed_join(left, right, cfg)

    j = join()
    CS.sync()
    out["join_output"] = {"rows": j.row_count, "capacity": j.capacity}
    record("join_groupby", lambda: D.distributed_groupby(join(), [0], [4],
                                                         agg), out)
    record("join_only", join, out)
    record("groupby_of_join_output",
           lambda: D.distributed_groupby(j, [0], [4], agg), out)
    kc = j._columns[0]
    record("phase_a_partials", lambda: D._shard_groupby(
        CS.WORLD, order.sort_keys([kc]), [kc.data], [kc.valid_mask()],
        j.emit_mask(), [j._columns[4].data], [None], agg, [4], [True]), out)
    del j

    # groupby (phase 11's table) and sort (phase 12's)
    g = args.groupby_rows
    rng = np.random.default_rng(1)
    garr = {"g": rng.integers(0, 1 << 20, g).astype(np.int32),
            "x": rng.normal(size=g).astype(np.float32),
            "y": rng.integers(0, 100, g).astype(np.int32)}
    rng = np.random.default_rng(2)
    sarr = {"k": rng.integers(0, 1 << 31, g).astype(np.int32),
            "v": rng.normal(size=g).astype(np.float32)}
    for ctx, world in ((lctx, 1), (dctx, CS.WORLD)):
        t = ct.Table.from_pydict(ctx, garr)
        record(f"groupby_world{world}", lambda: t.groupby(
            0, [1, 2, 1], ["sum", "count", "mean"]), out)
        s = ct.Table.from_pydict(ctx, sarr)
        record(f"sort_world{world}", (lambda: s.sort("k")) if world == 1
               else (lambda: D.distributed_sort(s, "k",
                                                force_exchange=True)), out)
        del t, s
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    CS.log(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
