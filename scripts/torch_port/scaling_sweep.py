#!/usr/bin/env python
"""Scaling sweep of the port (counterpart of scripts/scaling_sweep.py).

World sizes 1, 2, 4 and 8 of the virtual world on one device, in both
scaling modes:

* strong: global rows fixed (2^rows_log2), rows a shard shrink with W;
* weak: rows a shard fixed (2^rows_log2 / 8), global rows grow with W.

Every point draws the JAX script's tables (``default_rng(world)``: an
int64 key uniform in [0, n) and a float32 payload a side) and times, the
best of 3 runs after one warm-up, each ending in
``torch.cuda.synchronize()``:

* ``count_phase_s``: the exchange's send-count matrix (K1's histogram on
  the card) and its host fetch (0.0 at world 1, where the dense exchange
  counts nothing);
* ``splitter_phase_s``: ``distributed_sort``'s range splitters (one
  sample fetch and the host quantiles);
* ``exchange_s`` / ``exchange_gb_per_s``: ``shuffle.exchange`` of the
  left table's key and payload (K1 + K2 from world 2);
* ``dist_join_s`` / ``dist_join_rows_per_s``: ``distributed_join(...,
  force_exchange=True)`` (K1-K4 on the card), the best of 2, and
  ``dist_join_rows_out``, the rows the join returned, checked against
  numpy; then ``join_speedup_vs_w1`` (strong) and ``weak_efficiency``
  (weak), both t(W1) / t(W).

All W shards of the virtual world share one device, so shard work runs
one shard after another: the sweep shows how the per-world fixed costs
grow with W, not a speedup across devices. ``diagnosis`` is written from
this run's numbers.

    python scripts/torch_port/scaling_sweep.py [rows_log2=24]
        [--device cuda|cpu] [--out PATH]

The last stdout line is the JSON summary, with the kernel launches; a
file is written only to ``--out``.
"""
import time

import numpy as np

import drill_common

WORLDS = (1, 2, 4, 8)


def _tables(ct, ctx, world: int, n: int):
    """The JAX script's draws, distributed over the world."""
    from cylon_tpu_torch.parallel import shard

    rng = np.random.default_rng(world)
    lk = rng.integers(0, n, n).astype(np.int64)
    lv = rng.normal(size=n).astype(np.float32)
    rk = rng.integers(0, n, n).astype(np.int64)
    rw = rng.normal(size=n).astype(np.float32)
    left = shard.distribute(ct.Table.from_pydict(ctx, {"k": lk, "v": lv}),
                            ctx)
    right = shard.distribute(ct.Table.from_pydict(ctx, {"k": rk, "w": rw}),
                             ctx)
    expect = int((np.bincount(lk, minlength=n).astype(np.int64)
                  * np.bincount(rk, minlength=n)).sum())
    return left, right, expect


def sweep_world(world: int, n: int, device) -> dict:
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.parallel import dist_ops as D
    from cylon_tpu_torch.parallel import shuffle as S

    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world),
                                          device=device)
    left, right, expect = _tables(ct, ctx, world, n)
    key = left._columns[0]
    targets = D._partition_targets_dist(world, [key])
    emit = left.emit_mask()
    payload = {"k": key.data, "v": left._columns[1].data}

    def best(fn, iters=3):
        return drill_common.best_of(fn, device, iters)

    # the count phase: the send-count matrix and its host fetch
    if world > 1:
        t_count = best(lambda: S._count_matrix(ctx.comm, targets,
                                               emit).cpu().numpy())
    else:
        t_count = 0.0
    lanes = D._dist_order_lanes(key, True)
    t_split = best(lambda: D._range_splitters(ctx, lanes, emit))
    dense = left.row_mask is None
    t_ex = best(lambda: S.exchange(payload, targets, emit, ctx,
                                   dense=dense))
    row_bytes = sum(x.element_size() for x in payload.values())
    cfg = ct.JoinConfig(ct.JoinType.INNER, [0], [0])

    def join():
        return D.distributed_join(left, right, cfg, force_exchange=True)

    t_join = best(join, iters=2)
    rows_out = join().row_count
    if rows_out != expect:
        raise AssertionError(f"world {world}: the join returned {rows_out} "
                             f"rows, numpy counts {expect}")
    return {
        "world": world,
        "global_rows": n,
        "rows_per_shard": n // world,
        "count_phase_s": t_count,
        "splitter_phase_s": t_split,
        "exchange_s": t_ex,
        "exchange_gb_per_s": n * row_bytes / t_ex / 1e9,
        "dist_join_s": t_join,
        "dist_join_rows_per_s": 2 * n / t_join,
        "dist_join_rows_out": rows_out,
    }


def diagnosis(strong: list, weak: list, device) -> str:
    """What this run's numbers say, in words."""
    s1, s8 = strong[0], strong[-1]
    w1, w8 = weak[0], weak[-1]
    share = [r["count_phase_s"] + r["splitter_phase_s"] for r in strong]
    return (
        f"On {drill_common.card_name(device)}, the W shards of the virtual "
        f"world share the device, so shard work runs one shard after "
        f"another. Strong scaling ({s1['global_rows']} rows): the forced-"
        f"exchange join takes {s1['dist_join_s']:.6f} s at world 1 and "
        f"{s8['dist_join_s']:.6f} s at world 8 (speedup "
        f"{s8['join_speedup_vs_w1']:.3f}); the exchange moves "
        f"{s1['exchange_gb_per_s']:.3f} GB/s at world 1 and "
        f"{s8['exchange_gb_per_s']:.3f} GB/s at world 8. The per-world "
        f"fixed costs, count phase plus splitters, grow from "
        f"{share[0]:.6f} s to {share[-1]:.6f} s. Weak scaling "
        f"({w1['rows_per_shard']} rows a shard): the join takes "
        f"{w1['dist_join_s']:.6f} s at world 1 and {w8['dist_join_s']:.6f} "
        f"s at world 8 for 8 times the rows (efficiency "
        f"{w8['weak_efficiency']:.3f}), which on one device measures how "
        f"close the join stays to linear in its rows.")


def main(argv=None) -> dict:
    args = drill_common.tool_parser(__doc__.split("\n")[0], 24,
                                    "the strong-scaling global rows"
                                    ).parse_args(argv)
    device = drill_common.device_of(args.device)
    launches0 = drill_common.launches()
    n = 1 << args.rows_log2
    res = {"backend": device.type, "device": drill_common.card_name(device),
           "modes": {}}
    t0 = time.perf_counter()
    strong = {"mode": "strong-scaling", "global_rows": n, "worlds": []}
    for w in WORLDS:
        strong["worlds"].append(sweep_world(w, n, device))
    base = strong["worlds"][0]["dist_join_s"]
    for r in strong["worlds"]:
        r["join_speedup_vs_w1"] = base / r["dist_join_s"]
    res["modes"]["strong"] = strong

    per_shard = n // 8
    weak = {"mode": "weak-scaling", "rows_per_shard": per_shard,
            "worlds": []}
    for w in WORLDS:
        weak["worlds"].append(sweep_world(w, per_shard * w, device))
    base = weak["worlds"][0]["dist_join_s"]
    for r in weak["worlds"]:
        # ideal weak scaling: the time stays flat as W and the rows grow
        r["weak_efficiency"] = base / r["dist_join_s"]
    res["modes"]["weak"] = weak
    res["diagnosis"] = diagnosis(strong["worlds"], weak["worlds"], device)
    res["wall_s"] = time.perf_counter() - t0
    return drill_common.finish(res, args.out, launches0)


if __name__ == "__main__":
    main()
