#!/usr/bin/env python
"""Phase profile of the port's distributed join (counterpart of
scripts/profile_dist_join.py).

chip_smoke.py phase 2's join: two tables of 2^rows_log2 rows
(``default_rng(0)``: an int32 key uniform in [0, n) and a float32
payload a side), an inner join on the key on a virtual world of
``--world`` shards (default 4), taken apart into the phases
``dist_ops.distributed_join`` runs. Each phase is the best of 3 runs
after one warm-up, each ending in ``torch.cuda.synchronize()``:

* ``host_round_trip_s``: a one-element device -> host copy;
* ``keybits_targets_both_s``: both sides' key bits and key-hash targets;
* ``count_pair_s``: both send-count matrices (K1 on the card) and their
  one host fetch (``shuffle.count_pair``);
* ``exchange_left_s`` / ``exchange_right_s``: each side's table exchange
  with its counts given (K1 + K2);
* ``plan_plus_sync_s``: the shuffled sides' key bits and payload lanes,
  the stream sort and K3 (``ops/join.plan_join`` through
  ``dist_ops._fetched_plan``), with its count fetch;
* ``materialize_s``: the agreed capacity, K4 and the output lanes and
  gathers (``JoinPlan.materialize``);
* ``sum_phases_s``, and ``join_wall_s`` the whole
  ``distributed_join(..., force_exchange=True)`` beside it;
* ``broadcast_s``: ``broadcast_hash_join(..., build_side=1)`` at
  chip_smoke.py phase 18's shapes (2^bcast_rows_log2 probe rows, a
  thousandth as many build rows, keys in [0, build rows // 2),
  ``default_rng(21)``): no exchange, K3/K4; ``broadcast_build_rows``.

``rows_out`` (the join) and ``broadcast_rows_out`` are the rows each
returned, checked against numpy; ``route`` is the per-shard plan's route
(``stream`` on the card).

    python scripts/torch_port/profile_dist_join.py [rows_log2=24]
        [--world W] [--bcast-rows-log2 B] [--device cuda|cpu] [--out PATH]

The last stdout line is the JSON summary, with the kernel launches; a
file is written only to ``--out``.
"""
import numpy as np

import drill_common


def main(argv=None) -> dict:
    p = drill_common.tool_parser(__doc__.split("\n")[0], 24,
                                 "the rows a side")
    p.add_argument("--world", type=int, default=4,
                   help="shards of the virtual world (default 4)")
    p.add_argument("--bcast-rows-log2", type=int, default=22,
                   help="log2 of the broadcast join's probe rows "
                        "(default 22)")
    args = p.parse_args(argv)
    device = drill_common.device_of(args.device)
    launches0 = drill_common.launches()

    import torch

    import cylon_tpu_torch as ct
    from cylon_tpu_torch.data import table as table_mod
    from cylon_tpu_torch.data.table import Table
    from cylon_tpu_torch.parallel import dist_ops as D
    from cylon_tpu_torch.parallel import shard
    from cylon_tpu_torch.parallel.shuffle import count_pair

    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(args.world),
                                          device=device)
    cm = ctx.comm
    world, v = cm.world, cm.shards
    n = 1 << args.rows_log2
    rng = np.random.default_rng(0)
    lk = rng.integers(0, n, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    rk = rng.integers(0, n, n).astype(np.int32)
    rv = rng.normal(size=n).astype(np.float32)
    left = shard.distribute(ct.Table.from_pydict(ctx, {"k": lk, "v": lv}),
                            ctx)
    right = shard.distribute(ct.Table.from_pydict(ctx, {"k": rk, "w": rv}),
                             ctx)
    expect = int((np.bincount(lk, minlength=n).astype(np.int64)
                  * np.bincount(rk, minlength=n)).sum())
    config = ct.JoinConfig(ct.JoinType.INNER, [0], [0])
    jt = config.type

    def best(fn):
        return drill_common.best_of(fn, device)

    res = {"n_rows": n, "world": world, "backend": device.type,
           "device": drill_common.card_name(device)}
    probe = torch.zeros(1, dtype=torch.int32, device=device)
    res["host_round_trip_s"] = best(lambda: probe.cpu())

    lcols, rcols = D._align_key_columns_dist(left, right, [0], [0], cm)

    def keybits_targets(cols, other):
        return (D._dist_key_bits(cols, other),
                D._partition_targets_dist(world, cols, other))

    res["keybits_targets_both_s"] = best(
        lambda: (keybits_targets(lcols, rcols),
                 keybits_targets(rcols, lcols)))
    _lb, lt = keybits_targets(lcols, rcols)
    _rb, rt = keybits_targets(rcols, lcols)
    lemit, remit = left.emit_mask(), right.emit_mask()
    res["count_pair_s"] = best(lambda: count_pair(lt, lemit, rt, remit, ctx))
    cl, cr = count_pair(lt, lemit, rt, remit, ctx)

    def exch(t, targets, emit, counts):
        return D._exchange_table(t, targets, emit, ctx, counts=counts,
                                 dense=t.row_mask is None)[:2]

    res["exchange_left_s"] = best(lambda: exch(left, lt, lemit, cl))
    res["exchange_right_s"] = best(lambda: exch(right, rt, remit, cr))
    lcols_s, lemit_s = exch(left, lt, lemit, cl)
    rcols_s, remit_s = exch(right, rt, remit, cr)

    def plan_inputs():
        """distributed_join's inputs of the per-shard plan, from the
        shuffled columns."""
        left_s = Table(list(lcols_s), ctx, lemit_s)
        right_s = Table(list(rcols_s), ctx, remit_s)
        lc2, rc2 = D._align_key_columns_dist(left_s, right_s, [0], [0], cm)
        lkb, lkv = D._dist_key_bits(lc2, rc2)
        rkb, rkv = D._dist_key_bits(rc2, lc2)
        alias = table_mod._alias_right_keys(left_s, right_s, config)
        ldat, lval, _ls = table_mod.lane_payload(lcols_s)
        rdat, rval, _rs = table_mod.lane_payload(rcols_s, skip=alias)
        lval = [c.valid_mask() for c in lcols_s] + list(lval[len(lcols_s):])
        rval = [c.valid_mask() for c in rcols_s] + list(rval[len(rcols_s):])
        return (D._shards(lkb, v), lkv.view(v, -1), lemit_s.view(v, -1),
                D._shards(rkb, v), rkv.view(v, -1), remit_s.view(v, -1),
                D._shards(ldat, v), D._shards_opt(lval, v),
                D._shards(rdat, v), D._shards_opt(rval, v))

    def plan():
        inputs = plan_inputs()
        return inputs, D._fetched_plan(cm, *inputs, jt)

    res["plan_plus_sync_s"] = best(plan)
    inputs, (jplan, host) = plan()
    res["route"] = jplan.route
    ldat, lval, rdat, rval = inputs[6:]

    def materialize():
        cap, cap_u = D._shard_caps(cm, jplan, host)
        return jplan.materialize(ldat, lval, rdat, rval, cap, cap_u)

    res["materialize_s"] = best(materialize)
    res["sum_phases_s"] = (res["keybits_targets_both_s"]
                           + res["count_pair_s"] + res["exchange_left_s"]
                           + res["exchange_right_s"]
                           + res["plan_plus_sync_s"] + res["materialize_s"])

    def join():
        return D.distributed_join(left, right, config, force_exchange=True)

    res["join_wall_s"] = best(join)
    res["rows_out"] = join().row_count
    if res["rows_out"] != expect:
        raise AssertionError(f"the join returned {res['rows_out']} rows, "
                             f"numpy counts {expect}")

    # the broadcast join at phase 18's shapes
    nb_probe = 1 << args.bcast_rows_log2
    brng = np.random.default_rng(21)
    n_build = max(nb_probe // 1000, 64)
    keys = max(n_build // 2, 1)
    bk = brng.integers(0, keys, nb_probe).astype(np.int32)
    bv = brng.normal(size=nb_probe).astype(np.float32)
    sk = brng.integers(0, keys, n_build).astype(np.int32)
    sv = brng.normal(size=n_build).astype(np.float32)
    fact = ct.Table.from_pydict(ctx, {"k": bk, "v": bv})
    dim = ct.Table.from_pydict(ctx, {"k": sk, "w": sv})
    res["broadcast_build_rows"] = n_build

    def bcast():
        return D.broadcast_hash_join(fact, dim, config, build_side=1)

    res["broadcast_s"] = best(bcast)
    res["broadcast_rows_out"] = bcast().row_count
    bexpect = int((np.bincount(bk, minlength=keys).astype(np.int64)
                   * np.bincount(sk, minlength=keys)).sum())
    if res["broadcast_rows_out"] != bexpect:
        raise AssertionError(f"the broadcast join returned "
                             f"{res['broadcast_rows_out']} rows, numpy "
                             f"counts {bexpect}")
    return drill_common.finish(res, args.out, launches0)


if __name__ == "__main__":
    main()
