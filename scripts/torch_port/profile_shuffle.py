#!/usr/bin/env python
"""Phase profile of the port's exchange (counterpart of
scripts/profile_shuffle.py).

The exchange of chip_smoke.py phase 2's left table (2^rows_log2 rows,
``default_rng(0)``: an int32 key uniform in [0, n) and a float32
payload) to its key-hash targets on a virtual world of ``--world``
shards (default 4). Each phase is the best of 3 runs after one warm-up,
each ending in ``torch.cuda.synchronize()``:

* ``host_round_trip_s``: a one-element device -> host copy, the fixed
  cost inside every fetch below;
* ``count_program_s``: the send-count matrix on the device (K1's
  histogram summed over tiles on the card); ``count_plus_fetch_s`` the
  same plus its host fetch, as ``exchange`` pays it;
* ``exchange_program_s``: ``shuffle.exchange`` with the counts given;
* ``sort_floor_s``: one stable ``torch.sort`` of the dead-keyed targets;
  ``copy_floor_s``: one read and write of every payload leaf (a clone);
* the partition alone (stable by target, dead rows last), on both
  routes: ``partition_pallas_s`` the kernel route (K1 histogram, its sum
  over tiles, K2 scatter: ``shuffle._kernel_partition``, the port's
  counterpart of the JAX package's Pallas partition) and
  ``partition_sort_s`` the plain route (one stable sort of the targets
  and a gather a leaf: ``shuffle._bucket_sort``); ``partition_path``
  names the route the exchange takes on this device;
* ``end_to_end_s``: ``exchange`` as a caller runs it (counts, fetch,
  partition, all-to-all), ``gbps_end_to_end`` and
  ``gbps_exchange_only`` its payload bytes over the wall;
* the chunked stream at chip_smoke.py phase 20's chunk bytes (a quarter
  of the padded payload, so at least 4 chunks; 8 where the knob's 4 KiB
  floor leaves one, at small n, as in the JAX script): ``partition_s`` the
  partition and counts exchange, ``exchange_s`` the chunks pipelined
  (queued back to back) less the partition, ``exchange_serial_s`` the
  partition and chunks with a synchronize after each chunk,
  ``overlap_ratio`` = 1 - pipelined / serial, ``chunks``,
  ``chunk_block``.

``rows_out`` is the rows the exchange delivered, checked against n and
against each shard's count of numpy-computed targets.

    python scripts/torch_port/profile_shuffle.py [rows_log2=24]
        [--world W] [--device cuda|cpu] [--out PATH]

The last stdout line is the JSON summary, with the kernel launches; a
file is written only to ``--out``.
"""
import os

import numpy as np

import drill_common


def main(argv=None) -> dict:
    p = drill_common.tool_parser(__doc__.split("\n")[0], 24, "the rows")
    p.add_argument("--world", type=int, default=4,
                   help="shards of the virtual world (default 4)")
    args = p.parse_args(argv)
    device = drill_common.device_of(args.device)
    launches0 = drill_common.launches()

    import torch

    import cylon_tpu_torch as ct
    from cylon_tpu_torch.parallel import dist_ops as D
    from cylon_tpu_torch.parallel import shard
    from cylon_tpu_torch.parallel import shuffle as S

    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(args.world),
                                          device=device)
    cm = ctx.comm
    world = cm.world
    n = 1 << args.rows_log2
    rng = np.random.default_rng(0)
    lk = rng.integers(0, n, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    t = shard.distribute(ct.Table.from_pydict(ctx, {"k": lk, "v": lv}),
                         ctx)
    targets = D._partition_targets_dist(world, [t._columns[0]])
    emit = t.emit_mask()
    payload = {"k": t._columns[0].data, "v": t._columns[1].data}
    v = cm.shards

    def best(fn):
        return drill_common.best_of(fn, device)

    res = {"n_rows": n, "world": world, "backend": device.type,
           "device": drill_common.card_name(device)}
    probe = torch.zeros(1, dtype=torch.int32, device=device)
    res["host_round_trip_s"] = best(lambda: probe.cpu())
    res["count_program_s"] = best(lambda: S._count_matrix(cm, targets, emit))
    res["count_plus_fetch_s"] = best(
        lambda: S._count_matrix(cm, targets, emit).cpu().numpy())
    counts = S._count_matrix(cm, targets, emit).cpu().numpy()
    res["exchange_program_s"] = best(
        lambda: S.exchange(payload, targets, emit, ctx, counts=counts))

    keyed = S._dead_keyed(targets.view(v, -1), emit.view(v, -1), world)
    res["sort_floor_s"] = best(
        lambda: torch.sort(keyed, dim=1, stable=True))
    res["copy_floor_s"] = best(
        lambda: {k: x.clone() for k, x in payload.items()})

    shards = ({k: x.view(v, -1) for k, x in payload.items()},
              targets.view(v, -1), emit.view(v, -1))
    kernel_route = world > 1 and S.use_partition_kernel(world, device)
    res["partition_path"] = "kernel" if kernel_route else "sort"
    if world > 1:
        res["partition_sort_s"] = best(
            lambda: S._bucket_sort(*shards, world))
        res["partition_pallas_s"] = best(
            lambda: S._kernel_partition(*shards, world))
    else:
        res["partition_sort_s"] = None
        res["partition_pallas_s"] = None

    res["end_to_end_s"] = best(
        lambda: S.exchange(payload, targets, emit, ctx, dense=True))
    out, new_emit, _cap, _meta = S.exchange(payload, targets, emit, ctx,
                                            dense=True)
    res["rows_out"] = int(new_emit.sum())
    live = emit.view(v, -1).cpu().numpy()
    expect = np.bincount(targets.view(v, -1).cpu().numpy()[live],
                         minlength=world)
    got = new_emit.view(world, -1).sum(1).cpu().numpy()
    if res["rows_out"] != n or not np.array_equal(got, expect):
        raise AssertionError(f"the exchange delivered {got} rows a shard, "
                             f"numpy's targets count {expect} (n {n})")
    del out, new_emit

    # the chunked stream at phase 20's chunk bytes
    ok, block, _mb = S._padded_route(counts, payload, world,
                                     ctx.memory_pool.comm_budget_bytes())
    row_bytes = S._payload_row_bytes(payload)
    if ok and block >= 16 and world > 1:
        cbytes = max((world * row_bytes * block) // 4, 1 << 12)
        saved = {k: os.environ.get(k) for k in
                 ("CYLON_EXCHANGE_OVERLAP", "CYLON_EXCHANGE_CHUNK_BYTES")}
        os.environ["CYLON_EXCHANGE_OVERLAP"] = "1"
        os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = str(cbytes)
        try:
            cb, chunks = S._chunk_plan(block, world, row_bytes)
            if chunks == 1:
                # the knob's 4 KiB floor binds at small n: split in 8, as
                # the JAX script does, so the phases stay measurable
                cb, chunks = block // 8, 8
        finally:
            for k, val in saved.items():
                if val is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = val

        def partition():
            return S._padded_partition(cm, block, *shards)

        def chunk_stream(serialize: bool):
            sorted_leaves, _ci, start, _em = partition()
            padded = {k: S._pad_block(x, cb)
                      for k, x in sorted_leaves.items()}
            recv = {k: torch.empty(v, world, block, dtype=x.dtype,
                                   device=x.device)
                    for k, x in sorted_leaves.items()}
            for o in range(0, block, cb):
                S._chunk_step(cm, padded, start, recv, o, cb)
                if serialize:
                    drill_common.sync(device)
            return recv

        res["partition_s"] = best(partition)
        pipelined = best(lambda: chunk_stream(False))
        serial = best(lambda: chunk_stream(True))
        res["exchange_s"] = max(pipelined - res["partition_s"], 0.0)
        res["exchange_serial_s"] = serial
        res["overlap_ratio"] = max(0.0, 1.0 - pipelined / serial) \
            if serial > 0 else 0.0
        res["chunks"] = chunks
        res["chunk_block"] = cb
    else:
        res["partition_s"] = None
        res["exchange_s"] = None
        res["overlap_ratio"] = None
        res["chunks"] = 0
        res["chunk_block"] = 0
    res["row_bytes"] = row_bytes
    res["gbps_end_to_end"] = n * row_bytes / res["end_to_end_s"] / 1e9
    res["gbps_exchange_only"] = n * row_bytes / res["exchange_program_s"] \
        / 1e9
    return drill_common.finish(res, args.out, launches0)


if __name__ == "__main__":
    main()
