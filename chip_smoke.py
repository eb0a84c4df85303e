"""Drive cylon_tpu_torch's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--rows N] [--seed S] [--out PATH]

The configuration is the repo's headline benchmark (bench.py
``bench_dist_join``): two tables of N = 16,777,216 rows, an int32 key
uniform in [0, N) and one float32 payload per side, an inner join on the
key, ``force_exchange=True`` on a virtual world of 4 shards on the card.

Phases, in order (any failure exits non-zero; nothing is caught):
  1. the card, torch, nvcc, and the build of every kernel from csrc/;
  2. the main path: ``Table.distributed_join`` at world 4 on the kernel
     route, with every kernel's launch counter set to 0 just before and
     read just after (each of K1-K4 must have launched), the inputs of
     each kernel's first launch recorded;
  3. the same join on the plain route (the STREAM_PLAN/PARTITION_KERNEL
     switches off): both outputs equal tensor for tensor once each is
     put in one canonical row order; the row count (checked in phase 2)
     equals the numpy count sum_k cnt_left(k) * cnt_right(k); then both
     routes' steady-state walls, taken in turns, and one kernel-route
     run under torch.profiler (device busy time, idle share, top kernels);
  4. a world-1 local inner join on the same tables, kernel route against
     plain route, both timed in turns;
  5. each kernel at the shapes the main path gave it, against its plain
     version on the same inputs, bit for bit: median ms over 7 timed runs
     (CUDA events), the plain version's ms, the library call's ms where
     one PyTorch call computes the same function, and the bound (bytes
     moved at 3.35 TB/s);
  6. a small world-4 join against an independent numpy join.

It prints the kernels line (one JSON object) and the card's name and
power limit on lines before the last, and as the last line
``{"ok": true, "device": {...}}``. Without CUDA it exits 1 and prints no
result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
WORLD = 4
NOT_PORTED = [
    {"name": "setop_stream", "replaces": "cylon_tpu/ops/tpu_kernels.py:544",
     "status": "not_ported"},
    {"name": "stream_compact",
     "replaces": "cylon_tpu/ops/tpu_kernels.py:241",
     "status": "not_ported"},
]


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 7, warm: int = 2) -> float:
    """Median milliseconds of fn() over ``reps`` runs, CUDA events."""
    for _ in range(warm):
        fn()
    sync()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def make_tables(ct, ctx, n: int, seed: int):
    """bench.py's _join_tables, the same generator sequence."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, n, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    rk = rng.integers(0, n, n).astype(np.int32)
    rv = rng.normal(size=n).astype(np.float32)
    left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv})
    right = ct.Table.from_pydict(ctx, {"k": rk, "w": rv})
    return left, right, (lk, lv, rk, rv)


def canonical(table):
    """A result table's live rows in one canonical order (by key, then
    the payload bits): [(data, validity)] per column."""
    from cylon_tpu_torch.ops import order

    live = table.emit_mask().nonzero().flatten()
    cols = [(c.data[live], c.valid_mask()[live]) for c in table._columns]
    keys = [d.view(torch.int32) if d.element_size() == 4 else d
            for d, _v in cols]
    perm = order.lexsort_indices(keys)
    return [(d[perm], v[perm]) for d, v in cols]


def assert_same_rows(a, b, what: str):
    ca, cb = canonical(a), canonical(b)
    assert len(ca) == len(cb), what
    for (da, va), (db, vb) in zip(ca, cb):
        assert torch.equal(da, db) and torch.equal(va, vb), what


def numpy_join_count(lk: np.ndarray, rk: np.ndarray, n: int) -> int:
    return int((np.bincount(lk, minlength=n).astype(np.int64)
                * np.bincount(rk, minlength=n)).sum())


def numpy_inner_join(lk, lv, rk, rv):
    """Independent reference: (key, left payload bits, right payload
    bits) rows of the inner join, sorted."""
    order = np.argsort(rk, kind="stable")
    rks = rk[order]
    lo = np.searchsorted(rks, lk, "left")
    hi = np.searchsorted(rks, lk, "right")
    cnt = hi - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    starts = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
    ri = order[starts + np.arange(len(li))]
    rows = np.stack([lk[li].astype(np.int64),
                     lv[li].view(np.int32).astype(np.int64),
                     rv[ri].view(np.int32).astype(np.int64)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def run_route(J, S, switch, fn):
    """fn() with the STREAM_PLAN/PARTITION_KERNEL switches set to
    ``switch`` (None = the default kernel route on CUDA, False = the
    plain route), synchronized."""
    J.STREAM_PLAN, S.PARTITION_KERNEL = switch, switch
    try:
        out = fn()
        sync()
    finally:
        J.STREAM_PLAN, S.PARTITION_KERNEL = None, None
    return out


def alternate(J, S, fn, rounds: int = 5) -> dict:
    """Steady-state walls of both routes, taken in turns (plain, kernel,
    kernel, plain, ...) so that both see the same card state."""
    walls = {"kernel": [], "plain": []}
    order = []
    for i in range(rounds):
        order += [("plain", False), ("kernel", None)] if i % 2 == 0 \
            else [("kernel", None), ("plain", False)]
    for name, switch in order:
        t0 = time.perf_counter()
        out = run_route(J, S, switch, fn)
        walls[name].append(time.perf_counter() - t0)
        del out
    return walls


def profile_once(fn) -> dict:
    """One run of fn() under torch.profiler: wall, summed device time of
    every kernel and copy, the idle share, and the top device-time
    entries."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    del out

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device-side events only (kernels, copies, sets): a CPU op's device
    # time repeats the time of the kernels it launched
    events = [(e.key, dev_us(e) / 1e3, e.count)
              for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(ms for _k, ms, _c in events)
    top = sorted((x for x in events if x[1] > 0), key=lambda x: -x[1])[:12]
    # not clamped: a negative share would mean double-counted events
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "top": [(k[:90], ms, c) for k, ms, c in top]}


class Recorder:
    """Records the inputs of each kernel wrapper's first call."""

    def __init__(self, kernels):
        self.k = kernels
        self.calls = {}
        self.orig = {}

    def __enter__(self):
        for name in self.k.KERNELS:
            fn = getattr(self.k, name)
            self.orig[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.calls.setdefault(_name, (a, kw))
                return _fn(*a, **kw)

            setattr(self.k, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.k, name, fn)


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over int32 bit patterns (0 = identical)."""
    err = 0
    for a, b in pairs:
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.numel():
            d = (a.to(torch.int64) - b.to(torch.int64)).abs().max()
            err = max(err, int(d))
    return err


def check_kernels(K, calls) -> list:
    """Phase 5: every kernel at its main-path shapes against its plain
    version, timed."""
    out = []
    b4 = 4

    # K1 partition_hist
    (t, nb), _ = calls["partition_hist"]
    got, ref = K.partition_hist(t, nb), K.plain_partition_hist(t, nb)
    err = max_abs_err([(got, ref)])
    w, n = t.shape
    tiles = got.shape[1]
    flat = ((torch.arange(w, device=t.device)[:, None] * tiles
             + torch.arange(n, device=t.device)[None] // K.PARTITION_TILE)
            * nb + t).reshape(-1)
    lib = torch.bincount(flat, minlength=w * tiles * nb).view(w, tiles, nb)
    assert torch.equal(lib.to(torch.int32), ref), "bincount disagrees"
    out.append(dict(
        name="partition_hist", err=err, shape=f"ids {list(t.shape)}, "
        f"{nb} buckets",
        ms=cuda_ms(lambda: K.partition_hist(t, nb)),
        plain_ms=cuda_ms(lambda: K.plain_partition_hist(t, nb)),
        library_ms=cuda_ms(lambda: torch.bincount(
            flat, minlength=w * tiles * nb)),
        bytes=b4 * (t.numel() + got.numel())))

    # K2 partition_scatter
    (t, legs, nb, hist), _ = calls["partition_scatter"]
    got = K.partition_scatter(t, legs, nb, hist)
    ref = K.plain_partition_scatter(t, legs, nb)
    err = max_abs_err([(got, ref)])

    def library_k2():
        perm = torch.sort(t, dim=1, stable=True).indices
        return legs.gather(2, perm.unsqueeze(0).expand_as(legs))

    out.append(dict(
        name="partition_scatter", err=err,
        shape=f"legs {list(legs.shape)}, {nb} buckets",
        ms=cuda_ms(lambda: K.partition_scatter(t, legs, nb, hist)),
        plain_ms=cuda_ms(lambda: K.plain_partition_scatter(t, legs, nb)),
        library_ms=cuda_ms(library_k2),
        bytes=b4 * (t.numel() + hist.numel() + 2 * legs.numel())))

    # K3 join_plan_stream
    _a, kw = calls["join_plan_stream"]
    got = K.join_plan_stream(**kw)
    ref = K.plain_join_plan_stream(**kw)
    pairs = [(got[0], ref[0])]
    counts = ref[0].cpu()
    for w_ in range(counts.shape[0]):
        ne, nbl = int(counts[w_, 1]), int(counts[w_, 2])
        pairs += [(x[w_, :ne], y[w_, :ne]) for x, y in zip(got[1], ref[1])]
        pairs += [(x[w_, :nbl], y[w_, :nbl]) for x, y in zip(got[2], ref[2])]
    err = max_abs_err(pairs)
    # bits, tag (and in hash mode bits2 and the verify lanes) are read at
    # every element; the payload lanes only at group A elements (the a
    # lanes) and group B elements (the b lanes)
    streams = 2 + len(kw.get("verify_lanes", ())) \
        + (kw.get("bits2_s") is not None)
    n_emit, n_blive = int(counts[:, 1].sum()), int(counts[:, 2].sum())
    la, lb = len(ref[1]) - 3, len(ref[2]) - 1
    out.append(dict(
        name="join_plan_stream", err=err,
        shape=f"stream {list(kw['bits_s'].shape)}, "
        f"{len(kw.get('lanes', ()))} lanes, "
        f"n_emit {n_emit}, n_blive {n_blive}",
        ms=cuda_ms(lambda: K.join_plan_stream(**kw)),
        plain_ms=cuda_ms(lambda: K.plain_join_plan_stream(**kw)),
        library_ms=None,
        bytes=b4 * (streams * kw["bits_s"].numel() + la * n_emit
                    + lb * n_blive + counts.numel()
                    + len(ref[1]) * n_emit + len(ref[2]) * n_blive)))

    # K4 join_expand_stream
    (cnt, a_s, b_s, cap_e), _ = calls["join_expand_stream"]
    got = K.join_expand_stream(cnt, a_s, b_s, cap_e)
    ref = K.plain_join_expand_stream(cnt, a_s, b_s, cap_e)
    err = max_abs_err([(got[0], ref[0]), (got[1], ref[1])]
                      + list(zip(got[2] + got[3], ref[2] + ref[3])))
    c = cnt.cpu()
    n_emit = int(c[:, 1].sum())
    w = cnt.shape[0]
    # group B rows are read only where some output row matches them
    shard_of = torch.arange(w, device=cnt.device)[:, None].expand_as(ref[1])
    hit = ref[1] >= 0
    b_read = torch.unique(shard_of[hit] * b_s.shape[2]
                          + ref[1][hit].to(torch.int64)).numel()
    out.append(dict(
        name="join_expand_stream", err=err,
        shape=f"cap_e {cap_e} x {w} shards, groups A {len(a_s)} x "
        f"{list(a_s[0].shape)}, B {len(b_s)} x {list(b_s[0].shape)}",
        ms=cuda_ms(lambda: K.join_expand_stream(cnt, a_s, b_s, cap_e)),
        plain_ms=cuda_ms(lambda: K.plain_join_expand_stream(
            cnt, a_s, b_s, cap_e)),
        library_ms=None,
        bytes=b4 * (c.numel() + len(a_s) * n_emit + len(b_s) * b_read
                    + (len(a_s) - 3 + len(b_s) + 1) * w * cap_e)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the result JSON to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import join as J
    from cylon_tpu_torch.ops import kernels as K
    from cylon_tpu_torch.parallel import shuffle as S

    card = card_line()
    log(card)
    nvcc = subprocess.run([K.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    log("torch", torch.__version__, "cuda", torch.version.cuda, "|",
        nvcc.strip().splitlines()[-1])
    t0 = time.perf_counter()
    build_s = K.build()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f} s wall, per source "
        f"{ {k: round(v, 2) for k, v in build_s.items()} }")

    n = args.rows
    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(WORLD))
    left, right, host = make_tables(ct, dctx, n, args.seed)
    lk, lv, rk, rv = host
    expect_rows = numpy_join_count(lk, rk, n)
    sync()

    # phase 2: the main path on the kernel route, counters 0 -> read
    assert J.STREAM_PLAN is None and S.PARTITION_KERNEL is None
    K.reset_launches()
    with Recorder(K) as rec:
        t0 = time.perf_counter()
        out_k = left.distributed_join(right, "inner", on=["k"],
                                      force_exchange=True)
        sync()
        wall_k = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"phase 2 main path (world {WORLD}, kernel route): {wall_k:.4f} s, "
        f"launches {launches}")
    missing = [k for k in K.KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    rows_k = out_k.row_count
    assert rows_k == expect_rows, (rows_k, expect_rows)
    log(f"  rows out {rows_k} == numpy count {expect_rows}; "
        f"capacity {out_k.capacity}; first run {wall_k:.4f} s")

    # phase 3: the plain route, same join
    def dist_join():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    out_p = run_route(J, S, False, dist_join)
    assert_same_rows(out_k, out_p, "world-4 kernel route vs plain route")
    del out_p, out_k
    walls = alternate(J, S, dist_join)
    rate = {k: {"median": 2 * n / statistics.median(v), "best": 2 * n / min(v)}
            for k, v in walls.items()}
    log(f"phase 3 plain route: outputs equal; steady walls (s) {walls}; "
        f"input rows/s on one card, median (best): kernel route "
        f"{rate['kernel']['median']:.4e} ({rate['kernel']['best']:.4e}), "
        f"plain route {rate['plain']['median']:.4e} "
        f"({rate['plain']['best']:.4e})")
    prof = profile_once(dist_join)
    log(f"  profile of one kernel-route join: wall {prof['wall_ms']:.3f} ms,"
        f" device busy {prof['busy_ms']:.3f} ms (idle share "
        f"{prof['idle_share']:.4f}); top device time:")
    for name, ms, calls in prof["top"]:
        log(f"    {ms:9.3f} ms  x{calls:<3d} {name}")

    # phase 4: the world-1 local join, kernel route vs plain route
    lctx = ct.CylonContext.Init()
    l1, r1, _h = make_tables(ct, lctx, n, args.seed)

    def local_join():
        return l1.join(r1, "inner", on=["k"])

    loc_k = run_route(J, S, None, local_join)
    loc_p = run_route(J, S, False, local_join)
    assert loc_k.row_count == expect_rows
    assert_same_rows(loc_k, loc_p, "world-1 kernel route vs plain route")
    del loc_k, loc_p
    local_walls = alternate(J, S, local_join)
    log(f"phase 4 local join: outputs equal; steady walls (s) {local_walls}")
    del l1, r1

    # phase 5: each kernel at its main-path shapes
    results = check_kernels(K, rec.calls)
    del rec
    table = {k["name"]: k for k in K.kernel_table()}
    kernels = []
    for r in results:
        bound = r["bytes"] / HBM_BYTES_PER_S * 1e3
        row = dict(table[r["name"]], launches=launches[r["name"]],
                   max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
                   bound_ms=bound, bound_by="bytes",
                   library_ms=r["library_ms"])
        kernels.append(row)
        log(f"phase 5 {r['name']} ({r['shape']}): ms {r['ms']:.4f} plain "
            f"{r['plain_ms']:.4f} bound {bound:.4f} library "
            f"{r['library_ms']} max_abs_err {r['err']}")
    bad = [k["name"] for k in kernels if k["max_abs_err"] != 0]
    assert not bad, f"kernels disagree with their plain versions: {bad}"

    # phase 6: a small join against an independent numpy join
    small = 5003
    sl, sr, (slk, slv, srk, srv) = make_tables(ct, dctx, small,
                                               args.seed + 1)
    so = sl.distributed_join(sr, "inner", on=["k"], force_exchange=True)
    got = torch.stack([c.data.view(torch.int32).to(torch.int64)
                       for c in so.compact()._columns[:2]]
                      + [so.compact()._columns[3].data.view(
                          torch.int32).to(torch.int64)], 1).cpu().numpy()
    got = got[np.lexsort(got.T[::-1])]
    ref = numpy_inner_join(slk, slv, srk, srv)
    assert np.array_equal(got, ref), "small join disagrees with numpy"
    log(f"phase 6 small join ({small} rows a side): {len(ref)} rows equal "
        f"the numpy join")

    summary = {"kernels": kernels, "not_ported": NOT_PORTED}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(summary, card=card, rows=n, world=WORLD,
                           dist_join_wall_s=walls, dist_join_rows_s=rate,
                           first_wall_s=wall_k,
                           local_join_wall_s=local_walls, profile=prof,
                           out_rows=rows_k, build_s=build_s), f, indent=1)
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
