"""Drive cylon_tpu_torch's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--rows N] [--setop-rows M] [--pipeline-rows P]
                          [--groupby-rows G] [--string-rows R]
                          [--bcast-rows B] [--shuffle-rows X]
                          [--service-rows Q] [--seed S] [--out PATH]
                          [--parent-tree DIR]

(``--mp-child RANK`` is how phases 22 and 26d start their two
processes.)

The paths, each at the size of the repo's own benchmark:

* the join: bench.py ``bench_dist_join``, two tables of N = 16,777,216
  rows (``--rows``), an int32 key uniform in [0, N) and one float32
  payload per side, an inner join on the key, ``force_exchange=True`` on
  a virtual world of 4 shards on the card (kernels K1-K4);
* the set ops: bench.py ``bench_setops`` (``set_union``), two tables of
  M = 8,388,608 rows (``--setop-rows``), int32 columns k uniform in
  [0, M) and g uniform in [0, 2^20), ``Table.union/subtract/intersect``
  on one card (kernels K5 setop_stream and K6 stream_compact), and
  bench.py ``bench_dist_union``: ``distributed_set_op(UNION,
  force_exchange=True)`` at world 4 (K1/K2);
* groupby: bench.py ``bench_plan_pipeline``'s eager form (two tables of
  P = 8,388,608 rows, ``--pipeline-rows``, k in [0, P/4): an inner
  distributed join on k at world 4, then ``distributed_groupby`` of the
  right payload by k, whose partials take the compact exchange route)
  and ``bench_groupby`` (G = 16,777,216 rows, ``--groupby-rows``: g in
  [0, 2^20), ``groupby(0, [1, 2, 1], [sum, count, mean])`` at world 1
  and 4); the float sums of both through K7 segment_sum;
* sort: bench.py ``bench_sort`` and ``bench_dist_sort`` (G rows, k in
  [0, 2^31): ``Table.sort`` at world 1, ``distributed_sort(...,
  force_exchange=True)`` at world 4);
* strings: bench.py ``bench_string_join`` and ``bench_dist_string_join``
  (two tables of R = 4,194,304 rows, ``--string-rows``: a varbytes key
  "u" + 8 hex digits of ks + "xxx", 12 bytes, ks uniform in [0, 2^20),
  a float32 payload; ``Table.join`` at world 1 and ``distributed_join(...,
  force_exchange=True)`` at world 4: K3 in hash mode with 4 verify
  lanes, the key words riding K4 as payload lanes, K1/K2 at world 4);
* the planned query path: phase 23 runs the groupby path's join ->
  groupby through ``plan.scan(...).join(...).groupby(...).execute()``
  (K1-K4), its EXPLAIN ANALYZE, and every plan node kind at small size
  (K5/K6 through a planned set op);
* the exchange variants: the ring join on the join's tables (world 4,
  ``comm="ring"``: K3/K4 at every ring step); bench.py
  ``bench_adaptive_join``'s broadcast join (B = 4,194,304 probe rows,
  ``--bcast-rows``, B // 1000 build rows, keys in [0, B // 2000),
  ``comm="broadcast"``, inner and left: K3/K4, no exchange) and its
  salted shuffle (B rows, 70% one key: K1/K2); bench.py
  ``bench_shuffle_pipeline``'s chunked exchange (X = 16,777,216 rows,
  ``--shuffle-rows``, 24 bytes a row, a pipeline of at least 4 chunks:
  K1/K2);
* the query service: bench.py ``bench_service_pipeline`` (two tables of
  Q = 4,194,304 rows, ``--service-rows``, ``default_rng(11)``, the
  planned join -> groupby of phase 23 served 8 times by a
  ``QueryService`` at world 4: K1-K4), the task exchange on the join's
  left table (K1/K2), and the edge modules at small size.

Phases, in order (any failure exits non-zero; nothing is caught):
  1. the card, torch, nvcc, and the build of every kernel from csrc/,
     with the compile profiler (``telemetry.profiler``) enabled before
     anything is built or loaded; each of the five libraries is then
     loaded, and the profile printed: one record a library with its
     nvcc seconds (> 0 for a library this run built, 0.0 for one loaded
     from an existing ``_build/``, equal to what the build reported) and
     the registers, shared memory and spill bytes of every kernel
     function from its ``-Xptxas -v`` report;
  2. the join's main path: ``Table.distributed_join`` at world 4 on the
     kernel route, with every kernel's launch counter set to 0 just
     before and read just after (each of K1-K4 must have launched), the
     inputs of each kernel's first launch recorded;
  3. the same join on the plain route (every route switch off): both
     outputs equal tensor for tensor once each is put in one canonical
     row order; the row count (checked in phase 2) equals the numpy count
     sum_k cnt_left(k) * cnt_right(k); then both routes' steady-state
     walls, taken in turns, and one kernel-route run under
     torch.profiler (device busy time, idle share, top kernels);
  4. a world-1 local inner join on the same tables, kernel route against
     plain route, both timed in turns;
  5. the set-op main path: for UNION, SUBTRACT and INTERSECT, the
     counters set to 0 just before the kernel route and read just after
     (K5 and K6 must have launched, with no hash collision), the plain
     route (dense ranks) equal as a row set, the row count equal to an
     independent numpy count, both routes' walls in turns; one
     kernel-route UNION under torch.profiler;
  6. the distributed union at world 4: K1/K2 launched, the kernel route
     equal to the plain route and to the numpy count, walls in turns;
  7. small duplicate-heavy set ops (nulls, a filtered emit mask) at
     world 1 and 4, each equal row for row to an independent numpy set
     computation;
  8. each kernel at the shapes its path gave it, against its plain
     version on the same inputs, bit for bit: median ms over 7 timed runs
     (CUDA events), the kernel's own device time in a wrapper call (CUDA
     events around each of its kernel launches, summed, without the
     wrapper's copies and torch glue; median of 5 calls), the plain
     version's ms, the library call's ms where one PyTorch call computes
     the same function, and the bound (bytes moved at 3.35 TB/s);
  9. a small world-4 join against an independent numpy join;
 10. join -> groupby at world 4: K1-K4 and K7 launched (counters 0 ->
     read), the partials' exchange seen on the compact route, the group
     keys exact and the sums within tolerance against numpy, and a
     second run bit-equal to the first;
 11. groupby at world 1 and 4 (K1/K2 at world 4, K7 at both): keys and
     counts exact, sums and means within tolerance against numpy, a
     second run bit-equal to the first; then K7 at the world-1 run's
     shapes against its plain version bit for bit, timed as in phase 8:
     the run's one K7 call (the float32 SUM and MEAN's float64 sum of one
     column, the kernels line's numbers), and its first column alone,
     beside ``torch.segment_reduce`` (the library call),
     ``index_put_(accumulate=True)`` and ``index_add_`` (the earlier
     route), each timed and checked for equality with K7's row-order sums
     and with a second call of itself;
 12. sort at world 1 and 4 (K1/K2 at world 4): the key sequence exact
     against np.sort, the rows equal as a multiset;
 13. small and empty inputs at world 4 and 8 (the compact route): all
     four join types and the three set ops against numpy, one join in
     several rounds, one hash_partition and one repartition check;
 14. the string join at world 1 (seeds 10, 11), 15. at world 4 with a
     forced exchange (seeds 20, 21): counters 0 -> read (K3 and K4, and
     K1/K2 at world 4, must launch; every K3 call in hash mode with 4
     verify lanes), the rows (ks, left payload, right payload) equal to a
     numpy join on ks, the median of 5 steady walls, 2R / wall rows/s and
     one profile; then K3 and K4 at phase 14's shapes against their plain
     versions, bit for bit;
 16. strings at small size against Python from the same integer ids:
     dictionary and varbytes storage, nulls, empty strings, non-ASCII
     text and BINARY values, keys of 1-3, 11 and 19-20 words; all four
     joins, the three set ops (K5/K6 for dictionary strings at world 1),
     groupby and sort at world 1 and 4, and a mixed dictionary/varbytes
     concat_tables.
 17. the ring join: no fallback, K3/K4 launched, the rows equal the
     numpy inner join, every shard's rows equal the ring's plain route's;
     the median of 5 walls in turns with the shuffle join of phase 2;
 18. the broadcast join, inner and left with build_side=1: K1/K2 launched
     0 times and no exchange called, K3/K4 launched, the rows equal a
     numpy join; walls in turns with the shuffle join;
 19. the salted shuffle: K1/K2 launched, the salted targets and both
     count matrices equal an independent numpy version of the rule, the
     rows equal the unsalted shuffle's; max/mean shard imbalance and
     walls of both;
 20. the chunked exchange: K1/K2 launched, the output equals the
     single-shot exchange's (CYLON_EXCHANGE_OVERLAP=0) bit for bit on
     every shard; the chunk count, both walls, and both routes'
     torch.cuda.max_memory_allocated; the chunk counts of phases 2, 10
     and 15 (a phase whose exchange chunks is also timed with the
     overlap knob at its default and off, in turns);
 21. the ring, broadcast, salted and chunked paths at small size (world
     4 and 8, 0-15 rows a side, a hot key) against Python joins or the
     single-shot exchange;
 22. the process-group backend (``MultiHostConfig``) on phase 2's join:
     22a, two processes of two shards each (W = 4), both on cuda:0 with
     gloo, which stages the collectives through host memory (NCCL
     refuses two ranks on one device). Each process, started by this
     script with ``--mp-child``, loads phase 1's build (it never builds),
     builds only its own shards' rows from the seed through
     ``assemble_process_local``, and runs the join with the counters set
     to 0 just before and read just after (K1-K4 must launch in each);
     its shards equal the virtual world's output of the same join
     (computed again at the start of phase 22) shard for shard, by a
     canonical digest of each shard's rows, and its global row count
     phase 2's numpy count; then the median of 5 joins between
     barriers. A process that exits non-zero or outlives its timeout
     fails the run. 22b, one process of four shards on NCCL (a
     one-process group): K1-K4 launch, the shards equal the virtual
     world's, and 5 walls in turns with phase 2's join on the virtual
     world.
 23. the planned query path (cylon_tpu_torch.plan), bench.py
     ``bench_plan_pipeline``'s planned form: 23a, ``plan.scan(left).join(
     plan.scan(right), on="k").groupby("lt-0", ["rt-4"], ["sum"])
     .execute()`` on phase 10's tables (2 x P rows, world 4), the launch
     counters set to 0 just before and read just after (K1-K4 must
     launch); its groups equal phase 10's eager form's and a numpy
     groupby of the numpy join (keys exact, sums within tolerance); its
     exchanges, counted from ``telemetry.collect_phases`` as
     (``plan.shuffle``, ``shuffle.exchange``) labels, fewer than the eager
     form's physical exchanges and equal to the reference's CPU count of
     the same plan (1, 1); the median of 5 steady walls of each form after
     one warm-up, in turns. 23b, one ``execute(analyze=True)`` of the same
     query at full size: the PlanReport (``to_dict()`` and ``render()``
     printed), each executed node's rows equal to the numpy counts (scans
     and the projection P, the join sum_k cnt_l(k) * cnt_r(k), the groups),
     its ``shuffle_count`` equal to 23a's, its memory gauges sampled and
     every span carrying ``hbm_delta``. 23c, every node kind at 3,000 rows
     a side, world 4 and world 1: scan, filter, project, an explicit
     shuffle and a salted one, the shuffle join, a broadcast join forced
     by ``CYLON_JOIN_ALGORITHM=broadcast`` (no K1/K2 launch, no exchange),
     a join of co-partitioned inputs with both exchanges elided, groupby,
     union/subtract/intersect (K5 and K6 launch on every world-1 set op)
     and sort, each equal to the port's eager composition and to numpy.
 24. the query service (``cylon_tpu_torch.service``), the task exchange
     and the edges: 24a, bench.py ``bench_service_pipeline`` at 2 x Q
     rows, world 4, on an empty plan cache and statistics warehouse: one
     direct ``execute()`` with the launch counters 0 -> read (K1-K4 must
     launch), then in turns, 3 rounds, 8 executes under
     ``plancache.disabled()`` and 8 queries served by a
     ``QueryService(start=False)`` (tenants t0 and t1 in turns; submit,
     ``start()``, ``drain()``, every ``result()``), each wall ending in
     a synchronize; every served batch launches exactly 8 times the
     direct query's kernels, builds no kernel library, and gives the
     plan-cache (hits, misses) the reference gives on the CPU for the
     same sequence (``REFERENCE_SERVICE_CACHE``); the first batch's 8
     results equal a numpy groupby of the numpy join (keys exact, sums
     within tolerance); the medians, the mean and p95 submit->dispatch
     wait and queries/s printed. 24b, a second served batch while an
     ``ObsServer(port=0)`` is scraped by two threads cycling through
     /metrics, /healthz, /queries, /slo and /stats: every response 200
     and parsed, /healthz showing live device bytes > 0 (some samples
     while a query runs), /queries one digest per query with its
     tenant, the results equal numpy, and no query's root leaving a
     ledger entry once the results are dropped; its wall beside 24a's.
     24c, the outcomes at 3,000 rows a side: a shed (an armed
     ``pool:262144:oom`` clamp, typed ``CylonResourceExhausted``, the
     other tenant's query unaffected), a deadline (``timeout``), an
     error (a scanned registered table removed before the query runs:
     ``CylonError(KeyError)``, the next query runs), backpressure
     (``CYLON_SERVICE_QUEUE_MAX=2`` on a paused service: typed before
     enqueue), a DRR run of two tenants of unequal cost whose
     ``dispatch_seq`` equals the CPU's (``REFERENCE_DRR_SEQ``), and a
     planned union, subtract and intersect served at world 1 (K5 and K6
     launch, the rows equal numpy). 24d, ``plan.task_exchange`` of phase
     2's left table (N rows, world 4, task ids ``default_rng(24)`` in
     [0, 64), the plan {t: t % 4}): K1 and K2 launch, each shard's live
     rows with their ``__task__`` equal the stable partition of the input
     in order, the median of 5 walls. 24e, an ``arrow_builder`` table
     from raw host buffers (int32, float64 with nulls, bool with a
     validity bitmap, a string column) on the card equal to its buffers;
     a ``DataLoader`` over 4 CSV partitions written by
     ``benchutils.generate_keyed_csv`` equal to the files; one
     ``benchmark_with_repetitions`` timing of phase 2's join in turns
     with the same wall by hand (its synchronizes seen, the medians
     within 10%).
 25. the static-analysis suite (``cylon_tpu_torch.analysis``) and the
     distributed ops' telemetry: 25a, ``python3 -m
     cylon_tpu_torch.analysis --format json`` in a subprocess on this
     machine, which has no jax: exit 0, no finding, ten families (its
     collectives catalog on the CPU, the kernels' plain versions), its
     seconds; 25b, the collectives catalog on CUDA tensors at world 4
     under its dispatch mode, the launch counters 0 -> read: no finding,
     each of K1-K7 launched; 25c (run right after phase 8, whose inputs
     it reuses, and K7 after phase 11), each kernel wrapper once at phase
     8's shapes (K7 at phase 11's) under
     ``torch.cuda.set_sync_debug_mode("error")``: no wrapper syncs; 25d,
     phase 2's join (2 x N rows, world 4) once under ``collect_phases``:
     its labels (``#seq`` stripped) and its ``cylon_host_syncs_total``
     deltas equal ``REFERENCE_JOIN_TELEMETRY``, the reference's on the
     CPU; with ``--parent-tree DIR`` (a checkout of the parent commit,
     e.g. ``git archive`` into a directory .gitignore lists) the parent's
     package is loaded beside this one under another name, its labels
     and host syncs printed, and the same join of both run in turns (one
     warm-up each, 9 rounds, medians and the difference printed).
 26. the host runtime, the C binding, the task exchange on a process
     group and the examples: 26a, the host library
     (csrc/host/cylon_host.cpp) built with g++ (its seconds printed),
     ``native.hash_partition`` of phase 2's left keys (N int32 keys, world
     4) through the library and through numpy, 3 runs each in turns,
     targets, counts and order bit-equal; ``distribute_by_key`` of phase
     2's left table on the card, then its inner join with the right table:
     one side exchanged (the witness skips the placed side), K1-K4
     launched, the rows phase 2's numpy count. 26b, that join's (k, v, w)
     columns written by ``write_csv`` through the host library
     (``native.CALLS``), read back with numpy: the row count and the
     column sums equal (integers exactly, floats within 1e-6 of
     sum |x|); the first 4,194,304 rows written again, and through pandas
     where pandas exists; the files deleted. 26c, the C binding
     (csrc/host/cylon_cbind.c) built with gcc and run on ``cuda`` over
     two CSVs of 1,048,576 rows a side (make_tables' draws): CBIND OK, the
     row count the numpy count, K3 and K4 launched in the child. 26d,
     ``plan.task_exchange`` of the join's left table at 4,194,304 rows
     and 64 tasks on two gloo processes of two shards sharing the card:
     each shard equal to the virtual world's, K1 and K2 launched in both.
     26e, the nine examples of examples/torch_port on the card
     (torch_ddp_demo as two processes), each with the counters 0 -> read:
     the join example's inner count and the set ops' counts against
     numpy, K5 and K6 launched by set_ops_example, K1-K7 over the
     examples.
 27. the port's drills (scripts/torch_port/), each on ``cuda`` in a fresh
     process: the telemetry, service, observability and statistics
     smokes, ``chaos.py --seeds 1`` (all ten scenarios, ``compile``
     included: one retry or more, never skipped) and
     ``fuzz_differential.py`` at 12 cases. Each must exit 0 and print
     its JSON line on ``cuda``; the service smoke's first query must
     load a kernel library and its later queries none; chaos must launch
     K1-K4 and the fuzzer K1-K7 with no failing seed. Each drill's wall
     and launches are printed, and the launches join the kernels line
     (``drill_launches``).
 28. float group sums and the measuring tools: 28a, a groupby of
     1,048,576 rows (4,096 keys, float32 values across six orders of
     magnitude; SUM and MEAN) at world 1 and 4, phase 10's join ->
     groupby (2 x 524,288 rows, SUM and MEAN) at world 4, and a groupby
     of 4,194,304 rows in 1, 4 and 64 groups at world 1 and 4, each twice
     on the card and once with the CPU port (route switches on): every
     column bit-equal run to run and card to CPU, K7 launched; then the
     1/4/64-group groupby at 16,777,216 rows on the card: steady walls,
     and at world 1 K7 launched exactly once a groupby and its call
     against its plain version, bit for bit and timed beside
     ``torch.segment_reduce``, with the byte bound and the chain bound
     (the longest group's rows times the ns a dependent add that the
     one-group timing gives, beside 4 cycles at the card's highest SM
     clock); the 1- and 64-group groupby under torch.profiler; 28b, each
     tool of scripts/torch_port (``TOOL_RUNS``: the scaling sweep at
     2^21 rows, the engine comparison at 2^20, the shuffle, distributed
     join, stream join and join profiles at 2^22) on ``cuda`` in its own
     process: exit 0, its JSON line, the kernels of ``TOOL_KERNELS``
     launched, every recorded row count equal to numpy's; its numbers
     printed, its launches added to the kernels line
     (``tool_launches``); 28c, with ``--parent-tree DIR``, the cost of
     the row-order sums: phases 10, 11 and 24a's query, phase 12's sorts
     (a control) and the 1/4/64-group groupby at 16,777,216 rows, world 1
     and 4, of both trees in turns (one warm-up each, 9 rounds, medians
     and the difference printed), then 28a's profile of both trees.
 29. worlds past K1/K2's bucket limit (world + 1 <= 256 buckets), which
     take the stable sort's partition on the card as the JAX package
     takes its sort route past its kernel's limit: 29a phase 2's join (2 x
     N rows, force_exchange) at world 256, the counters 0 -> read (K1/K2
     launched 0 times, K3/K4 launched), the rows phase 2's numpy count
     and equal to a world-4 run's as a bit-exact multiset, then 3 rounds
     in turns with the world-4 kernel route; 29b at 65,536 rows and world
     256, a groupby (SUM, COUNT, the integer SUM; K7 launched), a sort and
     a distributed UNION, each without K1/K2 and equal to world 4's (the
     groupby's float sums within tolerance of world 4's, the rest exact);
     29c a join of 2 x 1,048,576 rows at world 512, as 29a.
 30. the paths of a table spread over processes, on phase 22a's two
     gloo processes of two shards sharing the card (``--mp-child R
     --mp-spread``), each process building only its own shards: 30a
     ``sum/count/min/max/mean`` of phase 11's G-row table on the int32
     key, the float32 payload and it as float64; 30b the exact left join
     of 2 x 524,288 rows of 76-byte keys with content-hash collisions
     forced between pairs of keys (``pair_colliding``), which redoes
     itself once on one vocabulary gathered from both processes (K1-K4
     launched); 30c ``distributed_sort`` of 524,288 rows of 76-80-byte
     keys (the host sort; K1/K2 launched), descending, then an int32
     ascending. The virtual world of 4 shards runs the same inputs on
     the card: the two processes' scalars equal each other's bit for
     bit, the virtual world's exactly for integers, counts and MIN/MAX,
     within PERF.md section 2's bound for float SUM and MEAN; every shard
     of 30b equals the virtual world's as a row multiset and of 30c in
     order (`shard_digests` of each column's values, varbytes by their
     lengths and content hashes); the redo's rows are the true left join's count
     and the sort's keys descend.
Phases 10-12, 23a and 24d each record the median of 5 steady runs after
one warm-up.
Tolerances against numpy: float sums 1e-5 * sum |x| of the group
(+1e-30), float64 means 1e-12 * sum |x| / count; everything else exact.
The port against itself (a second run, the CPU, a kernel's plain
version): exact, float sums included.

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
MP_PROCS, MP_SHARDS = 2, 2  # phase 22a's process group: W = 4
MP_TIMEOUT_S = 600
SETOP_OPS = ("UNION", "SUBTRACT", "INTERSECT")


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
    bits) rows of the inner join, sorted, the payload bits signed."""
    k, a, b = numpy_join_arrays(lk, lv, rk, rv)
    rows = np.stack([k] + [x.astype(np.uint32).view(np.int32).astype(
        np.int64) for x in (a, b)], 1)
    return rows[np.lexsort(rows.T[::-1])]


def route_switches():
    """(module, name) of every route switch: STREAM_PLAN (K3/K4),
    PARTITION_KERNEL (K1/K2), STREAM_SETOP (K5/K6)."""
    from cylon_tpu_torch.ops import join as J
    from cylon_tpu_torch.ops import setops as SO
    from cylon_tpu_torch.parallel import shuffle as S

    return [(J, "STREAM_PLAN"), (S, "PARTITION_KERNEL"),
            (SO, "STREAM_SETOP")]


def run_route(switch, fn):
    """fn() with every route switch set to ``switch`` (None = the default
    kernel route on CUDA, False = the plain route), synchronized."""
    for mod, name in route_switches():
        setattr(mod, name, switch)
    try:
        out = fn()
        sync()
    finally:
        for mod, name in route_switches():
            setattr(mod, name, None)
    return out


def alternate(fn, rounds: int = 5) -> dict:
    """Steady-state walls of both routes, taken in turns (plain, kernel,
    kernel, plain, ...) so that both see the same card state."""
    walls = {"kernel": [], "plain": []}
    order = []
    for i in range(rounds):
        order += [("plain", False), ("kernel", None)] if i % 2 == 0 \
            else [("kernel", None), ("plain", False)]
    for name, switch in order:
        t0 = time.perf_counter()
        out = run_route(switch, fn)
        walls[name].append(time.perf_counter() - t0)
        del out
    return walls


def own_kernel_ms(K, fn, reps: int = 5) -> float:
    """Device ms of the port's own kernels in one wrapper call of fn():
    CUDA events recorded around each kernel launch the call makes
    (``kernels._launch``; a launcher's memset of its tile state counts
    with its kernel), summed over the call's launches, so the wrapper's
    copies, allocations and torch glue are left out; the median over
    ``reps`` calls. (torch.profiler drops device events of short windows
    on that machine, so it cannot give this number reliably.)"""
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
            sync()
            sums.append(sum(s.elapsed_time(e) for s, e in spans))
    finally:
        K._launch = real
    assert all(sums), "no kernel launch seen"
    return statistics.median(sums)


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
    # time repeats the time of the kernels it launched, and the spans'
    # ``cylon:`` ranges (telemetry) span the kernels they enclose
    events = [(e.key, dev_us(e) / 1e3, e.count)
              for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith("cylon:")]
    busy = sum(ms for _k, ms, _c in events)
    top = sorted((x for x in events if x[1] > 0), key=lambda x: -x[1])[:12]
    # not clamped: a negative share would mean double-counted events
    return {"wall_ms": wall * 1e3, "busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "top": [(k[:90], ms, c) for k, ms, c in top]}


class Recorder:
    """Records the inputs and the result of each kernel wrapper's first
    call."""

    def __init__(self, kernels):
        self.k = kernels
        self.calls = {}
        self.results = {}
        self.orig = {}

    def __enter__(self):
        for name in self.k.KERNELS:
            fn = getattr(self.k, name)
            self.orig[name] = fn

            def wrapped(*a, _fn=fn, _name=name, **kw):
                out = _fn(*a, **kw)
                if _name not in self.calls:
                    self.calls[_name] = (a, kw)
                    self.results[_name] = out
                return out

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


def check_k3(K, kw) -> dict:
    """K3 on the inputs of one recorded call against its plain version,
    timed; the bytes it must move."""
    b4 = 4
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
    return dict(
        name="join_plan_stream", err=err,
        shape=f"stream {list(kw['bits_s'].shape)}, "
        f"{len(kw.get('lanes', ()))} lanes, "
        f"n_emit {n_emit}, n_blive {n_blive}",
        ms=cuda_ms(lambda: K.join_plan_stream(**kw)),
        kernel_ms=own_kernel_ms(K, lambda: K.join_plan_stream(**kw)),
        plain_ms=cuda_ms(lambda: K.plain_join_plan_stream(**kw)),
        library_ms=None,
        bytes=b4 * (streams * kw["bits_s"].numel() + la * n_emit
                    + lb * n_blive + counts.numel()
                    + len(ref[1]) * n_emit + len(ref[2]) * n_blive))


def check_k4(K, cnt, a_s, b_s, cap_e) -> dict:
    """K4 on the inputs of one recorded call against its plain version,
    timed; the bytes it must move."""
    b4 = 4
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
    # tiles at or past their shard's n_out only write -1 and zeros
    tiles = -(-cap_e // K.EXPAND_TILE)
    fill = sum(tiles - min(tiles, -(-max(int(x), 0) // K.EXPAND_TILE))
               for x in c[:, 0])
    return dict(
        name="join_expand_stream", err=err,
        shape=f"cap_e {cap_e} x {w} shards, groups A {len(a_s)} x "
        f"{list(a_s[0].shape)}, B {len(b_s)} x {list(b_s[0].shape)}, "
        f"{fill} of {w * tiles} tiles fill-only",
        ms=cuda_ms(lambda: K.join_expand_stream(cnt, a_s, b_s, cap_e)),
        kernel_ms=own_kernel_ms(
            K, lambda: K.join_expand_stream(cnt, a_s, b_s, cap_e)),
        plain_ms=cuda_ms(lambda: K.plain_join_expand_stream(
            cnt, a_s, b_s, cap_e)),
        library_ms=None,
        bytes=b4 * (c.numel() + len(a_s) * n_emit + len(b_s) * b_read
                    + (len(a_s) - 3 + len(b_s) + 1) * w * cap_e))


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
        kernel_ms=own_kernel_ms(K, lambda: K.partition_hist(t, nb)),
        plain_ms=cuda_ms(lambda: K.plain_partition_hist(t, nb)),
        library_ms=cuda_ms(lambda: torch.bincount(
            flat, minlength=w * tiles * nb)),
        bytes=b4 * (t.numel() + got.numel())))

    # K2 partition_scatter: it must read the ids and the legs once, write
    # the legs once, and read the [W, nb - 1] live-bucket totals
    (t, legs, nb, counts), _ = calls["partition_scatter"]
    got = K.partition_scatter(t, legs, nb, counts)
    ref = K.plain_partition_scatter(t, legs, nb, counts)
    err = max_abs_err([(got, ref)])

    def library_k2():
        perm = torch.sort(t, dim=1, stable=True).indices
        return [leg.gather(1, perm) for leg in legs]

    out.append(dict(
        name="partition_scatter", err=err,
        shape=f"{len(legs)} legs x {list(t.shape)}, {nb} buckets",
        ms=cuda_ms(lambda: K.partition_scatter(t, legs, nb, counts)),
        kernel_ms=own_kernel_ms(
            K, lambda: K.partition_scatter(t, legs, nb, counts)),
        plain_ms=cuda_ms(lambda: K.plain_partition_scatter(
            t, legs, nb, counts)),
        library_ms=cuda_ms(library_k2),
        bytes=b4 * (t.numel() + counts.numel() + 2 * got.numel())))

    # K3 join_plan_stream, K4 join_expand_stream
    _a, kw = calls["join_plan_stream"]
    out.append(check_k3(K, kw))
    out.append(check_k4(K, *calls["join_expand_stream"][0]))

    # K5 setop_stream: it must read h1, h2, tag and the L lanes at every
    # element (the collision audit compares the lanes everywhere) and
    # write (idx, lanes...) at the n_out emitted rows, plus the counts;
    # streams is the (tag, lanes...) stack
    a, kw = calls["setop_stream"]
    got, ref = K.setop_stream(*a, **kw), K.plain_setop_stream(*a, **kw)
    err = max_abs_err([(got[0], ref[0]), (got[1], ref[1])])
    h1 = a[0]
    streams, op = a[2], a[3]
    n_out = int(ref[0][:, 0].sum())
    out.append(dict(
        name="setop_stream", err=err,
        shape=f"stream {list(h1.shape)}, {streams.shape[0] - 1} lanes, op "
        f"{op}, n_out {n_out}",
        ms=cuda_ms(lambda: K.setop_stream(*a, **kw)),
        kernel_ms=own_kernel_ms(K, lambda: K.setop_stream(*a, **kw)),
        plain_ms=cuda_ms(lambda: K.plain_setop_stream(*a, **kw)),
        library_ms=None,
        bytes=b4 * ((2 + streams.shape[0]) * h1.numel()
                    + streams.shape[0] * n_out + ref[0].numel())))

    # K6 stream_compact: it must read the mask (one byte) at every element
    # and the streams only at the selected elements, and write L x count
    # words plus the zero tail up to out_len, plus the counts
    a, kw = calls["stream_compact"]
    mask, streams = a[0], a[1]
    got, ref = K.stream_compact(*a, **kw), K.plain_stream_compact(*a, **kw)
    err = max_abs_err([(got[0], ref[0]), (got[1], ref[1])])
    cnt = int(ref[1].sum())
    L, w = streams.shape[0], mask.shape[0]
    out_len = ref[0].shape[2]
    picked = streams[:, mask]
    first_mask = kw.get("first_mask", -1)  # K5 cuts its tag to the idx
    if first_mask != -1:
        picked[0] &= first_mask
    assert w == 1 and torch.equal(picked, ref[0][:, 0, :cnt]), \
        "boolean indexing disagrees"
    out.append(dict(
        name="stream_compact", err=err,
        shape=f"{L} streams x {list(mask.shape)}, count {cnt}, out_len "
        f"{out_len}",
        ms=cuda_ms(lambda: K.stream_compact(*a, **kw)),
        kernel_ms=own_kernel_ms(K, lambda: K.stream_compact(*a, **kw)),
        plain_ms=cuda_ms(lambda: K.plain_stream_compact(*a, **kw)),
        library_ms=cuda_ms(lambda: streams[:, mask]),
        bytes=mask.numel() + b4 * (2 * L * cnt + L * (w * out_len - cnt)
                                   + w)))
    return out


def k7_args(K, call):
    """(columns, gid, emit, slots, accumulator dtypes) of a recorded K7
    call, in its list form."""
    a, kw = call
    accs = a[4] if len(a) > 4 else kw.get("accs")
    _single, xs, accs = K._sum_args(a[0], accs)
    return xs, a[1], a[2], a[3], accs


def check_k7(K, call, reps: int = 7, warm: int = 2,
             others: bool = True) -> dict:
    """K7 on the inputs of a recorded call (its list form: every float
    sum of one groupby) against its plain version, bit for bit, timed;
    beside it ``torch.segment_reduce`` (the library call, once a column
    on the column widened to its accumulator, the times summed) and, with
    ``others``, for the first column ``index_put_(accumulate=True)`` and
    ``index_add_`` (the earlier route), each timed, held against K7's
    row-order sums and against a second call of itself; the bytes K7 must
    move (every emit byte, each live row's gid and distinct source
    values, every column's slots) and the longest group's rows. ``reps``
    and ``warm``: the timed and untimed calls of each form before the
    median is taken (each form has run before it is timed)."""
    xs, gid, emit, s, accs = k7_args(K, call)
    w, n = gid.shape

    def k7():
        return K.segment_sum(xs, gid, emit, s, accs)

    got = k7()
    ref = K.plain_segment_sum(xs, gid, emit, s, accs)
    ibits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    exact = all(torch.equal(a.view(ibits[a.element_size()]),
                            b.view(ibits[b.element_size()]))
                for a, b in zip(got, ref))
    err = max(float((a.double() - b.double()).abs().max()) for a, b in
              zip(got, ref))
    s1 = s + 1
    off = torch.arange(w, device=gid.device).unsqueeze(-1) * s1
    slot = (torch.where(emit, gid, s) + off).reshape(-1)
    lengths = torch.bincount(slot, minlength=w * s1)
    longest = int(lengths.view(w, s1)[:, :s].max()) if s else 0
    wide = [x.to(a).reshape(-1) for x, a in zip(xs, accs)]

    def seg_reduce(flat):
        return torch.segment_reduce(flat, "sum", lengths=lengths,
                                    unsafe=True).view(w, s1)[:, :s]

    library_ms = sum(cuda_ms(lambda f=f: seg_reduce(f), reps=reps,
                             warm=warm) for f in wide)
    first = {}
    if others:
        x0, got0 = xs[0], got[0]
        b0 = ibits[x0.element_size()]
        pos = torch.arange(n, device=gid.device)
        spread = (torch.where(emit, gid, pos % s1) + off).reshape(-1)
        xz = torch.where(emit, x0, 0).reshape(-1)

        def index_put():
            return torch.zeros(w * s1, dtype=x0.dtype, device=x0.device
                               ).index_put_((spread,), xz, accumulate=True
                                            ).view(w, s1)[:, :s]

        def index_add():
            return torch.zeros(w * s1, dtype=x0.dtype, device=x0.device
                               ).index_add_(0, spread, xz).view(w, s1)[:, :s]

        for name, fn in (("segment_reduce", lambda: seg_reduce(
                x0.reshape(-1))), ("index_put", index_put),
                ("index_add", index_add)):
            a, b = fn(), fn()
            first[name] = {
                "ms": cuda_ms(fn, reps=reps, warm=warm),
                "equal_to_row_order": torch.equal(a.view(b0),
                                                  got0.view(b0)),
                "equal_run_to_run": torch.equal(a.view(b0), b.view(b0))}
    live = int(emit.sum())
    groups = int(lengths.view(w, s1)[:, :s].count_nonzero())
    srcs = {(x.data_ptr(), x.dtype): x.element_size() for x in xs}
    return dict(
        name="segment_sum", err=err, exact=exact,
        shape=f"{[str(x.dtype) for x in xs]} into "
        f"{[str(a) for a in accs]} {list(gid.shape)}, {s} slots, {groups} "
        f"groups, {live} live rows, the longest {longest}",
        columns=len(xs), longest=longest,
        ms=cuda_ms(k7, reps=reps, warm=warm),
        kernel_ms=own_kernel_ms(K, k7, reps=min(reps, 5)),
        plain_ms=cuda_ms(lambda: K.plain_segment_sum(xs, gid, emit, s, accs),
                         reps=reps, warm=warm),
        library_ms=library_ms, others=first,
        bytes=emit.numel() + (gid.element_size() + sum(srcs.values()))
        * live + sum(w * s * a.itemsize for a in accs))


def k7_phase11(K, groupby: dict, k7_call) -> dict:
    """K7 at phase 11's world-1 shapes against its plain version, bit
    for bit (check_k7): the recorded call (every float sum of the
    groupby: the float32 SUM and MEAN's float64 sum of one column), and
    its first column alone, with the other torch forms. Returns the
    call's numbers for the kernels line; launches from phase 11's
    world-1 run (counters 0 -> read)."""
    xs, gid, emit, s, accs = k7_args(K, k7_call)
    for what, call in (("single", ((xs[:1], gid, emit, s, accs[:1]), {})),
                       ("call", k7_call)):
        r = check_k7(K, call, others=what == "single")
        assert r["exact"], f"K7 disagrees with its plain version: {r}"
        r["bound_ms"] = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        groupby[f"k7_check_{what}"] = r
        log(f"phase 11 kernel check segment_sum, {what} ({r['shape']}): ms "
            f"{r['ms']:.4f} kernel_ms {r['kernel_ms']:.4f} plain "
            f"{r['plain_ms']:.4f} (on the host) bound {r['bound_ms']:.4f} "
            f"library (segment_reduce) {r['library_ms']:.4f} max_abs_err "
            f"{r['err']}; the other torch forms {r['others']}")
    return dict(launches=groupby["world1"]["launches"]["segment_sum"],
                max_abs_err=r["err"], ms=r["ms"], kernel_ms=r["kernel_ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by="bytes", library_ms=r["library_ms"])


# ---------------------------------------------------------------------------
# the set-op path
# ---------------------------------------------------------------------------


def make_setop_tables(ct, ctx, n: int, seed: int):
    """bench.py's bench_setops (seed 3) and bench_dist_union (seed 6)
    tables, the same generator sequence; also each side's rows packed as
    int64 ``k << 32 | g`` for the numpy reference."""
    rng = np.random.default_rng(seed)
    cols = []
    for _side in range(2):
        k = rng.integers(0, n, n).astype(np.int32)
        g = rng.integers(0, 1 << 20, n).astype(np.int32)
        cols.append((k, g))
    tables = [ct.Table.from_pydict(ctx, {"k": k, "g": g}) for k, g in cols]
    packed = [(k.astype(np.int64) << 32) | g.astype(np.int64)
              for k, g in cols]
    return tables[0], tables[1], packed


def numpy_setop_rows(pa: np.ndarray, pb: np.ndarray) -> dict:
    """Independent reference: the sorted distinct rows of each op."""
    ua, ub = np.unique(pa), np.unique(pb)
    return {"UNION": np.union1d(ua, ub),
            "SUBTRACT": np.setdiff1d(ua, ub, assume_unique=True),
            "INTERSECT": np.intersect1d(ua, ub, assume_unique=True)}


def setop_main_path(ct, K, n: int) -> dict:
    """Phase 5: the local set ops at full size on one card."""
    lctx = ct.CylonContext.Init()
    a, b, (pa, pb) = make_setop_tables(ct, lctx, n, 3)
    expect = {k: v.size for k, v in numpy_setop_rows(pa, pb).items()}
    del pa, pb
    sync()
    res = {"rows": n, "expect": expect, "launches": {}, "walls": {},
           "first_wall_s": {}, "n_coll": {}}
    for name in SETOP_OPS:
        def fn(_m=name.lower()):
            return getattr(a, _m)(b)

        assert all(getattr(m, v) is None for m, v in route_switches())
        K.reset_launches()
        with Recorder(K) as rec:
            t0 = time.perf_counter()
            out_k = fn()
            sync()
            first = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        res["launches"][name] = launches
        res["first_wall_s"][name] = first
        missing = [k for k in ("setop_stream", "stream_compact")
                   if launches[k] == 0]
        assert not missing, f"{name}: kernels not launched: {missing}"
        n_coll = int(rec.results["setop_stream"][0][:, 1].sum())
        res["n_coll"][name] = n_coll
        assert n_coll == 0, f"{name}: {n_coll} hash collisions"
        assert out_k.row_count == expect[name], (out_k.row_count,
                                                 expect[name])
        out_p = run_route(False, fn)
        assert out_p.row_count == expect[name]
        assert_same_rows(out_k, out_p, f"{name}: kernel vs plain route")
        log(f"phase 5 {name} (2 x {n} rows, world 1): launches {launches}, "
            f"n_coll 0, rows out {out_k.row_count} == numpy "
            f"{expect[name]}, capacity {out_k.capacity}, routes equal; "
            f"first run {first:.4f} s")
        if name == "UNION":
            res["calls"] = rec.calls
            res["capacity"] = out_k.capacity
        del out_k, out_p, rec
        walls = alternate(fn)
        res["walls"][name] = walls
        log(f"  steady walls (s) {walls}; median kernel "
            f"{statistics.median(walls['kernel']):.6f} (best "
            f"{min(walls['kernel']):.6f}), plain "
            f"{statistics.median(walls['plain']):.6f} (best "
            f"{min(walls['plain']):.6f})")
    prof = profile_once(lambda: a.union(b))
    res["profile"] = prof
    log(f"  profile of one kernel-route UNION: wall {prof['wall_ms']:.3f} "
        f"ms, device busy {prof['busy_ms']:.3f} ms (idle share "
        f"{prof['idle_share']:.4f}); top device time:")
    for nm, ms, c in prof["top"]:
        log(f"    {ms:9.3f} ms  x{c:<3d} {nm}")
    return res


def dist_union_path(ct, K, D, SO, dctx, n: int) -> dict:
    """Phase 6: bench_dist_union at world 4 (K1/K2 in the exchange)."""
    a, b, (pa, pb) = make_setop_tables(ct, dctx, n, 6)
    expect = numpy_setop_rows(pa, pb)["UNION"].size
    del pa, pb

    def fn():
        return D.distributed_set_op(a, b, SO.SetOp.UNION,
                                    force_exchange=True)

    sync()
    K.reset_launches()
    t0 = time.perf_counter()
    out_k = fn()
    sync()
    first = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    missing = [k for k in ("partition_hist", "partition_scatter")
               if launches[k] == 0]
    assert not missing, f"distributed union: not launched: {missing}"
    assert out_k.row_count == expect, (out_k.row_count, expect)
    out_p = run_route(False, fn)
    assert_same_rows(out_k, out_p, "distributed union: kernel vs plain")
    del out_k, out_p
    walls = alternate(fn)
    log(f"phase 6 distributed union (2 x {n} rows, world {WORLD}): "
        f"launches {launches}, rows out {expect} == numpy, routes equal; "
        f"first run {first:.4f} s; steady walls (s) {walls}")
    return {"rows": n, "launches": launches, "walls": walls,
            "first_wall_s": first, "out_rows": expect}


def small_setop_check(ct, lctx, dctx, seed: int) -> None:
    """Phase 7: duplicate-heavy tables (k, g in [0, 300), nulls in g, a
    filtered emit mask), all three ops at world 1 and 4, each equal row
    for row (after sorting) to an independent numpy set computation."""
    n = 100_003
    rng = np.random.default_rng(seed)
    sides = []
    for _side in range(2):
        k = rng.integers(0, 300, n).astype(np.int32)
        g = rng.integers(0, 300, n).astype(np.int32)
        gv = rng.random(n) < 0.95
        keep = rng.random(n) < 0.9
        # a null g compares equal to every null g: the validity is part
        # of the key, the data under a null is not
        packed = ((k.astype(np.int64) << 33) | (gv.astype(np.int64) << 32)
                  | np.where(gv, g, 0).astype(np.int64))[keep]
        sides.append((k, g, gv, keep, packed))
    ref = numpy_setop_rows(sides[0][4], sides[1][4])

    def table(ctx, k, g, gv, keep):
        dev = ctx.device
        t = ct.Table([ct.Column.from_numpy(k, "k", None, dev),
                      ct.Column.from_numpy(g, "g", gv, dev)], ctx)
        return t.filter_mask(torch.from_numpy(keep).to(dev))

    for ctx, world in ((lctx, 1), (dctx, WORLD)):
        a, b = (table(ctx, *s_[:4]) for s_ in sides)
        for name in SETOP_OPS:
            m = name.lower() if world == 1 else f"distributed_{name.lower()}"
            t = getattr(a, m)(b).compact()
            kc, gc = t._columns
            gvc = gc.valid_mask()
            got = ((kc.data.to(torch.int64) << 33)
                   | (gvc.to(torch.int64) << 32)
                   | torch.where(gvc, gc.data, 0).to(torch.int64))
            got = np.sort(got.cpu().numpy())
            assert np.array_equal(got, ref[name]), (world, name)
        log(f"phase 7 small set ops ({n} rows a side, world {world}): "
            f"{ {k: v.size for k, v in ref.items()} } rows, each equal to "
            f"numpy")


# ---------------------------------------------------------------------------
# groupby, sort and the compact exchange route (phases 10-13)
# ---------------------------------------------------------------------------

SUM_RTOL = 1e-5     # float SUM: |port - ref| <= 1e-5 * sum |x| + 1e-30
MEAN_RTOL = 1e-12   # float64 MEAN: <= 1e-12 * sum |x| / count


def steady(fn, reps: int = 5) -> list:
    """Walls (s) of ``reps`` runs of fn() after one warm-up, each ending
    in a synchronize."""
    fn()
    sync()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls.append(time.perf_counter() - t0)
        del out
    return walls


class RouteSpy:
    """Counts the calls of the exchange's compact route and records each
    call's round count (``shuffle._compact_body``)."""

    def __init__(self, S):
        self.S = S
        self.rounds = []

    def __enter__(self):
        self.real = self.S._compact_body

        def spy(world, block, rounds, *a):
            self.rounds.append(rounds)
            return self.real(world, block, rounds, *a)

        self.S._compact_body = spy
        return self

    def __exit__(self, *exc):
        self.S._compact_body = self.real


def live_columns(table) -> list:
    """Every column's live rows in the flat (shard by shard) order, host
    numpy, with its validity."""
    live = table.emit_mask()
    return [(c.data[live].cpu().numpy(), c.valid_mask()[live].cpu().numpy())
            for c in table._columns]


def assert_bits_equal(a, b, what: str) -> None:
    """Two results' live rows equal bit for bit, column by column (the
    float sums included: K7 adds each group in row order)."""
    ca, cb = live_columns(a), live_columns(b)
    assert len(ca) == len(cb), what
    for i, ((da, va), (db, vb)) in enumerate(zip(ca, cb)):
        assert np.array_equal(va, vb) and da.dtype == db.dtype and \
            np.array_equal(da.view(np.uint8), db.view(np.uint8)), (what, i)


def check_sums(got, ref, scale, what: str) -> float:
    """Float sums within SUM_RTOL of sum |x|; returns the worst ratio of
    error to its bound."""
    err = np.abs(got.astype(np.float64) - ref)
    bound = SUM_RTOL * scale + 1e-30
    assert np.all(err <= bound), (what, float((err / bound).max()))
    return float((err / bound).max()) if err.size else 0.0


def pipeline_phase(ct, K, D, S, dctx, n: int) -> dict:
    """Phase 10: bench.py bench_plan_pipeline's eager form at world 4: an
    inner distributed_join on k, then distributed_groupby([0], [4],
    [SUM]) of the right payload. The join leaves its rows placed by k, so
    the partials' exchange has a diagonal count matrix: it must take the
    compact route, and K1-K4 must launch."""
    lk, lv, lz, rk, rw = pipeline_arrays(n)
    left = ct.Table.from_pydict(dctx, {"k": lk, "v": lv, "z": lz})
    right = ct.Table.from_pydict(dctx, {"k": rk, "w": rw})
    agg = ct.AggregationOp.SUM

    def fn():
        j = D.distributed_join(left, right, ct.JoinConfig(
            ct.JoinType.INNER, [0], [0]))
        return D.distributed_groupby(j, [0], [4], [agg])

    sync()
    K.reset_launches()
    with RouteSpy(S) as spy, ChunkSpy(S) as cspy:
        t0 = time.perf_counter()
        out = fn()
        sync()
        first = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    missing = [k for k in ("partition_hist", "partition_scatter",
                           "join_plan_stream", "join_expand_stream",
                           "segment_sum") if launches[k] == 0]
    assert not missing, f"join -> groupby: not launched: {missing}"
    again = fn()
    assert_bits_equal(out, again, "join -> groupby: a second run")
    del again
    chunks = chunk_report(10, cspy, fn)
    assert spy.rounds, "the partials' exchange did not take the compact route"
    # numpy oracle: group k holds cnt_left(k) copies of each right row
    m = n // 4
    cl = np.bincount(lk, minlength=m).astype(np.float64)
    cr = np.bincount(rk, minlength=m)
    keys = np.flatnonzero((cl > 0) & (cr > 0))
    ref = (cl * np.bincount(rk, weights=rw.astype(np.float64),
                            minlength=m))[keys]
    scale = (cl * np.bincount(rk, weights=np.abs(rw).astype(np.float64),
                              minlength=m))[keys]
    (gk, gkv), (gs, gsv) = live_columns(out)
    assert gkv.all() and gsv.all()
    order = np.argsort(gk, kind="stable")
    assert np.array_equal(gk[order], keys), "join -> groupby: group keys"
    worst = check_sums(gs[order], ref, scale, "join -> groupby sums")
    del out
    walls = steady(fn)
    log(f"phase 10 join -> groupby (2 x {n} rows, world {WORLD}): launches "
        f"{launches}, compact route rounds {spy.rounds}; {len(keys)} groups "
        f"== numpy, sums within tolerance (worst error/bound {worst:.3e}) "
        f"and bit-equal in a second run; "
        f"first run {first:.4f} s; steady walls (s) {walls}; median "
        f"{statistics.median(walls):.6f}, input rows/s "
        f"{2 * n / statistics.median(walls):.4e}")
    return {"rows": n, "launches": launches, "compact_rounds": spy.rounds,
            "groups": int(len(keys)), "first_wall_s": first, "walls": walls,
            "worst_sum_err_over_bound": worst, "chunks": chunks}


def groupby_arrays(n: int):
    """bench.py bench_groupby's table (phase 11's generator)."""
    rng = np.random.default_rng(1)
    g = rng.integers(0, 1 << 20, n).astype(np.int32)
    x = rng.normal(size=n).astype(np.float32)
    y = rng.integers(0, 100, n).astype(np.int32)
    return g, x, y


def groupby_phase(ct, K, lctx, dctx, n: int) -> dict:
    """Phase 11: bench.py bench_groupby, groupby(0, [1, 2, 1], ["sum",
    "count", "mean"]) at world 1 and at world 4 (K1/K2), against numpy:
    keys and counts exact, sums and means within tolerance."""
    g, x, y = groupby_arrays(n)
    cnt = np.bincount(g, minlength=1 << 20)
    keys = np.flatnonzero(cnt)
    x64 = x.astype(np.float64)
    sx = np.bincount(g, weights=x64, minlength=1 << 20)[keys]
    ax = np.bincount(g, weights=np.abs(x64), minlength=1 << 20)[keys]
    res = {"rows": n}
    for ctx, world in ((lctx, 1), (dctx, WORLD)):
        t = ct.Table.from_pydict(ctx, {"g": g, "x": x, "y": y})

        def fn():
            return t.groupby(0, [1, 2, 1], ["sum", "count", "mean"])

        sync()
        K.reset_launches()
        with Recorder(K) as rec:
            t0 = time.perf_counter()
            out = fn()
            sync()
            first = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        if world == 1:
            res["calls"] = rec.calls["segment_sum"]
        need = ("partition_hist", "partition_scatter", "segment_sum") \
            if world > 1 else ("segment_sum",)
        missing = [k for k in need if launches[k] == 0]
        assert not missing, f"groupby world {world}: {missing}"
        again = fn()
        assert_bits_equal(out, again, f"groupby world {world}: a second run")
        del again
        cols = live_columns(out)
        assert all(v.all() for _d, v in cols)
        order = np.argsort(cols[0][0], kind="stable")
        gk, gs, gc, gm = (c[0][order] for c in cols)
        assert np.array_equal(gk, keys), f"groupby world {world}: keys"
        assert np.array_equal(gc, cnt[keys]), f"groupby world {world}: count"
        worst = check_sums(gs, sx, ax, f"groupby world {world} sums")
        merr = np.abs(gm - sx / cnt[keys])
        mbound = MEAN_RTOL * ax / cnt[keys]
        assert np.all(merr <= mbound), f"groupby world {world}: means"
        del out
        walls = steady(fn)
        med = statistics.median(walls)
        log(f"phase 11 groupby ({n} rows, world {world}): launches "
            f"{launches}; {len(keys)} groups, keys and counts == numpy, sums "
            f"(worst error/bound {worst:.3e}) and means within tolerance, "
            f"every column bit-equal in a second run; "
            f"first run {first:.4f} s; steady walls (s) {walls}; median "
            f"{med:.6f}, rows/s {n / med:.4e}")
        res[f"world{world}"] = {"launches": launches, "first_wall_s": first,
                                "walls": walls, "groups": int(len(keys)),
                                "worst_sum_err_over_bound": worst}
        del t
    return res


def sort_arrays(n: int):
    """bench.py bench_sort's table (phase 12's generator)."""
    rng = np.random.default_rng(2)
    k = rng.integers(0, 1 << 31, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    return k, v


def sort_phase(ct, K, D, lctx, dctx, n: int) -> dict:
    """Phase 12: bench.py bench_sort / bench_dist_sort: Table.sort("k") at
    world 1 and distributed_sort(force_exchange=True) at world 4 (K1/K2),
    against np.sort: the key sequence exact across shards in shard order,
    the rows equal as a multiset."""
    k, v = sort_arrays(n)
    ks = np.sort(k)
    rows = np.sort((k.astype(np.int64) << 32)
                   | v.view(np.uint32).astype(np.int64))
    res = {"rows": n}
    for ctx, world in ((lctx, 1), (dctx, WORLD)):
        t = ct.Table.from_pydict(ctx, {"k": k, "v": v})

        def fn():
            if world == 1:
                return t.sort("k")
            return D.distributed_sort(t, "k", force_exchange=True)

        sync()
        K.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        sync()
        first = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        if world > 1:
            missing = [x for x in ("partition_hist", "partition_scatter")
                       if launches[x] == 0]
            assert not missing, f"sort world {world}: {missing}"
        (gk, gkv), (gv, gvv) = live_columns(out)
        assert gkv.all() and gvv.all()
        assert np.array_equal(gk, ks), f"sort world {world}: key sequence"
        got = np.sort((gk.astype(np.int64) << 32)
                      | gv.view(np.uint32).astype(np.int64))
        assert np.array_equal(got, rows), f"sort world {world}: rows"
        del out
        walls = steady(fn)
        med = statistics.median(walls)
        log(f"phase 12 sort ({n} rows, world {world}): launches {launches}; "
            f"key sequence == np.sort, rows equal as a multiset; first run "
            f"{first:.4f} s; steady walls (s) {walls}; median {med:.6f}, "
            f"rows/s {n / med:.4e}")
        res[f"world{world}"] = {"launches": launches, "first_wall_s": first,
                                "walls": walls}
        del t
    return res


def numpy_join_rows(lk, lv, rk, rv, how: str) -> list:
    """Independent reference: the sorted (lk, lv, rk, rv) rows of a join
    on int keys, None where a side has no match."""
    rows = []
    for i in range(len(lk)):
        hit = np.flatnonzero(rk == lk[i])
        rows += [(int(lk[i]), float(lv[i]), int(rk[j]), float(rv[j]))
                 for j in hit]
        if not len(hit) and how in ("left", "outer"):
            rows.append((int(lk[i]), float(lv[i]), None, None))
    if how in ("right", "outer"):
        rows += [(None, None, int(rk[j]), float(rv[j]))
                 for j in range(len(rk)) if not (lk == rk[j]).any()]
    return sorted(rows, key=repr)


def table_rows(table) -> list:
    cols = [[(None if not ok else (float(x) if d.dtype.kind == "f"
                                   else int(x))) for x, ok in zip(d, v)]
            for d, v in live_columns(table)]
    return sorted(zip(*cols), key=repr) if cols else []


def small_inputs_phase(ct, K, D, S) -> dict:
    """Phase 13: small and empty inputs on the card. World 4 and 8; 0, 1,
    3 and 15 rows a side and an empty left side; all four join types and
    the three distributed set ops against numpy, the compact route
    observed; one join with MAX_BLOCK cut so that it runs several rounds;
    one hash_partition and one repartition check."""
    out = {"cases": 0, "compact_calls": 0}
    with RouteSpy(S) as spy:
        for world in (4, 8):
            ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world))
            for nl, nr in ((0, 0), (1, 1), (3, 3), (15, 15), (0, 9)):
                rng = np.random.default_rng(100 * nl + nr + world)
                lk = rng.integers(0, 4, nl).astype(np.int32)
                lv = rng.normal(size=nl).astype(np.float32)
                rk = rng.integers(0, 4, nr).astype(np.int32)
                rv = rng.normal(size=nr).astype(np.float32)
                left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv})
                right = ct.Table.from_pydict(ctx, {"k": rk, "v": rv})
                for how in ("inner", "left", "right", "outer"):
                    got = table_rows(left.distributed_join(right, how,
                                                           on=["k"]))
                    assert got == numpy_join_rows(lk, lv, rk, rv, how), \
                        (world, nl, nr, how)
                    out["cases"] += 1
                pl = {(int(a), float(b)) for a, b in zip(lk, lv)}
                pr = {(int(a), float(b)) for a, b in zip(rk, rv)}
                for op, ref in (("union", pl | pr), ("subtract", pl - pr),
                                ("intersect", pl & pr)):
                    got = table_rows(getattr(left, f"distributed_{op}")(
                        right))
                    assert got == sorted(ref, key=repr), (world, nl, nr, op)
                    out["cases"] += 1
        out["compact_calls"] = len(spy.rounds)
        assert out["compact_calls"], "no small input took the compact route"
        # several rounds: a block cap of 2 rows for a 15-row join
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
        rng = np.random.default_rng(7)
        lk, rk = (rng.integers(0, 3, 15).astype(np.int32) for _ in range(2))
        lv, rv = (rng.normal(size=15).astype(np.float32) for _ in range(2))
        left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv})
        right = ct.Table.from_pydict(ctx, {"k": rk, "v": rv})
        old, S.MAX_BLOCK = S.MAX_BLOCK, 2
        spy.rounds.clear()
        try:
            got = table_rows(left.distributed_join(right, "inner", on=["k"]))
        finally:
            S.MAX_BLOCK = old
        assert spy.rounds and max(spy.rounds) > 1, spy.rounds
        assert got == numpy_join_rows(lk, lv, rk, rv, "inner")
        out["max_rounds"] = max(spy.rounds)
    # hash_partition: every live row in exactly one partition, each row's
    # partition its key hash's; repartition: row i of the layout on shard
    # i % world, the rows unchanged as a multiset
    rng = np.random.default_rng(11)
    k = rng.integers(0, 1000, 10_000).astype(np.int32)
    v = rng.normal(size=10_000).astype(np.float32)
    t = ct.Table.from_pydict(ctx, {"k": k, "v": v})
    parts = D.hash_partition(t, ["k"], 5)
    from cylon_tpu_torch.ops import hash as H

    target = H.partition_targets([t._columns[0]], 5).cpu().numpy()
    seen = []
    for p, pt in parts.items():
        pk = pt._columns[0].data.cpu().numpy()
        assert np.array_equal(pk, k[target == p]), f"partition {p}"
        seen.append(len(pk))
    assert sum(seen) == len(k)
    r = D.repartition(t, ctx)
    rk = r._columns[0].data.view(4, -1).cpu().numpy()
    live = r.emit_mask().view(4, -1).cpu().numpy()
    for sh in range(4):
        assert np.array_equal(rk[sh][live[sh]], k[sh::4]), f"shard {sh}"
    rows = live.sum(1)
    log(f"phase 13 small inputs (world 4 and 8, 0/1/3/15 rows a side and an "
        f"empty left side): {out['cases']} joins and set ops == numpy, "
        f"{out['compact_calls']} compact-route exchanges; a 15-row join in "
        f"{out['max_rounds']} rounds == numpy; hash_partition into 5 "
        f"{seen} and repartition rows {rows.tolist()} checked")
    out["hash_partition_rows"] = seen
    out["repartition_rows"] = rows.tolist()
    return out


# ---------------------------------------------------------------------------
# string columns (phases 14-16)
# ---------------------------------------------------------------------------

STRING_KEYS = 1 << 20   # bench.py's n_keys (n // 4) at 4,194,304 rows


def make_string_table(ct, ctx, n: int, seed: int):
    """bench.py's bench_string_join / bench_dist_string_join tables: key
    "u" + 8 hex digits of ks + "xxx" (12 bytes, 3 words, varbytes), ks
    uniform in [0, 2^20), and a float32 normal payload from the same
    generator. Returns (table, ks, v)."""
    from cylon_tpu_torch.data.strings import VarBytes

    r = np.random.default_rng(seed)
    ks = r.integers(0, STRING_KEYS, n)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    b = np.empty((n, 12), np.uint8)
    b[:, 0] = ord("u")
    for j in range(8):
        b[:, 1 + j] = hexd[(ks >> (28 - 4 * j)) & 0xF]
    b[:, 9:] = ord("x")
    vb = VarBytes._from_packed(b.tobytes(), np.full(n, 12, np.int32),
                               device=ctx.device)
    v = r.normal(size=n).astype(np.float32)
    t = ct.Table([ct.Column.from_varbytes(vb, None, "k"),
                  ct.Column.from_numpy(v, "v", None, ctx.device)], ctx)
    return t, ks, v


def decode_hex_keys(col) -> torch.Tensor:
    """ks back from the 12-byte keys on the card (bytes 1-8 are its hex
    digits); asserts every key is "u" + 8 hex digits + "xxx"."""
    w = [l.to(torch.int64) & 0xFFFFFFFF for l in col.varbytes.word_lanes(3)]
    byte = [(w[i // 4] >> (8 * (i % 4))) & 0xFF for i in range(12)]
    assert bool((col.varbytes.lengths == 12).all()), "key lengths"
    assert bool((byte[0] == ord("u")).all()) and all(
        bool((x == ord("x")).all()) for x in byte[9:]), "key bytes"
    k = torch.zeros_like(w[0])
    for x in byte[1:9]:
        k = k * 16 + torch.where(x >= ord("a"), x - ord("a") + 10,
                                 x - ord("0"))
    return k


def numpy_join_arrays(lk, lv, rk, rv):
    """Independent reference: (key, left payload bits, right payload
    bits) of the inner join, unsorted."""
    order = np.argsort(rk, kind="stable")
    rks = rk[order]
    lo = np.searchsorted(rks, lk, "left")
    cnt = np.searchsorted(rks, lk, "right") - lo
    li = np.repeat(np.arange(len(lk)), cnt)
    ri = order[np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(len(li))]
    return (lk[li].astype(np.int64), lv[li].view(np.uint32).astype(np.int64),
            rv[ri].view(np.uint32).astype(np.int64))


def canonical_triples(k, a, b) -> torch.Tensor:
    """[m, 3] int64 rows sorted by (k, a, b) on the card; k < 2^31, a and
    b 32-bit."""
    p = torch.sort(b, stable=True).indices
    p = p[torch.sort(((k << 32) | a)[p], stable=True).indices]
    return torch.stack([k[p], a[p], b[p]], 1)


def check_string_join(out, expect) -> int:
    """The join's live rows equal the numpy join's: keys decoded from the
    bytes of both key columns, payload bits."""
    t = out.compact()
    lk, rk = decode_hex_keys(t._columns[0]), decode_hex_keys(t._columns[2])
    assert torch.equal(lk, rk), "left and right keys differ"
    bits = [c.data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            for c in (t._columns[1], t._columns[3])]
    got = canonical_triples(lk, *bits)
    ref = canonical_triples(*(torch.from_numpy(x).to(got.device)
                              for x in expect))
    assert got.shape == ref.shape and torch.equal(got, ref), \
        "string join rows disagree with numpy"
    return int(got.shape[0])


class HashModeSpy:
    """Records, per K3 call, the number of verify lanes (hash mode) and
    payload lanes."""

    def __init__(self, K):
        self.K = K
        self.calls = []

    def __enter__(self):
        self.real = self.K.join_plan_stream

        def spy(**kw):
            self.calls.append((kw.get("bits2_s") is not None,
                               len(kw.get("verify_lanes", ())),
                               len(kw.get("lanes", ()))))
            return self.real(**kw)

        self.K.join_plan_stream = spy
        return self

    def __exit__(self, *exc):
        self.K.join_plan_stream = self.real


def string_join_phase(ct, K, ctx, n: int, world: int, seeds) -> dict:
    """Phases 14 (world 1, Table.join) and 15 (world 4, distributed_join
    with force_exchange): two string-key tables of n rows, an inner join
    on k. K3 must run in hash mode with 4 verify lanes (3 words and the
    length) and K4 launch (and K1/K2 at world 4); the rows equal a numpy
    join on ks. Median of 5 steady walls, 2n / wall rows/s, one profile."""
    phase = 14 if world == 1 else 15
    left, lk, lv = make_string_table(ct, ctx, n, seeds[0])
    right, rk, rv = make_string_table(ct, ctx, n, seeds[1])
    expect = numpy_join_arrays(lk, lv, rk, rv)

    def fn():
        if world == 1:
            return left.join(right, "inner", on=["k"])
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    from cylon_tpu_torch.parallel import shuffle as S

    sync()
    K.reset_launches()
    with Recorder(K) as rec, HashModeSpy(K) as hm, ChunkSpy(S) as cspy:
        t0 = time.perf_counter()
        out = fn()
        sync()
        first = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    chunks = chunk_report(phase, cspy, fn) if world > 1 else None
    need = ["join_plan_stream", "join_expand_stream"] + (
        ["partition_hist", "partition_scatter"] if world > 1 else [])
    missing = [k for k in need if launches[k] == 0]
    assert not missing, f"string join world {world}: not launched {missing}"
    assert hm.calls and all(h and v == 4 for h, v, _l in hm.calls), \
        f"K3 not in hash mode with 4 verify lanes: {hm.calls}"
    rows = check_string_join(out, expect)
    del out
    walls = steady(fn)
    med = statistics.median(walls)
    prof = profile_once(fn)
    log(f"phase {phase} string join (2 x {n} rows, 12-byte keys, world "
        f"{world}): launches {launches}, K3 (hash mode, verify lanes, "
        f"payload lanes) {hm.calls}; {rows} rows == numpy join; first run "
        f"{first:.4f} s; steady walls (s) {walls}; median {med:.6f}, input "
        f"rows/s {2 * n / med:.4e}; profile: wall {prof['wall_ms']:.3f} ms, "
        f"device busy {prof['busy_ms']:.3f} ms (idle share "
        f"{prof['idle_share']:.4f}); top device time:")
    for name, ms, calls in prof["top"]:
        log(f"    {ms:9.3f} ms  x{calls:<3d} {name}")
    return {"rows": n, "world": world, "launches": launches,
            "k3_calls": hm.calls, "out_rows": rows, "first_wall_s": first,
            "walls": walls, "rows_per_s": 2 * n / med, "profile": prof,
            "calls": rec.calls, "chunks": chunks}


class StringPolicy:
    """Sets the string ingest policy for a block: "dict" (always
    dictionary-encode) or "varbytes" (never)."""

    def __init__(self, storage: str):
        from cylon_tpu_torch.data import strings

        self.s, self.storage = strings, storage

    def __enter__(self):
        self.old = (self.s.DICT_MAX_VOCAB, self.s.DICT_MAX_RATIO)
        if self.storage == "dict":
            self.s.DICT_MAX_VOCAB, self.s.DICT_MAX_RATIO = 1 << 30, 1e9
        else:
            self.s.DICT_MAX_VOCAB = 0
        return self

    def __exit__(self, *exc):
        self.s.DICT_MAX_VOCAB, self.s.DICT_MAX_RATIO = self.old


def id_string(family: str, i):
    """The string of integer id i in a family (None stays None): "short"
    1-3 words with non-ASCII text and id 0 empty, "long" 11 words
    (content-hash keys, past LANE_WORDS_MAX), "sortlong" 19-20 words (past
    SORT_PREFIX_WORDS), "binary" non-UTF-8 bytes."""
    if i is None:
        return None
    if family == "short":
        return "" if i == 0 else f"é{i}"
    if family == "long":
        return "L" * 40 + f"{i:03d}"
    if family == "sortlong":
        return "S" * 70 + f"{i:03d}"[::-1] + "é" * (i % 3)
    return bytes([255 - i % 256, 0, i % 7]) * (1 + i % 3)


def id_rows(seed: int, n: int, span: int):
    r = np.random.default_rng(seed)
    ids = [int(x) for x in r.integers(0, span, n)]
    return [None if r.random() < 0.1 else i for i in ids]


def py_join(lid, lv, rid, rv, how, f):
    rows = []
    for i, a in enumerate(lid):
        hit = [j for j, b in enumerate(rid) if a is not None and b == a]
        rows += [(f(a), lv[i], f(rid[j]), rv[j]) for j in hit]
        if not hit and how in ("left", "outer"):
            rows.append((f(a), lv[i], None, None))
    if how in ("right", "outer"):
        rows += [(None, None, f(b), rv[j]) for j, b in enumerate(rid)
                 if b is None or b not in lid]
    return sorted(rows, key=repr)


def table_tuples(t) -> list:
    d = t.to_pydict()
    cols = [[(x.item() if isinstance(x, np.generic) else x) for x in v]
            for v in d.values()]
    cols = [[None if (isinstance(x, float) and x != x) else x for x in c]
            for c in cols]
    return sorted(zip(*cols), key=repr)


def string_small_phase(ct, K, D, lctx, dctx) -> dict:
    """Phase 16: string correctness at small size on the card against
    Python built from the same integer ids: dictionary and varbytes
    storage, nulls, empty strings, non-ASCII text, BINARY values; keys of
    1-3 words (word lanes), 11 words (content hash, the long-row word
    exchange) and 19-20 words (past the sort prefix); all four joins at
    world 1 and 4; the three set ops (dictionary: K5/K6 at world 1);
    groupby and sort at world 1 and 4; a mixed dictionary/varbytes
    concat_tables."""
    out = {"cases": 0}
    n = 40
    for family in ("short", "long", "binary", "sortlong"):
        for storage in ("dict", "varbytes"):
            if family == "binary" and storage == "dict":
                continue  # bytes values are always varbytes
            lid, rid = id_rows(1, n, 25), id_rows(2, n - 5, 25)
            lv, rv = list(range(n)), list(range(100, 100 + n - 5))

            def f(i, family=family):
                return id_string(family, i)

            def strings(ids):
                return np.array([f(i) for i in ids], dtype=object)

            for ctx, world in ((lctx, 1), (dctx, WORLD)):
                with StringPolicy(storage):
                    lt = ct.Table.from_pydict(ctx, {
                        "k": strings(lid), "v": np.array(lv, np.int64)})
                    rt = ct.Table.from_pydict(ctx, {
                        "k": strings(rid), "w": np.array(rv, np.int64)})
                assert lt._columns[0].is_varbytes == (storage != "dict")
                what = (family, storage, world)
                for how in ("inner", "left", "right", "outer"):
                    got = lt.join(rt, how, on=["k"]) if world == 1 else \
                        lt.distributed_join(rt, how, on=["k"])
                    assert table_tuples(got) == py_join(
                        lid, lv, rid, rv, how, f), what + (how,)
                    out["cases"] += 1
                # set ops on (k, v % 3) rows
                la = list(zip(strings(lid), [x % 3 for x in lv]))
                ra = list(zip(strings(rid), [x % 3 for x in rv]))
                with StringPolicy(storage):
                    sa = ct.Table.from_pydict(ctx, {
                        "k": strings(lid),
                        "g": np.array([x % 3 for x in lv], np.int64)})
                    sb = ct.Table.from_pydict(ctx, {
                        "k": strings(rid),
                        "g": np.array([x % 3 for x in rv], np.int64)})
                for op, ref in (("union", set(la) | set(ra)),
                                ("subtract", set(la) - set(ra)),
                                ("intersect", set(la) & set(ra))):
                    K.reset_launches()
                    res = getattr(sa, op)(sb) if world == 1 else \
                        getattr(sa, f"distributed_{op}")(sb)
                    sync()
                    if world == 1 and storage == "dict":
                        assert K.LAUNCHES["setop_stream"] == 1 and \
                            K.LAUNCHES["stream_compact"] >= 1, \
                            ("K5/K6 not launched", what, op)
                    assert table_tuples(res) == sorted(ref, key=repr), \
                        what + (op,)
                    out["cases"] += 1
                # groupby: count and sum of v per key (nulls one group)
                g = lt.groupby(0, [1, 1], ["count", "sum"])
                exp = {}
                for i, v in zip(lid, lv):
                    c, s = exp.get(f(i), (0, 0))
                    exp[f(i)] = (c + 1, s + v)
                assert table_tuples(g) == sorted(
                    ((k, c, s) for k, (c, s) in exp.items()), key=repr), \
                    what + ("groupby",)
                # sort: descending, nulls last, ties by v ascending
                srt = lt.sort(["k", "v"], [False, True]) if world == 1 else \
                    D.distributed_sort(lt, ["k", "v"], [False, True],
                                       force_exchange=True)
                keyed = sorted([(f(i), v) for i, v in zip(lid, lv)
                                if i is not None],
                               key=lambda x: x[1])
                keyed = sorted(keyed, key=lambda x: x[0], reverse=True)
                keyed += sorted([(None, v) for i, v in zip(lid, lv)
                                 if i is None], key=lambda x: x[1])
                d = srt.to_pydict()
                assert list(zip(d["k"].tolist(), d["v"].tolist())) == keyed, \
                    what + ("sort",)
                out["cases"] += 2
    # concat_tables of a dictionary and a varbytes column
    ids = id_rows(3, 30, 20)
    vals = np.array([id_string("short", i) for i in ids], dtype=object)
    with StringPolicy("dict"):
        a = ct.Table.from_pydict(lctx, {"k": vals[:15]})
    with StringPolicy("varbytes"):
        b = ct.Table.from_pydict(lctx, {"k": vals[15:]})
    both = ct.concat_tables([a, b], lctx)
    assert both._columns[0].is_varbytes
    assert both.to_pydict()["k"].tolist() == vals.tolist()
    out["cases"] += 1
    log(f"phase 16 strings at small size (dictionary and varbytes, 1-20 "
        f"word keys, BINARY, nulls, world 1 and {WORLD}): {out['cases']} "
        f"joins, set ops, groupbys, sorts and a mixed concat == Python")
    return out


# ---------------------------------------------------------------------------
# the ring join, the broadcast join, the salted shuffle and the chunked
# exchange (phases 17-21)
# ---------------------------------------------------------------------------


class ChunkSpy:
    """Records the chunk count of every padded exchange (the result of
    each ``shuffle._chunk_plan`` call)."""

    def __init__(self, S):
        self.S = S
        self.chunks = []

    def __enter__(self):
        self.real = self.S._chunk_plan

        def spy(block, world, row_bytes):
            cb, n = self.real(block, world, row_bytes)
            self.chunks.append(n)
            return cb, n

        self.S._chunk_plan = spy
        return self

    def __exit__(self, *exc):
        self.S._chunk_plan = self.real


class CallSpy:
    """Counts the calls of named functions of a module (every call still
    runs)."""

    def __init__(self, mod, names):
        self.mod, self.names = mod, names
        self.calls = {n: 0 for n in names}

    def __enter__(self):
        self.real = {n: getattr(self.mod, n) for n in self.names}
        for n, fn in self.real.items():
            def spy(*a, _n=n, _fn=fn, **kw):
                self.calls[_n] += 1
                return _fn(*a, **kw)

            setattr(self.mod, n, spy)
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.mod, n, fn)


def overlap_turns(fn, rounds: int = 5) -> dict:
    """Walls (s) of fn() with CYLON_EXCHANGE_OVERLAP at its default and at
    0, taken in turns."""
    walls = {"default": [], "off": []}
    for i in range(2 * rounds):
        name = ("default", "off")[(i + i // 2) % 2]
        if name == "off":
            os.environ["CYLON_EXCHANGE_OVERLAP"] = "0"
        try:
            t0 = time.perf_counter()
            out = fn()
            sync()
            walls[name].append(time.perf_counter() - t0)
            del out
        finally:
            os.environ.pop("CYLON_EXCHANGE_OVERLAP", None)
    return walls


def chunk_report(phase: int, spy, fn) -> dict:
    """The chunk counts of a phase's exchanges; where one chunked, the
    phase's walls with the overlap knob at its default and off."""
    out = {"chunks": list(spy.chunks)}
    if max(spy.chunks, default=1) > 1:
        out["overlap_walls"] = overlap_turns(fn)
    log(f"  phase {phase}: chunk counts of its padded exchanges "
        f"{spy.chunks}" + (f"; walls (s) overlap default / off "
                           f"{out['overlap_walls']}"
                           if "overlap_walls" in out else ""))
    return out


def shard_digests(table, first: int, nshards: int,
                  ordered: bool = False) -> dict:
    """{global shard: [live rows, sha256 of its rows]} of a table's
    ``nshards`` shards, the first of them global shard ``first``: every
    column's values and validity (varbytes by their lengths and content
    hashes), the rows in slot order (``ordered``) or sorted (the shard's
    row multiset, whatever its slot order)."""
    import hashlib

    from cylon_tpu_torch.data import strings
    from cylon_tpu_torch.ops import order

    emit = table.emit_mask()
    cap = emit.shape[0] // nshards
    bits = {4: torch.int32, 8: torch.int64}
    lanes = []
    for c in table._columns:
        valid = c.valid_mask()
        if c.is_varbytes:
            vb = c.varbytes
            vals = [vb.lengths, *strings._hash_rows(
                vb.words, vb.eff_starts(), vb.lengths, vb.max_words)]
        else:
            d = c.data
            vals = [d.view(bits[d.element_size()])
                    if d.element_size() in bits else d]
        # a null row's data is not its value: zeroed, so values count only
        lanes += [torch.where(valid, x, 0) for x in vals]
        lanes.append(valid.to(torch.int32))
    out = {}
    for j in range(nshards):
        live = emit[j * cap:(j + 1) * cap].nonzero().flatten() + j * cap
        cols = [x[live] for x in lanes]
        if not ordered:
            perm = order.lexsort_indices(cols)
            cols = [x[perm] for x in cols]
        h = hashlib.sha256()
        for x in cols:
            h.update(x.cpu().numpy().tobytes())
        out[str(first + j)] = [int(live.numel()), h.hexdigest()]
    return out


def mp_tables(ct, ctx, n: int, seed: int):
    """Phase 2's tables (make_tables' draws), of which this process
    builds only its own shards' rows, through assemble_process_local."""
    from cylon_tpu_torch.parallel import shard

    rng = np.random.default_rng(seed)
    lk = rng.integers(0, n, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    rk = rng.integers(0, n, n).astype(np.int32)
    rv = rng.normal(size=n).astype(np.float32)
    cap = shard.shard_capacity(n, ctx.get_world_size())

    def side(k, v, name):
        return shard.assemble_process_local(
            [ct.Table.from_pydict(ctx, {"k": k[s * cap:(s + 1) * cap],
                                        name: v[s * cap:(s + 1) * cap]})
             for s in ctx.local_shard_indices()], ctx)

    return side(lk, lv, "v"), side(rk, rv, "w")


JOIN_KERNELS = ("partition_hist", "partition_scatter", "join_plan_stream",
                "join_expand_stream")


def mp_child(args) -> int:
    """One process of phase 22a: joins the gloo group, runs phase 2's
    join on its own shards, writes what it saw to ``--child-out``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K

    unbuilt = [s for s in K.SOURCES if not K._lib_path(s).exists()]
    assert not unbuilt, f"kernels not built by phase 1: {unbuilt}"
    ctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
        num_processes=MP_PROCS, process_id=args.mp_child, backend="gloo",
        shards_per_process=MP_SHARDS, init_method=f"file://{args.rdv}"))
    left, right = mp_tables(ct, ctx, args.rows, args.seed)

    def join():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    sync()
    K.reset_launches()
    out = join()
    sync()
    launches = dict(K.LAUNCHES)
    rows = out.row_count
    digests = shard_digests(out, ctx.get_rank(), MP_SHARDS)
    del out
    walls = []
    for _ in range(5):
        ctx.barrier()
        t0 = time.perf_counter()
        out = join()
        sync()
        ctx.barrier()
        walls.append(time.perf_counter() - t0)
        del out
    with open(args.child_out, "w") as f:
        json.dump({"rank": args.mp_child, "device": str(ctx.device),
                   "backend": ctx.comm.backend, "launches": launches,
                   "rows": rows, "digests": digests, "walls_s": walls}, f)
    ctx.finalize()
    return 0


def run_children(extra, phase: str) -> list:
    """Start MP_PROCS copies of this script (``--mp-child RANK`` and
    ``extra``) on a fresh ``file://`` rendezvous, wait for all of them
    within MP_TIMEOUT_S (a process still running then is killed), fail on
    a non-zero exit with its log's tail; each process's JSON result."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mp_")
    t0 = time.perf_counter()
    procs, logs = [], []
    try:
        for r in range(MP_PROCS):
            logs.append(open(os.path.join(tmp, f"child{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mp-child",
                 str(r), *extra, "--rdv", os.path.join(tmp, "rdv"),
                 "--child-out", os.path.join(tmp, f"child{r}.json")],
                stdout=logs[-1], stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=max(MP_TIMEOUT_S - (time.perf_counter() - t0),
                               1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, lg) in enumerate(zip(procs, logs)):
        lg.seek(0)
        tail = lg.read()[-4000:]
        lg.close()
        assert p.returncode == 0, \
            f"phase {phase} process {r} exited {p.returncode}:\n{tail}"
    out = []
    for r in range(MP_PROCS):
        with open(os.path.join(tmp, f"child{r}.json")) as f:
            out.append(json.load(f))
    return out


def mp_phase(args, digests2: dict, expect_rows: int) -> dict:
    """Phase 22a: the two processes of the gloo group on this card."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    children = run_children(["--rows", str(args.rows), "--seed",
                             str(args.seed)], "22a")
    seconds = time.perf_counter() - t0
    for r, c in enumerate(children):
        missing = [k for k in JOIN_KERNELS if c["launches"][k] == 0]
        assert not missing, f"process {r}: kernels not launched {missing}"
        assert c["rows"] == expect_rows, (r, c["rows"], expect_rows)
        for s, d in c["digests"].items():
            assert d == digests2[s], \
                f"process {r} shard {s} differs from the virtual world's"
    assert sorted(s for c in children for s in c["digests"]) == \
        sorted(digests2)
    med = [statistics.median(c["walls_s"]) * 1e3 for c in children]
    log(f"phase 22a process group {MP_PROCS} x {MP_SHARDS} on one card "
        f"(gloo, staged through host memory; {args.rows} rows a side): "
        f"launches {[c['launches'] for c in children]}; shards equal "
        f"the virtual world's; rows {expect_rows}; median walls (ms) a "
        f"process {med}; walls (s) {[c['walls_s'] for c in children]}; "
        f"phase {seconds:.2f} s")
    return {"children": children, "median_ms": med, "seconds": seconds}


def nccl_phase(ct, K, args, virtual_tables, digests2: dict,
               expect_rows: int) -> dict:
    """Phase 22b: a one-process NCCL group of four shards, in turns with
    phase 2's join on the virtual world (``virtual_tables``)."""
    t0 = time.perf_counter()
    left_v, right_v = virtual_tables
    pctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
        num_processes=1, shards_per_process=WORLD))
    try:
        assert pctx.comm.backend == "nccl", pctx.comm.backend
        left_p, right_p = mp_tables(ct, pctx, args.rows, args.seed)

        def join(a, b):
            return lambda: a.distributed_join(b, "inner", on=["k"],
                                              force_exchange=True)

        sync()
        K.reset_launches()
        out = join(left_p, right_p)()
        sync()
        launches = dict(K.LAUNCHES)
        missing = [k for k in JOIN_KERNELS if launches[k] == 0]
        assert not missing, f"kernels not launched: {missing}"
        assert out.row_count == expect_rows
        assert shard_digests(out, 0, WORLD) == digests2, \
            "the process group's shards differ from the virtual world's"
        del out
        walls = in_turns({"virtual_world": join(left_v, right_v),
                          "process_group": join(left_p, right_p)})
    finally:
        pctx.finalize()
    med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    seconds = time.perf_counter() - t0
    log(f"phase 22b one-process NCCL group of {WORLD} shards: launches "
        f"{launches}; shards equal the virtual world's; median ms {med}; "
        f"walls (s) "
        f"{walls}; phase {seconds:.2f} s")
    return {"launches": launches, "walls_s": walls, "median_ms": med,
            "seconds": seconds}


def in_turns(fns: dict, rounds: int = 5) -> dict:
    """Walls (s) of each named fn, one warm-up each, then ``rounds``
    rounds in turns, the order reversed every other round."""
    names = list(fns)
    for n in names:
        fns[n]()
        sync()
    walls = {n: [] for n in names}
    for i in range(rounds):
        for n in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            out = fns[n]()
            sync()
            walls[n].append(time.perf_counter() - t0)
            del out
    return walls


def shard_canonical(table, world: int) -> list:
    """Each live row's shard and columns (data bits, validity), sorted by
    shard, then the columns: equal lists mean equal shards as row
    multisets."""
    from cylon_tpu_torch.ops import order

    emit = table.emit_mask()
    live = emit.nonzero().flatten()
    sid = (live // (emit.shape[0] // world)).to(torch.int32)
    cols = []
    for c in table._columns:
        d = c.data[live]
        cols += [d.view(torch.int32) if d.element_size() == 4 else d,
                 c.valid_mask()[live].to(torch.int32)]
    perm = order.lexsort_indices([sid] + cols)
    return [sid[perm]] + [x[perm] for x in cols]


def join_bits(table):
    """(k, v bits, w bits, w valid) of a compacted k | v | k | w join
    output, int64 on the card."""
    t = table.compact()
    k, v, k2, w = t._columns
    hit = w.valid_mask()
    assert torch.equal(k.data[hit], k2.data[hit]), "key columns differ"

    def bits(c):
        return c.data.view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    return k.data.to(torch.int64), bits(v), bits(w), hit


def check_join_against_numpy(table, lk, lv, rk, rv, how: str) -> int:
    """The matched rows equal numpy_join_arrays' rows; for LEFT, the
    unmatched rows are the probe rows whose key the build side lacks."""
    k, v, w, hit = join_bits(table)
    dev = k.device
    got = canonical_triples(k[hit], v[hit], w[hit])
    ref = canonical_triples(*(torch.from_numpy(x).to(dev)
                              for x in numpy_join_arrays(lk, lv, rk, rv)))
    assert got.shape == ref.shape and torch.equal(got, ref), \
        f"{how} join: matched rows disagree with numpy"
    miss = ~np.isin(lk, rk)
    if how == "left":
        z = torch.zeros(int((~hit).sum()), dtype=torch.int64, device=dev)
        got_u = canonical_triples(k[~hit], v[~hit], z)
        zr = np.zeros(int(miss.sum()), np.int64)
        ref_u = canonical_triples(*(torch.from_numpy(x).to(dev) for x in (
            lk[miss].astype(np.int64),
            lv[miss].view(np.uint32).astype(np.int64), zr)))
        assert got_u.shape == ref_u.shape and torch.equal(got_u, ref_u), \
            "left join: unmatched rows disagree with numpy"
    else:
        assert bool(hit.all()), "inner join: a row without a match"
    return int(hit.numel())


def ring_phase(ct, K, D, dctx, n: int, seed: int) -> dict:
    """Phase 17: the ring join on the join's data (bench.py:99-110), inner,
    world 4: it stays on the ring (no fallback to the shuffle join), K3
    and K4 launch, the rows equal the numpy inner join, and every shard's
    rows equal the ring's plain route's (STREAM_PLAN False); the median
    of 5 steady walls in turns with the shuffle join of phase 2."""
    left, right, (lk, lv, rk, rv) = make_tables(ct, dctx, n, seed)

    def ring():
        return left.distributed_join(right, "inner", on=["k"], comm="ring")

    def shuffle_join():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    sync()
    K.reset_launches()
    with CallSpy(D, ["distributed_join"]) as fb:
        t0 = time.perf_counter()
        out = ring()
        sync()
        first = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert fb.calls["distributed_join"] == 0, "the ring fell back"
    missing = [k for k in ("join_plan_stream", "join_expand_stream")
               if launches[k] == 0]
    assert not missing, f"ring join: not launched {missing}"
    rows = check_join_against_numpy(out, lk, lv, rk, rv, "inner")
    plain = run_route(False, ring)
    assert plain.capacity == out.capacity
    a, b = shard_canonical(out, WORLD), shard_canonical(plain, WORLD)
    assert all(torch.equal(x, y) for x, y in zip(a, b)), \
        "ring join: a shard differs from the plain route's"
    per_shard = torch.bincount(a[0].to(torch.int64), minlength=WORLD)
    del out, plain, a, b
    walls = in_turns({"ring": ring, "shuffle": shuffle_join})
    med = {x: statistics.median(y) for x, y in walls.items()}
    prof = profile_once(ring)
    log(f"phase 17 ring join (2 x {n} rows, world {WORLD}): launches "
        f"{launches}; stayed on the ring; {rows} rows == numpy, every "
        f"shard == the plain route's (rows a shard "
        f"{per_shard.tolist()}); first run {first:.4f} s; steady walls (s) "
        f"{walls}; median ring {med['ring']:.6f}, shuffle join "
        f"{med['shuffle']:.6f}; profile: wall {prof['wall_ms']:.3f} ms, "
        f"busy {prof['busy_ms']:.3f} ms (idle {prof['idle_share']:.4f})")
    for name, ms, calls in prof["top"]:
        log(f"    {ms:9.3f} ms  x{calls:<3d} {name}")
    return {"rows": n, "launches": launches, "first_wall_s": first,
            "walls": walls, "out_rows": rows,
            "shard_rows": per_shard.tolist(), "profile": prof}


def broadcast_phase(ct, K, D, S, dctx, n: int) -> dict:
    """Phase 18: the broadcast hash join at bench_adaptive_join's shape
    (bench.py:346-370: n probe rows, n // 1000 build rows, keys in [0,
    n // 2000), default_rng(21)), world 4, INNER and LEFT with
    build_side=1: no exchange (K1 and K2 launch 0 times, shuffle.exchange
    is never called), K3 and K4 launch, the rows equal a numpy join; the
    median of 5 steady walls in turns with the shuffle join on the same
    tables."""
    rng = np.random.default_rng(21)
    nb = max(n // 1000, 64)
    keys = max(nb // 2, 1)
    lk = rng.integers(0, keys, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    rk = rng.integers(0, keys, nb).astype(np.int32)
    rv = rng.normal(size=nb).astype(np.float32)
    left = ct.Table.from_pydict(dctx, {"k": lk, "v": lv})
    right = ct.Table.from_pydict(dctx, {"k": rk, "w": rv})
    res = {"probe_rows": n, "build_rows": nb, "keys": keys}
    for how in ("inner", "left"):
        def bcast():
            return left.distributed_join(right, how, on=["k"],
                                         comm="broadcast", build_side=1)

        def shuffle_join():
            return left.distributed_join(right, how, on=["k"])

        sync()
        K.reset_launches()
        with CallSpy(D, ["exchange", "exchange_pair", "count_pair",
                         "distributed_join"]) as dspy, \
                CallSpy(S, ["exchange"]) as sspy:
            t0 = time.perf_counter()
            out = bcast()
            sync()
            first = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        calls = dict(dspy.calls, **{"shuffle.exchange":
                                    sspy.calls["exchange"]})
        assert not any(calls.values()), f"broadcast {how}: {calls}"
        assert launches["partition_hist"] == 0 \
            and launches["partition_scatter"] == 0, launches
        missing = [k for k in ("join_plan_stream", "join_expand_stream")
                   if launches[k] == 0]
        assert not missing, f"broadcast {how}: not launched {missing}"
        rows = check_join_against_numpy(out, lk, lv, rk, rv, how)
        del out
        walls = in_turns({"broadcast": bcast, "shuffle": shuffle_join})
        med = {x: statistics.median(y) for x, y in walls.items()}
        log(f"phase 18 broadcast join {how} ({n} probe x {nb} build rows, "
            f"world {WORLD}, build_side=1): launches {launches}, no "
            f"exchange; {rows} rows == numpy; first run {first:.4f} s; "
            f"steady walls (s) {walls}; median broadcast "
            f"{med['broadcast']:.6f}, shuffle join {med['shuffle']:.6f}")
        res[how] = {"launches": launches, "first_wall_s": first,
                    "walls": walls, "out_rows": rows}
    return res


def numpy_salted_targets(targets, emit, world: int, salt: int,
                         warn: float):
    """Independent numpy version of the salting rule: (salted targets,
    salted counts, raw counts)."""
    t = targets.reshape(world, -1).astype(np.int64)
    e = emit.reshape(world, -1)

    def counts(x):
        d = np.where(e, x, world)
        return np.stack([np.bincount(r, minlength=world + 1)[:world]
                         for r in d])

    raw = counts(t)
    recv = raw.sum(0)
    total = max(int(recv.sum()), 1)
    hot = recv.astype(np.float32) * np.float32(world) \
        > np.float32(warn) * np.float32(total)
    h = np.arange(t.shape[1], dtype=np.uint32)
    h ^= h >> 16
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> 13
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> 16
    sub = (h % np.uint32(salt)).astype(np.int64)
    safe = np.clip(t, 0, world - 1)
    t2 = np.where(hot[safe] & e, (safe + sub) % world, safe)
    return t2.reshape(-1), counts(t2), raw


def salted_phase(ct, K, D, S, dctx, n: int) -> dict:
    """Phase 19: the salted shuffle at bench.py:416-438's shape (n rows,
    70% key 7, the rest in [0, 2^20), v = arange; default_rng(21) after
    the broadcast phase's draws), world 4, CYLON_SALT_FACTOR at its
    default: K1 and K2 launch, the salted targets and both count
    matrices equal an independent numpy version of the rule, the rows
    equal the unsalted shuffle's as a multiset; max/mean shard imbalance
    and the median of 5 walls of both, in turns."""
    from cylon_tpu_torch.parallel import shard
    from cylon_tpu_torch.telemetry import knobs

    rng = np.random.default_rng(21)
    nb = max(n // 1000, 64)
    keys = max(nb // 2, 1)
    rng.integers(0, keys, n)
    rng.normal(size=n)
    rng.integers(0, keys, nb)
    rng.normal(size=nb)
    zk = np.where(rng.random(n) < 0.7, 7,
                  rng.integers(0, 1 << 20, n)).astype(np.int32)
    t = ct.Table.from_pydict(dctx, {"k": zk,
                                    "v": np.arange(n, dtype=np.float32)})
    salt = 1 << (max(int(knobs.get("CYLON_SALT_FACTOR")), 1).bit_length()
                 - 1)
    warn = float(knobs.get("CYLON_SKEW_WARN_FACTOR"))
    td = shard.distribute(t, dctx)
    targets = D._partition_targets_dist(WORLD, [td._columns[0]])
    emit = td.emit_mask()
    t2, sc, rc = S.salted_exchange_targets(targets, emit, dctx, salt, warn)
    n2, nsc, nrc = numpy_salted_targets(targets.cpu().numpy(),
                                        emit.cpu().numpy(), WORLD, salt,
                                        warn)
    assert np.array_equal(t2.cpu().numpy(), n2), "salted targets"
    assert np.array_equal(sc, nsc) and np.array_equal(rc, nrc), \
        "salted count matrices"

    def plain():
        return D.shuffle(t, ["k"])

    def salted():
        return D.shuffle(t, ["k"], salted=True)

    sync()
    K.reset_launches()
    out = salted()
    sync()
    launches = dict(K.LAUNCHES)
    missing = [k for k in ("partition_hist", "partition_scatter")
               if launches[k] == 0]
    assert not missing, f"salted shuffle: not launched {missing}"
    ref = plain()
    assert out._hash_partitioned is None
    ca, cb = canonical(out), canonical(ref)
    assert all(torch.equal(x, y) for p, q in zip(ca, cb)
               for x, y in zip(p, q)), "salted rows != unsalted rows"

    def imbalance(x):
        rows = x.emit_mask().view(WORLD, -1).sum(1).cpu().numpy()
        return float(rows.max() / max(rows.sum() / WORLD, 1.0)), \
            rows.tolist()

    imb = {"salted": imbalance(out), "unsalted": imbalance(ref)}
    del out, ref, ca, cb
    walls = in_turns({"salted": salted, "unsalted": plain})
    med = {x: statistics.median(y) for x, y in walls.items()}
    log(f"phase 19 salted shuffle ({n} rows, 70% one key, world {WORLD}, "
        f"salt {salt}): launches {launches}; targets and count matrices == "
        f"numpy; rows == the unsalted shuffle's; max/mean imbalance "
        f"(rows a shard) salted {imb['salted']}, unsalted "
        f"{imb['unsalted']}; steady walls (s) {walls}; median salted "
        f"{med['salted']:.6f}, unsalted {med['unsalted']:.6f}")
    return {"rows": n, "salt": salt, "launches": launches,
            "imbalance": imb, "walls": walls,
            "raw_counts": rc.tolist(), "salted_counts": sc.tolist()}


def chunked_phase(ct, K, S, dctx, n: int) -> dict:
    """Phase 20: bench_shuffle_pipeline (bench.py:237-345): n rows, 4
    float32 and 1 int64 leaves (24 bytes a row), uniform targets, every
    row live, default_rng(12), world 4, the counted padded route with the
    chunk bytes of bench.py:277 (a pipeline at least 4 deep): K1 and K2
    launch, the chunked output equals the single-shot one
    (CYLON_EXCHANGE_OVERLAP=0) bit for bit on every shard; the chunk
    count, the median of 5 walls of both in turns, and each route's
    torch.cuda.max_memory_allocated over one call."""
    rng = np.random.default_rng(12)
    dev = dctx.device
    payload = {f"f{i}": torch.from_numpy(
        rng.normal(size=n).astype(np.float32)).to(dev) for i in range(4)}
    payload["i0"] = torch.from_numpy(
        rng.integers(0, 1 << 31, n).astype(np.int64)).to(dev)
    targets = torch.from_numpy(
        rng.integers(0, WORLD, n).astype(np.int32)).to(dev)
    emit = torch.ones(n, dtype=torch.bool, device=dev)
    counts = S._count_matrix(dctx.comm, targets, emit).cpu().numpy()
    _ok, block, _mb = S._padded_route(counts, payload, WORLD,
                                      dctx.memory_pool.comm_budget_bytes())
    cbytes = max((WORLD * 24 * block) // 4, 1 << 12)

    def run(overlap: str):
        os.environ["CYLON_EXCHANGE_OVERLAP"] = overlap
        os.environ["CYLON_EXCHANGE_CHUNK_BYTES"] = str(cbytes)
        try:
            return S.exchange(payload, targets, emit, dctx, counts=counts)
        finally:
            os.environ.pop("CYLON_EXCHANGE_OVERLAP", None)
            os.environ.pop("CYLON_EXCHANGE_CHUNK_BYTES", None)

    res = {"rows": n, "block": block, "chunk_bytes": cbytes, "peak": {},
           "launches": {}}
    outs = {}
    for name, overlap in (("chunked", "1"), ("single", "0")):
        sync()
        K.reset_launches()
        outs[name] = run(overlap)
        sync()
        res["launches"][name] = dict(K.LAUNCHES)
    missing = [k for k in ("partition_hist", "partition_scatter")
               if res["launches"]["chunked"][k] == 0]
    assert not missing, f"chunked exchange: not launched {missing}"
    (co, ce, ccap, cm), (so, se, scap, sm) = outs["chunked"], outs["single"]
    chunks = cm.get("chunks", 1)
    assert chunks >= 4 and "chunks" not in sm, (chunks, sm)
    assert ccap == scap and torch.equal(ce, se) \
        and torch.equal(cm["counts_in"], sm["counts_in"])
    for k in payload:
        assert torch.equal(co[k][ce], so[k][se]), f"chunked leaf {k}"
    res["chunks"] = chunks
    del outs, co, so, ce, se, cm, sm
    # each route's peak over one call, from the same baseline (the inputs
    # only): max_memory_allocated after reset_peak_memory_stats
    for name, overlap in (("chunked", "1"), ("single", "0"), ("chunked", "1"),
                          ("single", "0")):
        sync()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = run(overlap)
        sync()
        res["peak"].setdefault(name, []).append({
            "max_memory_allocated": int(torch.cuda.max_memory_allocated()),
            "before": int(before)})
        del out
    walls = in_turns({"chunked": lambda: run("1"),
                      "single": lambda: run("0")})
    med = {x: statistics.median(y) for x, y in walls.items()}
    res["walls"] = walls
    log(f"phase 20 chunked exchange ({n} rows, 24 bytes a row, world "
        f"{WORLD}, block {block}, chunk bytes {cbytes}): {chunks} chunks; "
        f"launches {res['launches']}; output == single-shot bit for bit on "
        f"every shard; peak bytes (max_memory_allocated, allocated before) "
        f"{res['peak']}; steady walls (s) {walls}; median chunked "
        f"{med['chunked']:.6f}, single-shot {med['single']:.6f}")
    return res


def small_variants_phase(ct, K, D, S) -> dict:
    """Phase 21: the new paths at small size, against Python joins or the
    single-shot exchange: world 4 and 8, 0-15 rows a side and a hot key;
    the ring join (INNER, LEFT, RIGHT and its FULL_OUTER fallback), the
    broadcast join in every legal (join type, build side) and one illegal
    pair, the salted shuffle on uniform keys (untouched), a remainder
    chunk."""
    out = {"cases": 0}
    legal = [("inner", 0), ("inner", 1), ("left", 1), ("right", 0),
             ("left", 0)]
    for world in (4, 8):
        ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(world))
        for nl, nr, hot in ((0, 0, False), (1, 1, False), (3, 3, False),
                            (15, 15, False), (0, 9, False), (15, 4, True)):
            rng = np.random.default_rng(100 * nl + nr + world)
            lk = rng.integers(0, 4, nl).astype(np.int32)
            rk = rng.integers(0, 4, nr).astype(np.int32)
            if hot:
                lk[: nl - 2] = 1
                rk[: nr - 1] = 1
            lv = rng.normal(size=nl).astype(np.float32)
            rv = rng.normal(size=nr).astype(np.float32)
            left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv})
            right = ct.Table.from_pydict(ctx, {"k": rk, "v": rv})
            for how in ("inner", "left", "right", "outer"):
                got = table_rows(left.distributed_join(right, how,
                                                       on=["k"],
                                                       comm="ring"))
                assert got == numpy_join_rows(lk, lv, rk, rv, how), \
                    ("ring", world, nl, nr, how)
                out["cases"] += 1
            for how, side in legal:
                got = table_rows(left.distributed_join(
                    right, how, on=["k"], comm="broadcast",
                    build_side=side))
                assert got == numpy_join_rows(lk, lv, rk, rv, how), \
                    ("broadcast", world, nl, nr, how, side)
                out["cases"] += 1
        rng = np.random.default_rng(world)
        u = ct.Table.from_pydict(ctx, {
            "k": rng.integers(0, 4096, 4096).astype(np.int32),
            "v": np.arange(4096, dtype=np.float32)})
        a, b = D.shuffle(u, ["k"]), D.shuffle(u, ["k"], salted=True)
        assert torch.equal(a.emit_mask(), b.emit_mask()) and all(
            torch.equal(x.data, y.data)
            for x, y in zip(a._columns, b._columns)), "salted uniform"
        out["cases"] += 1
    # a remainder chunk: 3-row chunks of a padded exchange
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(4))
    rng = np.random.default_rng(3)
    n = 4096
    dev = ctx.device
    payload = {"a": torch.from_numpy(rng.integers(0, 1 << 30, n).astype(
        np.int32)).to(dev), "b": torch.from_numpy(rng.random(n) < 0.5).to(
        dev)}
    targets = torch.from_numpy(rng.integers(0, 4, n).astype(
        np.int32)).to(dev)
    emit = torch.from_numpy(rng.random(n) < 0.85).to(dev)
    base = S.exchange(payload, targets, emit, ctx)
    real = S._chunk_plan
    S._chunk_plan = lambda block, w, rb: (3, -(-block // 3))
    try:
        got = S.exchange(payload, targets, emit, ctx)
    finally:
        S._chunk_plan = real
    assert got[3]["chunks"] == -(-base[3]["block"] // 3)
    assert got[2] == base[2] and torch.equal(got[1], base[1])
    for k in payload:
        assert torch.equal(got[0][k][got[1]], base[0][k][base[1]])
    out["cases"] += 1
    out["remainder_chunks"] = got[3]["chunks"]
    log(f"phase 21 small ring, broadcast, salted and chunked cases (world "
        f"4 and 8, 0-15 rows a side, a hot key): {out['cases']} cases == "
        f"Python joins or the single-shot exchange (a remainder exchange "
        f"in {out['remainder_chunks']} chunks of 3 rows)")
    return out


# phase 23a: tests/test_torch_port_plan.py's same_keys case holds the
# port's (plan.shuffle, shuffle.exchange) counts of this plan equal to
# cylon_tpu's on the CPU, and test_known_shuffle_counts pins them there
REFERENCE_PLANNED_COUNTS = (1, 1)
PIPELINE_KERNELS = ("partition_hist", "partition_scatter",
                    "join_plan_stream", "join_expand_stream")


def exchange_counts(cp) -> tuple:
    """(plan-level exchange stages, physical exchanges) of a
    collect_phases run."""
    return cp.count("plan.shuffle"), cp.count("shuffle.exchange")


def pipeline_arrays(n: int, seed: int = 9):
    """bench.py bench_plan_pipeline's tables (phase 10's generator; seed
    11 is bench_service_pipeline's, phase 24a's)."""
    rng = np.random.default_rng(seed)
    lk = rng.integers(0, n // 4, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    lz = rng.integers(0, 50, n).astype(np.int32)
    rk = rng.integers(0, n // 4, n).astype(np.int32)
    rw = rng.normal(size=n).astype(np.float32)
    return lk, lv, lz, rk, rw


def join_groupby_oracle(lk, rk, rw, m: int):
    """numpy groupby of the numpy join: (group keys, sums, sum |x|, join
    rows)."""
    cl = np.bincount(lk, minlength=m).astype(np.float64)
    cr = np.bincount(rk, minlength=m)
    keys = np.flatnonzero((cl > 0) & (cr > 0))
    ref = (cl * np.bincount(rk, weights=rw.astype(np.float64),
                            minlength=m))[keys]
    scale = (cl * np.bincount(rk, weights=np.abs(rw).astype(np.float64),
                              minlength=m))[keys]
    return keys, ref, scale, int((cl * cr).sum())


def check_groups(out, keys, ref, scale, what: str) -> float:
    """A (key, sum) result against the oracle: keys exact, sums within
    tolerance; returns the worst error over its bound."""
    (gk, gkv), (gs, gsv) = live_columns(out)
    assert gkv.all() and gsv.all(), what
    order = np.argsort(gk, kind="stable")
    assert np.array_equal(gk[order], keys), f"{what}: group keys"
    return check_sums(gs[order], ref, scale, f"{what} sums")


def plan_pipeline_phase(ct, K, D, dctx, n: int) -> dict:
    """Phase 23a: bench.py bench_plan_pipeline's planned form,
    ``plan.scan(left).join(plan.scan(right), on="k").groupby("lt-0",
    ["rt-4"], ["sum"]).execute()`` at world 4, in turns with phase 10's
    eager form on the same tables."""
    lk, lv, lz, rk, rw = pipeline_arrays(n)
    left = ct.Table.from_pydict(dctx, {"k": lk, "v": lv, "z": lz})
    right = ct.Table.from_pydict(dctx, {"k": rk, "w": rw})
    agg = ct.AggregationOp.SUM

    def eager():
        j = D.distributed_join(left, right, ct.JoinConfig(
            ct.JoinType.INNER, [0], [0]))
        return D.distributed_groupby(j, [0], [4], [agg])

    def query():
        return ct.plan.scan(left).join(ct.plan.scan(right), on="k") \
            .groupby("lt-0", ["rt-4"], ["sum"])

    def planned():
        return query().execute()

    keys, ref, scale, join_rows = join_groupby_oracle(lk, rk, rw, n // 4)
    sync()
    with ct.telemetry.collect_phases() as cpe:
        e_out = eager()
        sync()
    eager_counts = exchange_counts(cpe)
    sync()
    K.reset_launches()
    with ct.telemetry.collect_phases() as cpp:
        t0 = time.perf_counter()
        p_out = planned()
        sync()
        first = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    missing = [k for k in PIPELINE_KERNELS if launches[k] == 0]
    assert not missing, f"planned pipeline: not launched: {missing}"
    planned_counts = exchange_counts(cpp)
    assert planned_counts[1] < eager_counts[1], (planned_counts,
                                                 eager_counts)
    assert planned_counts == REFERENCE_PLANNED_COUNTS, planned_counts
    worst_e = check_groups(e_out, keys, ref, scale, "eager pipeline")
    worst_p = check_groups(p_out, keys, ref, scale, "planned pipeline")
    del e_out, p_out
    walls = in_turns({"eager": eager, "planned": planned})
    med = {k: statistics.median(v) for k, v in walls.items()}
    prof = {k: profile_once(f) for k, f in (("eager", eager),
                                            ("planned", planned))}
    log(f"phase 23a planned pipeline (2 x {n} rows, world {WORLD}): "
        f"launches {launches}; (plan.shuffle, shuffle.exchange) planned "
        f"{planned_counts} == reference {REFERENCE_PLANNED_COUNTS}, eager "
        f"{eager_counts}; {len(keys)} groups == numpy for both forms "
        f"(worst error/bound eager {worst_e:.3e}, planned {worst_p:.3e}); "
        f"first planned run {first:.4f} s; walls in turns (s) {walls}; "
        f"median eager {med['eager']:.6f}, planned {med['planned']:.6f}, "
        f"eager / planned {med['eager'] / med['planned']:.3f}")
    for k, pr in prof.items():
        log(f"  profile of one {k} run: wall {pr['wall_ms']:.3f} ms, device "
            f"busy {pr['busy_ms']:.3f} ms (idle share "
            f"{pr['idle_share']:.4f}); top device time:")
        for name, ms, calls in pr["top"]:
            log(f"    {ms:9.3f} ms  x{calls:<3d} {name}")
    return {"rows": n, "launches": launches, "profile": prof,
            "planned_counts": list(planned_counts),
            "eager_counts": list(eager_counts), "groups": int(len(keys)),
            "join_rows": join_rows, "walls": walls, "median_s": med,
            "first_planned_wall_s": first,
            "worst_sum_err_over_bound": {"eager": worst_e,
                                         "planned": worst_p},
            "tables": (left, right), "oracle": (keys, ref, scale)}


def plan_report_phase(ct, n: int, pipe23: dict) -> dict:
    """Phase 23b: one ``execute(analyze=True)`` of phase 23a's query at
    full size: the PlanReport's rows per node against the numpy counts,
    its shuffle_count against 23a's, the memory gauges sampled and every
    span carrying ``hbm_delta``."""
    left, right = pipe23.pop("tables")
    keys, ref, scale = pipe23.pop("oracle")
    q = ct.plan.scan(left).join(ct.plan.scan(right), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"])
    out = q.execute(analyze=True)
    sync()
    rep = q.last_report
    check_groups(out, keys, ref, scale, "analyzed pipeline")
    expect = {"groupby": len(keys), "join": pipe23["join_rows"],
              "project": n, "scan": n}

    def walk(m):
        yield m
        for c in m.children:
            yield from walk(c)

    rows = [(m.kind, m.rows) for m in walk(rep.root) if m.executed]
    for kind, r in rows:
        assert r == expect[kind], (kind, r, expect[kind])
    assert rep.root.rows == out.row_count
    assert rep.shuffle_count == pipe23["planned_counts"][0], \
        (rep.shuffle_count, pipe23["planned_counts"])
    assert rep.memory and rep.memory["hbm_live_bytes"] > 0, rep.memory
    no_hbm = [s.name for s in rep.span.walk() if "hbm_delta" not in s.attrs]
    assert not no_hbm, f"spans without hbm_delta: {no_hbm}"
    d = rep.to_dict()
    log(json.dumps({k: v for k, v in d.items() if k != "metrics"},
                   default=str))
    log(rep.render())
    log(f"phase 23b EXPLAIN ANALYZE: node rows {rows} == numpy, "
        f"shuffle_count {rep.shuffle_count}, {len(list(rep.span.walk()))} "
        f"spans with hbm_delta, memory {rep.memory}")
    return {"report": d, "node_rows": rows}


def _rows_set(table) -> list:
    return sorted(set(table_rows(table)), key=repr)


def plan_nodes_phase(ct, K, D, lctx, dctx) -> dict:
    """Phase 23c: every plan node kind at small size, world 4 and world
    1, each against the port's eager composition and numpy: scan,
    filter, project; an explicit shuffle, salted too; the shuffle join,
    a forced broadcast join (CYLON_JOIN_ALGORITHM=broadcast) and a join
    of co-partitioned inputs with its exchanges elided; groupby; union,
    subtract, intersect (K5 and K6 launch at world 1); sort."""
    P = ct.plan
    rng = np.random.default_rng(23)
    n = 3000
    lk = rng.integers(0, 500, n).astype(np.int32)
    lv = rng.normal(size=n).astype(np.float32)
    lz = rng.integers(0, 50, n).astype(np.int32)
    rk = rng.integers(0, 500, n).astype(np.int32)
    rw = rng.normal(size=n).astype(np.float32)
    rz = rng.integers(0, 50, n).astype(np.int32)
    rpos = {}
    for j, key in enumerate(rk.tolist()):
        rpos.setdefault(key, []).append(j)
    # the inner join's (k, v, z, k, w) rows
    jrows = sorted(((int(lk[i]), float(lv[i]), int(lz[i]), int(rk[j]),
                     float(rw[j])) for i in range(n)
                    for j in rpos.get(int(lk[i]), ())), key=repr)
    checked = {}
    for world, ctx in ((WORLD, dctx), (1, lctx)):
        left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv, "z": lz})
        right = ct.Table.from_pydict(ctx, {"k": rk, "w": rw})
        done = []
        # scan -> filter -> project
        got = P.scan(left).filter(P.col("z") < 25).project(["k", "v"]) \
            .execute()
        eager = left.filter_mask(left._columns[2].data < 25).project([0, 1])
        m = lz < 25
        ref = sorted(((int(a), float(b)) for a, b in zip(lk[m], lv[m])),
                     key=repr)
        assert table_rows(got) == table_rows(eager) == ref, "filter/project"
        done.append("scan/filter/project")
        # explicit shuffle, then salted
        lrows = sorted(((int(a), float(b), int(c))
                        for a, b, c in zip(lk, lv, lz)), key=repr)
        got = P.scan(left).shuffle("k").execute()
        assert table_rows(got) == table_rows(D.shuffle(left, ["k"])) \
            == lrows, "shuffle"
        root, _st = P.scan(left).shuffle("k").optimized()
        sh = next(x for x in P.ir.walk(root) if x.kind == "shuffle")
        sh.salted = True
        with ct.telemetry.collect_phases() as cp:
            got = P.executor.execute(root, ctx)
        assert table_rows(got) == table_rows(
            D.shuffle(left, ["k"], salted=True)) == lrows, "salted shuffle"
        if world > 1:
            sp = [x for x in cp.spans if x.name == "plan.shuffle.explicit"]
            assert sp and sp[0].attrs.get("salted") is True, cp.labels
        done.append("shuffle/salted")
        # the shuffle join, a forced broadcast join, co-partitioned inputs
        for algo in ("shuffle", "broadcast"):
            os.environ["CYLON_JOIN_ALGORITHM"] = algo
            try:
                K.reset_launches()
                with ct.telemetry.collect_phases() as cp:
                    got = P.scan(left).join(P.scan(right), on="k").execute()
                launches = dict(K.LAUNCHES)
            finally:
                os.environ.pop("CYLON_JOIN_ALGORITHM", None)
            assert table_rows(got) == table_rows(left.distributed_join(
                right, "inner", on=["k"])) == jrows, f"{algo} join"
            assert launches["join_plan_stream"] > 0 \
                and launches["join_expand_stream"] > 0, (algo, launches)
            jsp = [x for x in cp.spans if x.name.startswith(
                ("plan.join", "plan.shuffle.join"))]
            expect_algo = "local" if world == 1 else algo
            assert jsp[0].attrs["join_algorithm"] == expect_algo, \
                (algo, jsp[0].attrs)
            if world > 1 and algo == "broadcast":
                assert launches["partition_hist"] == 0 \
                    and cp.count("shuffle.exchange") == 0, (launches,
                                                            cp.labels)
        if world > 1:
            lp = ct.distribute_by_key(left, ctx, ["k"])
            rp = ct.distribute_by_key(right, ctx, ["k"])
            with ct.telemetry.collect_phases() as cp:
                got = P.scan(lp).join(P.scan(rp), on="k").execute()
            assert exchange_counts(cp) == (0, 0), cp.labels
            assert table_rows(got) == jrows, "co-partitioned join"
        done.append("join shuffle/broadcast" + (
            "/co-partitioned" if world > 1 else ""))
        # groupby
        got = P.scan(left).groupby("k", ["v", "z"], ["sum", "count"]) \
            .execute()
        eager = left.groupby(0, [1, 2], ["sum", "count"])
        (gk, _), (gs, _), (gc, _) = live_columns(got)
        (ek, _), (es, _), (ec, _) = live_columns(eager)
        o, oe = np.argsort(gk), np.argsort(ek)
        keys = np.unique(lk)
        assert np.array_equal(gk[o], keys) and np.array_equal(ek[oe], keys)
        assert np.array_equal(gc[o], np.bincount(lk)[keys]) \
            and np.array_equal(ec[oe], gc[o]), "groupby counts"
        sums = np.bincount(lk, weights=lv.astype(np.float64))[keys]
        scale = np.bincount(lk, weights=np.abs(lv).astype(np.float64))[keys]
        check_sums(gs[o], sums, scale, "planned groupby")
        check_sums(es[oe], sums, scale, "eager groupby")
        done.append("groupby")
        # set ops on (k, z) rows
        a = ct.Table.from_pydict(ctx, {"k": lk % 64, "z": lz % 8})
        b = ct.Table.from_pydict(ctx, {"k": rk % 64, "z": rz % 8})
        sa = set(zip((lk % 64).tolist(), (lz % 8).tolist()))
        sb = set(zip((rk % 64).tolist(), (rz % 8).tolist()))
        ref_sets = {"union": sa | sb, "subtract": sa - sb,
                    "intersect": sa & sb}
        for op, exp in ref_sets.items():
            K.reset_launches()
            got = getattr(P.scan(a), op)(P.scan(b)).execute()
            sync()
            launches = dict(K.LAUNCHES)
            eager = getattr(a, op if world == 1 else f"distributed_{op}")(b)
            rows = table_rows(got)
            assert rows == table_rows(eager) == sorted(exp, key=repr), op
            if world == 1:
                assert launches["setop_stream"] > 0 \
                    and launches["stream_compact"] > 0, (op, launches)
        done.append("union/subtract/intersect")
        # sort
        got = P.scan(left).sort("k").execute()
        eager = D.distributed_sort(left, "k") if world > 1 \
            else left.sort("k")
        gkeys = live_columns(got)[0][0]
        assert np.array_equal(gkeys, np.sort(lk)) and np.array_equal(
            gkeys, live_columns(eager)[0][0]), "sort order"
        assert table_rows(got) == lrows, "sort rows"
        done.append("sort")
        checked[world] = done
    log(f"phase 23c plan node kinds ({n} rows a side): world {WORLD} "
        f"{checked[WORLD]}; world 1 {checked[1]} (K5/K6 launched on each "
        f"world-1 set op); each equal to the eager composition and numpy")
    return {"rows": n, "checked": {str(k): v for k, v in checked.items()}}


# ---------------------------------------------------------------------------
# the query service, the task exchange and the edges (phase 24)
# ---------------------------------------------------------------------------

SERVICE_QUERIES = 8
# 24a's plan-cache (hits, misses) over bench.py bench_service_pipeline's
# sequence on an empty cache and warehouse: the warm-up execute, the 8
# executes under plancache.disabled(), the 8 served queries; the JAX
# package's counts on the CPU for the same sequence
# (tests/test_torch_port_service.py holds them)
REFERENCE_SERVICE_CACHE = {"warmup": (0, 1), "sequential": (0, 0),
                           "service": (8, 0)}
# 24c's DRR run (quantum 1,024 bytes): one join -> groupby of 4,096 rows
# a side from tenant "expensive", then three sorts of 64 rows from
# tenant "cheap"; the dispatch order the JAX package gives on the CPU
REFERENCE_DRR_SEQ = {"expensive": [4], "cheap": [1, 2, 3]}
OBS_ROUTES = ("/metrics", "/healthz", "/queries", "/slo", "/stats")


def counter_total(ct, prefix: str) -> int:
    """The sum of every integer series whose key starts with prefix."""
    return sum(v for k, v in ct.telemetry.metrics_snapshot().items()
               if k.startswith(prefix) and isinstance(v, int))


def cache_counts(ct) -> tuple:
    return (counter_total(ct, "cylon_plan_cache_hits_total"),
            counter_total(ct, "cylon_plan_cache_misses_total"))


def service_query(ct, left, right):
    """bench.py bench_service_pipeline's query."""
    return ct.plan.scan(left).join(ct.plan.scan(right), on="k") \
        .groupby("lt-0", ["rt-4"], ["sum"])


def serve(ct, queries, name: str):
    """Submit every query to a paused QueryService (tenants t0 and t1 in
    turns), start it, drain it and take every result: (tickets, results,
    wall in s, ending in a synchronize)."""
    from cylon_tpu_torch.service import QueryService

    svc = QueryService(name=name, start=False)
    t0 = time.perf_counter()
    tickets = [svc.submit(q, tenant=f"t{i % 2}")
               for i, q in enumerate(queries)]
    svc.start()
    svc.drain(timeout=600)
    outs = [tk.result(timeout=600) for tk in tickets]
    sync()
    wall = time.perf_counter() - t0
    svc.close()
    return tickets, outs, wall


def service_pipeline_phase(ct, K, dctx, n: int) -> dict:
    """Phase 24a: bench.py bench_service_pipeline at world 4: a warm-up
    execute, then in turns, 3 rounds, 8 sequential executes under
    plancache.disabled() and 8 queries served by a QueryService. Starts
    from an empty plan cache and statistics warehouse."""
    from cylon_tpu_torch.service import plancache

    lk, lv, lz, rk, rw = pipeline_arrays(n, 11)
    left = ct.Table.from_pydict(dctx, {"k": lk, "v": lv, "z": lz})
    right = ct.Table.from_pydict(dctx, {"k": rk, "w": rw})
    keys, ref, scale, _rows = join_groupby_oracle(lk, rk, rw, n // 4)
    plancache.global_cache().clear()
    ct.telemetry.stats.reset()
    c0 = cache_counts(ct)
    sync()
    K.reset_launches()
    direct = service_query(ct, left, right).execute()
    sync()
    direct_launches = dict(K.LAUNCHES)
    missing = [k for k in PIPELINE_KERNELS if direct_launches[k] == 0]
    assert not missing, f"24a direct query: not launched: {missing}"
    check_groups(direct, keys, ref, scale, "24a direct query")
    del direct
    cache = {"warmup": tuple(np.subtract(cache_counts(ct), c0).tolist())}

    def sequential():
        with plancache.disabled():
            for _ in range(SERVICE_QUERIES):
                out = service_query(ct, left, right).execute()
                sync()
                del out

    walls = {"sequential": [], "service": []}
    waits, launches_svc, builds = [], [], []
    worst = 0.0
    for rnd in range(3):
        for name in (("sequential", "service") if rnd % 2 == 0
                     else ("service", "sequential")):
            c1 = cache_counts(ct)
            if name == "sequential":
                t0 = time.perf_counter()
                sequential()
                walls[name].append(time.perf_counter() - t0)
                cache[f"sequential{rnd}"] = tuple(
                    np.subtract(cache_counts(ct), c1).tolist())
                continue
            b0 = counter_total(ct, "cylon_kernel_factory_builds_total")
            K.reset_launches()
            tickets, outs, wall = serve(
                ct, [service_query(ct, left, right)
                     for _ in range(SERVICE_QUERIES)], f"chip-smoke-{rnd}")
            launches_svc.append(dict(K.LAUNCHES))
            builds.append(counter_total(
                ct, "cylon_kernel_factory_builds_total") - b0)
            cache[f"service{rnd}"] = tuple(
                np.subtract(cache_counts(ct), c1).tolist())
            walls[name].append(wall)
            assert [tk.outcome for tk in tickets] == ["ok"] * len(tickets)
            waits += [tk.wait_s for tk in tickets]
            if rnd == 0:
                for i, out in enumerate(outs):
                    worst = max(worst, check_groups(
                        out, keys, ref, scale, f"24a served query {i}"))
            del tickets, outs
    expect = {k: SERVICE_QUERIES * v for k, v in direct_launches.items()}
    assert all(la == expect for la in launches_svc), (launches_svc, expect)
    assert builds == [0, 0, 0], builds
    for k, v in cache.items():
        want = REFERENCE_SERVICE_CACHE[k.rstrip("0123456789")]
        assert v == want, (k, v, want)
    med = {k: statistics.median(v) for k, v in walls.items()}
    wait_stats = {"mean_s": float(np.mean(waits)),
                  "p95_s": float(np.percentile(waits, 95))}
    qps = SERVICE_QUERIES / med["service"]
    log(f"phase 24a service pipeline (2 x {n} rows, world {WORLD}, "
        f"{SERVICE_QUERIES} queries): direct launches {direct_launches}, "
        f"each served batch launched 8x that; plan cache (hits, misses) "
        f"{cache} == reference {REFERENCE_SERVICE_CACHE}; factory builds "
        f"over each service batch {builds}; {len(keys)} groups == numpy "
        f"for every served query (worst error/bound {worst:.3e}); walls in "
        f"turns (s) {walls}; median sequential {med['sequential']:.6f}, "
        f"service {med['service']:.6f}, sequential / service "
        f"{med['sequential'] / med['service']:.3f}; submit->dispatch wait "
        f"mean {wait_stats['mean_s']:.6f} s, p95 {wait_stats['p95_s']:.6f} "
        f"s; {qps:.3f} queries/s")
    return {"rows": n, "direct_launches": direct_launches,
            "service_launches": launches_svc, "cache": cache,
            "builds_delta": builds, "walls": walls, "median_s": med,
            "wait": wait_stats, "queries_per_s": qps,
            "groups": int(len(keys)), "worst_sum_err_over_bound": worst,
            "tables": (left, right), "oracle": (keys, ref, scale)}


def service_obs_phase(ct, pipe24: dict) -> dict:
    """Phase 24b: a second service pass of 24a's 8 queries while an
    ObsServer on an ephemeral port is scraped by two threads cycling
    through its five routes."""
    import gc
    import threading
    import urllib.request

    from cylon_tpu_torch.service import ObsServer, QueryService
    from cylon_tpu_torch.telemetry import ledger, querylog

    left, right = pipe24.pop("tables")
    keys, ref, scale = pipe24.pop("oracle")
    querylog.reset()
    roots = {}

    def root_hook(s):
        if s.name == "plan.query" and "query_id" in s.attrs:
            roots[s.attrs["query_id"]] = s.span_id

    ct.telemetry.add_root_hook(root_hook)
    svc = QueryService(name="chip-smoke-obs", start=False)
    obs = ObsServer(service=svc, port=0).start()
    stop = threading.Event()
    scrapes = {r: [] for r in OBS_ROUTES}   # each scrape's seconds
    health, errors = [], []

    def get(route):
        with urllib.request.urlopen(obs.url(route), timeout=60) as r:
            return r.status, r.read().decode("utf-8")

    def scraper(first: int):
        k, tail = first, None
        while tail is None or k < tail:
            if tail is None and stop.is_set():
                tail = k + len(OBS_ROUTES)   # one more full cycle
            route = OBS_ROUTES[k % len(OBS_ROUTES)]
            k += 1
            try:
                t0 = time.perf_counter()
                status, body = get(route)
                dt = time.perf_counter() - t0
                assert status == 200, (route, status)
                if route == "/metrics":
                    assert body.startswith("# TYPE"), body[:80]
                else:
                    doc = json.loads(body)
                    if route == "/healthz":
                        health.append((doc["service"]["active"],
                                       doc["pool"]["bytes_in_use"]))
                scrapes[route].append(dt)
            except Exception as e:  # noqa: BLE001 - handed to the caller
                errors.append((route, repr(e)))
                return

    threads = [threading.Thread(target=scraper, args=(i,))
               for i in range(2)]
    for th in threads:
        th.start()
    t0 = time.perf_counter()
    tickets = [svc.submit(service_query(ct, left, right),
                          tenant=f"t{i % 2}")
               for i in range(SERVICE_QUERIES)]
    svc.start()
    svc.drain(timeout=600)
    outs = [tk.result(timeout=600) for tk in tickets]
    sync()
    wall = time.perf_counter() - t0
    stop.set()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads), "a scraper hung"
    assert not errors, errors
    status, body = get("/queries")
    digests = [d for d in json.loads(body)
               if d.get("query_id") in {tk.query_id for tk in tickets}]
    obs.close()
    svc.close()
    ct.telemetry.remove_root_hook(root_hook)
    assert sorted((d["query_id"], d["tenant"]) for d in digests) == sorted(
        (tk.query_id, tk.tenant) for tk in tickets), digests
    assert health and all(b > 0 for _a, b in health), health[:4]
    during = sum(1 for a, _b in health if a is not None)
    assert during > 0, "no /healthz sample while a query ran"
    assert [tk.outcome for tk in tickets] == ["ok"] * len(tickets)
    worst = max(check_groups(out, keys, ref, scale, f"24b query {i}")
                for i, out in enumerate(outs))
    qids = [tk.query_id for tk in tickets]
    del tickets, outs
    gc.collect()
    leaks = {q: ledger.leak_report(roots[q]) for q in qids}
    assert all(not v for v in leaks.values()), leaks
    scrape_ms = {r: {"count": len(v), "median_ms":
                     1e3 * statistics.median(v) if v else None}
                 for r, v in scrapes.items()}
    log(f"phase 24b obs endpoint under load: service wall {wall:.6f} s "
        f"(24a median {pipe24['median_s']['service']:.6f}); scrapes "
        f"{scrape_ms}, every one 200 and parsed; {len(health)} /healthz "
        f"samples with live bytes > 0, {during} while a query ran; "
        f"/queries has one digest per query with its tenant; results == "
        f"numpy (worst error/bound {worst:.3e}); no query's root leaks")
    return {"wall_s": wall, "scrapes": scrape_ms,
            "healthz_samples": len(health), "healthz_during_query": during,
            "worst_sum_err_over_bound": worst}


def service_outcomes_phase(ct, K, lctx, dctx) -> dict:
    """Phase 24c: the service's outcomes at small size: a shed, a
    deadline, an error, backpressure, a DRR run of two tenants of
    unequal cost at world 4, and planned set ops served at world 1."""
    from cylon_tpu_torch.resilience import inject
    from cylon_tpu_torch.service import QueryService

    P = ct.plan

    hosts = {}

    def tables(ctx, n, seed):
        rng = np.random.default_rng(seed)
        lk = rng.integers(0, max(n // 4, 1), n).astype(np.int32)
        lv = rng.normal(size=n).astype(np.float32)
        lz = rng.integers(0, 50, n).astype(np.int32)
        rk = rng.integers(0, max(n // 4, 1), n).astype(np.int32)
        rw = rng.normal(size=n).astype(np.float32)
        left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv, "z": lz})
        right = ct.Table.from_pydict(ctx, {"k": rk, "w": rw})
        hosts[id(left)] = (lk, lz, rk, rw)
        return left, right

    def pipe(left, right):
        return P.scan(left).join(P.scan(right), on="k") \
            .groupby("lt-2", ["rt-4"], ["sum"])

    def check_pipe(out, left, what: str) -> float:
        """A pipe() result against numpy: the z groups of the join exact,
        the sums of w within tolerance."""
        lk, lz, rk, rw = hosts[id(left)]
        m = int(max(lk.max(), rk.max())) + 1
        sw = np.bincount(rk, weights=rw.astype(np.float64), minlength=m)
        sa = np.bincount(rk, weights=np.abs(rw).astype(np.float64),
                         minlength=m)
        keys = np.unique(lz[np.bincount(rk, minlength=m)[lk] > 0])
        ref = np.bincount(lz, weights=sw[lk], minlength=50)[keys]
        scale = np.bincount(lz, weights=sa[lk], minlength=50)[keys]
        return check_groups(out, keys, ref, scale, what)

    done = {}
    left, right = tables(dctx, 3000, 26)
    check_pipe(pipe(left, right).execute(), left, "24c direct query")
    # shed: a clamped budget sheds the big join, typed; the small
    # query of the other tenant runs
    big_l, big_r = tables(dctx, 1 << 16, 27)
    svc = QueryService(name="chip-smoke-shed", start=False)
    inject.arm("pool:262144:oom")
    try:
        ok_t = svc.submit(pipe(left, right), tenant="good")
        shed_t = svc.submit(P.scan(big_l).join(P.scan(big_r), on="k"),
                            tenant="greedy")
        svc.drain(timeout=600)
    finally:
        inject.disarm()
    assert ok_t.outcome == "ok" and shed_t.outcome == "shed", (
        ok_t.outcome, shed_t.outcome)
    check_pipe(ok_t.result(timeout=60), left, "24c query beside a shed")
    assert isinstance(shed_t._error, ct.CylonResourceExhausted), \
        shed_t._error
    svc.close()
    done["shed"] = type(shed_t._error).__name__
    del ok_t, shed_t, big_l, big_r
    # deadline
    svc = QueryService(name="chip-smoke-deadline", start=False)
    tk = svc.submit(pipe(left, right), tenant="late", deadline_s=1e-6)
    svc.drain(timeout=600)
    svc.close()
    assert tk.outcome == "timeout" and isinstance(
        tk._error, ct.CylonTimeoutError), (tk.outcome, tk._error)
    done["deadline"] = type(tk._error).__name__
    # error: a scan of a registered table that is removed before the
    # query runs (a missing input): typed, the next query runs
    ct.table_api.put_table("chip-smoke-gone", right)
    svc = QueryService(name="chip-smoke-error", start=False)
    bad = svc.submit(P.scan(left).join(P.scan("chip-smoke-gone"), on="k"),
                     tenant="t")
    ct.table_api.remove_table("chip-smoke-gone")
    good = svc.submit(pipe(left, right), tenant="t")
    svc.drain(timeout=600)
    svc.close()
    assert bad.outcome == "error" and isinstance(bad._error, ct.CylonError) \
        and bad._error.code == ct.Code.KeyError, (bad.outcome, bad._error)
    assert good.outcome == "ok"
    check_pipe(good.result(), left, "24c query after an error")
    done["error"] = f"{type(bad._error).__name__}({bad._error.code.name})"
    del bad, good
    # backpressure: a third submission to a paused service of queue
    # bound 2 is refused before enqueue
    os.environ["CYLON_SERVICE_QUEUE_MAX"] = "2"
    try:
        svc = QueryService(name="chip-smoke-bp", start=False)
        svc.submit(pipe(left, right), tenant="a")
        svc.submit(pipe(left, right), tenant="a")
        try:
            svc.submit(pipe(left, right), tenant="b")
            refused = None
        except ct.CylonResourceExhausted as e:
            refused = e
        assert refused is not None and "queue full" in str(refused)
        assert svc.depth("b") == 0 and svc.depth() == 2
    finally:
        os.environ.pop("CYLON_SERVICE_QUEUE_MAX")
    svc.drain(timeout=600)
    svc.close()
    done["backpressure"] = type(refused).__name__
    # DRR: a byte-weighted quantum lets the cheap tenant overtake
    os.environ["CYLON_SERVICE_QUANTUM_BYTES"] = "1024"
    try:
        el, er = tables(dctx, 4096, 24)
        sl, _sr = tables(dctx, 64, 25)
        svc = QueryService(name="chip-smoke-drr", start=False)
        exp = svc.submit(pipe(el, er), tenant="expensive")
        cheap = [svc.submit(P.scan(sl).sort("k"), tenant="cheap")
                 for _ in range(3)]
        svc.drain(timeout=600)
        svc.close()
    finally:
        os.environ.pop("CYLON_SERVICE_QUANTUM_BYTES")
    seq = {"expensive": [exp.dispatch_seq],
           "cheap": [c.dispatch_seq for c in cheap]}
    assert seq == REFERENCE_DRR_SEQ, seq
    done["drr"] = seq
    # planned set ops served at world 1: K5 and K6 launch
    rng = np.random.default_rng(28)
    a_k, a_z = rng.integers(0, 64, 3000), rng.integers(0, 8, 3000)
    b_k, b_z = rng.integers(0, 64, 3000), rng.integers(0, 8, 3000)
    a = ct.Table.from_pydict(lctx, {"k": a_k.astype(np.int32),
                                    "z": a_z.astype(np.int32)})
    b = ct.Table.from_pydict(lctx, {"k": b_k.astype(np.int32),
                                    "z": b_z.astype(np.int32)})
    sa = set(zip(a_k.tolist(), a_z.tolist()))
    sb = set(zip(b_k.tolist(), b_z.tolist()))
    ref_sets = {"union": sa | sb, "subtract": sa - sb, "intersect": sa & sb}
    K.reset_launches()
    tickets, outs, _wall = serve(
        ct, [getattr(P.scan(a), op)(P.scan(b)) for op in ref_sets],
        "chip-smoke-setops")
    launches = dict(K.LAUNCHES)
    assert launches["setop_stream"] >= 3 and \
        launches["stream_compact"] >= 3, launches
    for (op, exp_rows), out in zip(ref_sets.items(), outs):
        assert table_rows(out) == sorted(exp_rows, key=repr), op
    done["setops_world1"] = {k: launches[k] for k in
                             ("setop_stream", "stream_compact")}
    log(f"phase 24c service outcomes (3,000 rows a side, world {WORLD} and "
        f"1): {done}")
    return done


def task_exchange_phase(ct, K, dctx, n: int, seed: int) -> dict:
    """Phase 24d: plan.task_exchange of phase 2's left table (world 4)
    with task ids from default_rng(24) in [0, 64) and the plan {t: t %
    4}: K1 and K2 launch, every live row lands on its owner's shard with
    its ``__task__``, and each shard's rows equal a stable partition of
    the input in order (the payload is the input as a multiset)."""
    from cylon_tpu_torch.plan.tasks import LogicalTaskPlan, task_exchange

    left, _right, (lk, lv, _rk, _rv) = make_tables(ct, dctx, n, seed)
    tasks = np.random.default_rng(24).integers(0, 64, n)
    plan = LogicalTaskPlan({t: t % WORLD for t in range(64)}, WORLD)
    sync()
    K.reset_launches()
    out = task_exchange(left, tasks, plan, dctx)
    sync()
    launches = dict(K.LAUNCHES)
    assert launches["partition_hist"] > 0 and \
        launches["partition_scatter"] > 0, launches
    emit = out.emit_mask()
    cap = emit.shape[0] // WORLD
    dev = emit.device
    owner = torch.from_numpy(tasks % WORLD).to(dev)
    src = torch.stack([torch.from_numpy(lk).to(dev),
                       torch.from_numpy(lv.view(np.int32)).to(dev),
                       torch.from_numpy(tasks.astype(np.int32)).to(dev)], 1)
    got = torch.stack([out._columns[0].data, out._columns[1].data.view(
        torch.int32), out._columns[2].data], 1)
    rows = 0
    for s in range(WORLD):
        sl = slice(s * cap, (s + 1) * cap)
        mine = got[sl][emit[sl]]
        assert torch.equal(mine, src[owner == s]), f"shard {s}"
        rows += int(mine.shape[0])
    assert rows == n == out.row_count, (rows, n)
    del out, got, src, owner, emit

    def run():
        return task_exchange(left, tasks, plan, dctx)

    # the device part alone: the exchange of the rows and their ids, with
    # the ids and targets made once (task_exchange also validates the
    # ids and builds them on the host, as the reference does)
    from cylon_tpu_torch.parallel import dist_ops as D
    from cylon_tpu_torch.parallel import shard as SH

    t = SH.distribute(left, dctx)
    ids = torch.from_numpy(np.pad(tasks.astype(np.int32),
                                  (0, t.capacity - n))).to(dev)
    lut = torch.arange(64, dtype=torch.int32, device=dev) % WORLD
    targets = torch.take(lut, ids.to(torch.int64))

    def exchange_only():
        return D._exchange_table(t, targets, t.emit_mask(), dctx,
                                 {"__task__": ids})

    walls = in_turns({"task_exchange": run, "exchange": exchange_only})
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"phase 24d task exchange ({n} rows, world {WORLD}, 64 tasks): "
        f"launches {launches}; every shard's rows == the stable partition "
        f"of the input, with __task__; walls in turns (s) {walls}, median "
        f"task_exchange {med['task_exchange']:.6f}, its exchange alone "
        f"{med['exchange']:.6f}")
    return {"rows": n, "launches": launches, "walls": walls,
            "median_s": med}


def edges_phase(ct, K, dctx, n: int, seed: int) -> dict:
    """Phase 24e: arrow_builder from raw host buffers onto the card, a
    DataLoader over 4 CSV partitions written by benchutils, and one
    benchmark_with_repetitions timing of phase 2's join against the same
    wall taken by hand."""
    import tempfile

    from cylon_tpu_torch import arrow_builder, benchutils
    from cylon_tpu_torch.dtypes import Type
    from cylon_tpu_torch.io.dataloader import DataLoader

    # arrow_builder: int32, float64 with nulls, bool with a validity
    # bitmap, a string column
    rng = np.random.default_rng(seed)
    m = 1000
    ints = rng.integers(-1000, 1000, m).astype(np.int32)
    floats = rng.normal(size=m)
    fvalid = rng.random(m) > 0.1
    bools = rng.random(m) > 0.5
    bvalid = rng.random(m) > 0.2
    words = [("w%d" % i) * int(i % 4) for i in rng.integers(0, 500, m)]
    payload = np.frombuffer("".join(words).encode(), np.uint8)
    offsets = np.concatenate([[0], np.cumsum([len(w) for w in words])]) \
        .astype(np.int32)

    def addr(a):
        return a.ctypes.data, a.nbytes

    bits = {k: np.packbits(v, bitorder="little")
            for k, v in (("f", fvalid), ("b", bools), ("bv", bvalid))}
    arrow_builder.begin_table("chip-smoke-raw")
    arrow_builder.add_column("chip-smoke-raw", "i", int(Type.INT32), m, 0,
                             0, 0, *addr(ints))
    arrow_builder.add_column("chip-smoke-raw", "f", int(Type.DOUBLE), m,
                             int((~fvalid).sum()), *addr(bits["f"]),
                             *addr(floats))
    arrow_builder.add_column("chip-smoke-raw", "b", int(Type.BOOL), m,
                             int((~bvalid).sum()), *addr(bits["bv"]),
                             *addr(bits["b"]))
    arrow_builder.add_column("chip-smoke-raw", "s", int(Type.STRING), m, 0,
                             0, 0, *addr(payload), *addr(offsets))
    arrow_builder.finish_table("chip-smoke-raw")
    t = ct.table_api.get_table("chip-smoke-raw")
    ct.table_api.remove_table("chip-smoke-raw")
    assert all(c.data.is_cuda for c in t._columns), "not on the card"
    i_col, f_col, b_col, s_col = t._columns
    assert np.array_equal(i_col.data.cpu().numpy(), ints)
    assert np.array_equal(f_col.valid_mask().cpu().numpy(), fvalid)
    assert np.array_equal(f_col.data.cpu().numpy()[fvalid], floats[fvalid])
    assert np.array_equal(b_col.valid_mask().cpu().numpy(), bvalid)
    assert np.array_equal(b_col.data.cpu().numpy(), bools)
    vb = s_col.varbytes
    lens = vb.lengths.cpu().numpy()
    starts = vb.eff_starts().cpu().numpy()
    raw = vb.words.cpu().numpy().view(np.uint8)
    got = [raw[4 * s: 4 * s + ln].tobytes().decode()
           for s, ln in zip(starts, lens)]
    assert got == words, "string column"
    # DataLoader over 4 CSV partitions
    with tempfile.TemporaryDirectory() as d:
        names = [f"part_{r}.csv" for r in range(4)]
        for r, f in enumerate(names):
            benchutils.generate_keyed_csv(1000, 64, os.path.join(d, f),
                                          seed=r)
        lctx = ct.CylonContext.Init()
        dl = DataLoader(lctx, d, names).load()
        for r, f in enumerate(names):
            tab = dl.table(r)
            assert tab._columns[0].data.is_cuda
            ref = np.loadtxt(os.path.join(d, f), delimiter=",",
                             skiprows=1)
            blk = dl.to_numpy_blocks()[r]
            assert blk.shape == (1000, 2) and np.array_equal(blk, ref), f
        parts = dl.partitions(4)
        assert sorted(np.concatenate([p.index for p in parts]).tolist()) \
            == list(range(1000))
    # benchmark_with_repetitions against the same wall by hand
    left, right, _h = make_tables(ct, dctx, n, seed)

    def join():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    reps = 5
    real_sync = torch.cuda.synchronize
    seen = []

    def counted(device=None):
        seen.append(device)
        return real_sync(device)

    join()
    sync()
    timed = benchutils.benchmark_with_repetitions(reps, "ms")(join)
    by_hand, by_bench = [], []
    for rnd in range(3):
        for which in (("hand", "bench") if rnd % 2 == 0
                      else ("bench", "hand")):
            if which == "bench":
                torch.cuda.synchronize = counted
                try:
                    ms, out = timed()
                finally:
                    torch.cuda.synchronize = real_sync
                by_bench.append(ms)
            else:
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = join()
                    sync()
                by_hand.append((time.perf_counter() - t0) * 1e3 / reps)
            del out
    assert len(seen) == 3 * reps, seen
    hand, bench = statistics.median(by_hand), statistics.median(by_bench)
    assert abs(bench - hand) <= 0.1 * hand, (by_bench, by_hand)
    log(f"phase 24e edges: arrow_builder table of {m} rows (int32, float64 "
        f"with nulls, bool with a validity bitmap, string) on the card == "
        f"its buffers; DataLoader over 4 CSV partitions == the files; "
        f"benchmark_with_repetitions of phase 2's join {by_bench} ms "
        f"({len(seen)} synchronizes seen) against {by_hand} ms by hand")
    return {"bench_ms": by_bench, "hand_ms": by_hand}


# phase 25: the analysis suite on the card, and the distributed ops'
# telemetry

# phase 2's join under collect_phases on the CPU, in both packages (the
# reference's labels, #seq stripped, and its cylon_host_syncs_total
# deltas; pinned by tests/test_torch_port_telemetry_parity.py)
REFERENCE_JOIN_TELEMETRY = {
    "labels": {"distributed_join.shuffle": 1, "shuffle.count": 1,
               "shuffle.exchange_pair": 1, "distributed_join.plan": 1,
               "distributed_join.materialize": 1},
    "host_syncs": {"shuffle.count_pair": 1, "join.plan": 1}}
ANALYSIS_FAMILIES = 10
ANALYSIS_TIMEOUT_S = 300


def host_sync_counts(tel) -> dict:
    """``cylon_host_syncs_total`` by site."""
    pre = 'cylon_host_syncs_total{site="'
    return {k[len(pre):-2]: v for k, v in tel.metrics_snapshot().items()
            if k.startswith(pre)}


def join_telemetry(ct, ctx, n: int, seed: int) -> dict:
    """Phase 2's join once under collect_phases: its labels (#seq
    stripped) and host-sync deltas."""
    import re

    left, right, _h = make_tables(ct, ctx, n, seed)
    sync()
    before = host_sync_counts(ct.telemetry)
    with ct.telemetry.collect_phases() as cp:
        out = left.distributed_join(right, "inner", on=["k"],
                                    force_exchange=True)
        sync()
    after = host_sync_counts(ct.telemetry)
    labels = {}
    for lab in cp.labels:
        key = re.sub(r"#\d+$", "", lab)
        labels[key] = labels.get(key, 0) + 1
    return {"labels": labels, "rows": out.row_count,
            "host_syncs": {k: v - before.get(k, 0) for k, v in after.items()
                           if v != before.get(k, 0)}}


def analysis_cli_phase() -> dict:
    """25a: ``python3 -m cylon_tpu_torch.analysis --format json`` in a
    subprocess on this machine (no jax here): exit 0, ten families."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "cylon_tpu_torch.analysis",
                        "--format", "json"], cwd=root, capture_output=True,
                       text=True, timeout=ANALYSIS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    assert r.returncode == 0, (r.returncode, r.stdout[-4000:],
                               r.stderr[-4000:])
    doc = json.loads(r.stdout)
    assert doc["ok"] and not doc["findings"], doc
    assert len(doc["checkers"]) == ANALYSIS_FAMILIES, doc["checkers"]
    log(f"phase 25a analysis suite (subprocess, CPU catalog): exit 0, "
        f"{len(doc['checkers'])} families, {doc['suppressed']} "
        f"suppressed, {wall:.2f} s")
    for note in doc["notes"]:
        log(f"  note: {note}")
    return {"seconds": wall, "checkers": doc["checkers"],
            "suppressed": doc["suppressed"], "notes": doc["notes"]}


def analysis_card_phase(K) -> dict:
    """25b: the collectives catalog on CUDA tensors at world 4 under the
    dispatch mode, counters 0 -> read: no finding, K1-K7 launched."""
    from cylon_tpu_torch import analysis as A

    root = os.path.dirname(os.path.abspath(A.__file__))
    ctx = A.AnalysisContext(os.path.dirname(root), {"device": "cuda"})
    K.reset_launches()
    t0 = time.perf_counter()
    res = A.run_checkers(ctx, ["collectives"])
    sync()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert res.ok, res.format_text()
    missing = [k for k in K.KERNELS if launches[k] == 0]
    assert not missing, f"catalog launched no {missing}: {launches}"
    log(f"phase 25b collectives catalog on the card: no finding, "
        f"{res.suppressed} suppressed, launches {launches}, {wall:.2f} s")
    return {"seconds": wall, "launches": launches, "notes": res.notes}


def wrappers_sync_free(K, calls) -> dict:
    """25c: each kernel wrapper of ``calls`` once at its recorded shapes
    (phase 8's; K7's from phase 11) under
    ``torch.cuda.set_sync_debug_mode("error")``: a wrapper that syncs
    raises (the runtime side of hostsync/in-launch)."""
    names = [k for k in K.KERNELS if k in calls]
    sync()
    before = dict(K.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for name in names:
            a, kw = calls[name]
            getattr(K, name)(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    launched = {k: K.LAUNCHES[k] - before[k] for k in names}
    assert all(v >= 1 for v in launched.values()), launched
    return launched


def load_parent_package(tree: str):
    """The package of another checkout (``tree`` holds
    ``cylon_tpu_torch/``) under the name ``cylon_tpu_torch_parent``, its
    kernel libraries copied from this tree's build when the sources are
    the same (their names are the hash of the sources). Loaded once a
    process (phases 25d and 28c share it)."""
    import importlib.util
    import shutil

    from cylon_tpu_torch.ops import kernels as K

    if "cylon_tpu_torch_parent" in sys.modules:
        return sys.modules["cylon_tpu_torch_parent"]
    pkg = os.path.join(os.path.abspath(tree), "cylon_tpu_torch")
    if K.BUILD_DIR.is_dir():
        shutil.copytree(str(K.BUILD_DIR), os.path.join(pkg, "_build"),
                        dirs_exist_ok=True)
    spec = importlib.util.spec_from_file_location(
        "cylon_tpu_torch_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["cylon_tpu_torch_parent"] = mod
    spec.loader.exec_module(mod)
    return mod


def join_telemetry_phase(ct, n: int, seed: int, parent_tree) -> dict:
    """25d: phase 2's join (2 x n rows, world 4): its labels and
    host-sync deltas equal REFERENCE_JOIN_TELEMETRY; with a parent tree,
    the same join of both trees' packages in turns (one process, the
    parent's package under another name)."""
    ctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(WORLD))
    tel = join_telemetry(ct, ctx, n, seed)
    assert tel["labels"] == REFERENCE_JOIN_TELEMETRY["labels"], tel
    assert tel["host_syncs"] == REFERENCE_JOIN_TELEMETRY["host_syncs"], tel
    log(f"phase 25d join (2 x {n} rows, world {WORLD}): labels "
        f"{tel['labels']} and host syncs {tel['host_syncs']} equal the "
        f"reference's")
    res = {"this": tel}
    if parent_tree is None:
        log("  no --parent-tree: the wall against the parent is not taken")
        return res
    pt = load_parent_package(parent_tree)
    pt.ops.kernels.build()
    pctx = pt.CylonContext.InitDistributed(pt.VirtualWorldConfig(WORLD))
    res["parent"] = join_telemetry(pt, pctx, n, seed)
    assert res["parent"]["rows"] == tel["rows"]
    lt, rt, _h = make_tables(ct, ctx, n, seed)
    lp, rp, _h = make_tables(pt, pctx, n, seed)
    walls = in_turns({
        "parent": lambda: lp.distributed_join(rp, "inner", on=["k"],
                                              force_exchange=True),
        "this": lambda: lt.distributed_join(rt, "inner", on=["k"],
                                            force_exchange=True)},
        rounds=9)
    med = {k: statistics.median(v) for k, v in walls.items()}
    res.update(walls_s=walls, median_s=med,
               delta_ms=(med["this"] - med["parent"]) * 1e3,
               ratio=med["this"] / med["parent"])
    log(f"  parent's host syncs {res['parent']['host_syncs']}, labels "
        f"{res['parent']['labels']}")
    log(f"  walls in turns (s) {walls}; medians parent "
        f"{med['parent']:.6f}, this {med['this']:.6f}: "
        f"{res['delta_ms']:+.3f} ms ({res['ratio']:.4f}x)")
    return res


# ---------------------------------------------------------------------------
# phase 26: the host runtime and its CSV writer, the C binding, the task
# exchange on a process group, the examples
# ---------------------------------------------------------------------------

CBIND_ROWS = 1 << 20         # 26c: rows a side of the C binding's CSVs
MP_TASK_ROWS = 1 << 22       # 26d: rows of the task exchange
MP_TASKS = 64
CSV_PANDAS_ROWS = 1 << 22    # 26b: rows of the pandas route's timing
EXAMPLES = ("join_example", "set_ops_example", "groupby_example",
            "select_project_example", "csv_pipeline_example",
            "plan_pipeline_example", "string_regimes_demo",
            "torch_dataloader_demo", "torch_ddp_demo")
# phase 27: each drill of scripts/torch_port and its arguments
DRILLS = (("smoke_telemetry", ()), ("smoke_service", ()),
          ("smoke_obs", ()), ("smoke_stats", ()),
          ("chaos", ("--seeds", "1")),
          ("fuzz_differential", ("12",)))
DRILL_TIMEOUT_S = 600


def host_runtime_phase(ct, K, D, dctx, n: int, seed: int, expect_rows: int
                       ) -> dict:
    """26a: the host library's build; native.hash_partition of phase 2's
    left keys (world 4) through the library and through numpy, in turns
    (bit-equal); distribute_by_key of the join's left table on the card,
    then the join: the left side's exchange skipped, the rows phase 2's
    numpy count. Returns the join's output for 26b."""
    from cylon_tpu_torch import native
    from cylon_tpu_torch.parallel import shard as SH

    native.reset_calls()
    t0 = time.perf_counter()
    assert native.available(), f"host library: {native.BUILD_ERROR}"
    log(f"phase 26a host library {os.path.basename(native.lib_path())}: "
        f"g++ {native.BUILD_SECONDS:.2f} s this process (0.0: built "
        f"before), first load {time.perf_counter() - t0:.2f} s")
    left, right, (lk, _lv, _rk, _rv) = make_tables(ct, dctx, n, seed)
    routes = {"library": native.hash_partition,
              "numpy": native.np_hash_partition}
    parts, walls = {}, {"library": [], "numpy": []}
    for name in ("library", "numpy", "numpy", "library", "library",
                 "numpy"):
        t0 = time.perf_counter()
        parts[name] = routes[name]([lk], [None], WORLD)
        walls[name].append(time.perf_counter() - t0)
    for a, b in zip(parts["library"], parts["numpy"]):
        assert a.dtype == b.dtype and np.array_equal(a, b), \
            "library and numpy partitions differ"
    med = {k: statistics.median(v) for k, v in walls.items()}
    log(f"  hash_partition of {n} int32 keys, world {WORLD}: targets, "
        f"counts and order bit-equal; walls in turns (s) {walls}; medians "
        f"library {med['library']:.4f}, numpy {med['numpy']:.4f} "
        f"({med['numpy'] / med['library']:.2f}x), {native._nthreads()} "
        f"threads")
    del parts
    sync()
    K.reset_launches()
    before = native.CALLS["hash_partition"]
    t0 = time.perf_counter()
    placed = SH.distribute_by_key(left, dctx, ["k"])
    sync()
    placed_s = time.perf_counter() - t0
    assert native.CALLS["hash_partition"] == before + 1, native.CALLS
    with CallSpy(D, ["_exchange_table", "_exchange_table_pair"]) as spy:
        t0 = time.perf_counter()
        out = placed.distributed_join(right, "inner", on=["k"])
        sync()
        join_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    assert spy.calls == {"_exchange_table": 1, "_exchange_table_pair": 0}, \
        f"the placed side was exchanged: {spy.calls}"
    missing = [k for k in JOIN_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched: {missing}"
    assert out.row_count == expect_rows, (out.row_count, expect_rows)
    log(f"  distribute_by_key ({n} rows, world {WORLD}) {placed_s:.4f} s, "
        f"then the join {join_s:.4f} s: one side exchanged "
        f"({spy.calls}), rows {expect_rows} == numpy count, launches "
        f"{launches}")
    return {"out": out, "hash_partition_s": walls, "median_s": med,
            "distribute_by_key_s": placed_s, "join_s": join_s,
            "launches": launches, "build_s": native.BUILD_SECONDS}


def csv_writer_phase(ct, out) -> dict:
    """26b: write_csv of the join's (k, v, w) columns through the host
    library; read back with numpy: the row count and the per-column sums
    equal (integers exactly, floats within 1e-6 of sum |x|); the pandas
    route's time on the first CSV_PANDAS_ROWS rows where pandas exists.
    The files are deleted."""
    import shutil
    import tempfile

    from cylon_tpu_torch import native

    t = out.project([0, 1, 3]).compact()
    rows = t.row_count
    cols = [c.data for c in t._columns]
    sums = [float(c.to(torch.float64).sum()) for c in cols]
    scale = [float(c.to(torch.float64).abs().sum()) for c in cols]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_csv_")
    try:
        path = os.path.join(tmp, "join.csv")
        before = native.CALLS["write_csv"]
        sync()
        t0 = time.perf_counter()
        t.to_csv(path)
        write_s = time.perf_counter() - t0
        assert native.CALLS["write_csv"] == before + 1, "pandas route taken"
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64)
        read_s = time.perf_counter() - t0
        assert back.shape == (rows, 3), (back.shape, rows)
        got = back.sum(0)
        assert got[0] == sums[0], (got[0], sums[0])
        for j in (1, 2):
            assert abs(got[j] - sums[j]) <= 1e-6 * scale[j] + 1e-30, \
                (j, got[j], sums[j])
        del back
        head = t.slice(0, min(CSV_PANDAS_ROWS, rows))
        t0 = time.perf_counter()
        head.to_csv(os.path.join(tmp, "head.csv"))
        head_s = time.perf_counter() - t0
        try:
            import pandas  # noqa: F401
        except ImportError:
            pandas_s = None
        else:
            t0 = time.perf_counter()
            head.to_pandas().to_csv(os.path.join(tmp, "head_pd.csv"),
                                    index=False)
            pandas_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 26b write_csv of {rows} rows x 3 columns ({size} bytes) "
        f"through the host library: {write_s:.3f} s; numpy read back "
        f"{read_s:.2f} s, rows and column sums equal; first "
        f"{head.row_count} rows: library {head_s:.3f} s, pandas "
        + (f"{pandas_s:.3f} s" if pandas_s is not None
           else "not installed on this machine"))
    return {"rows": rows, "bytes": size, "write_s": write_s,
            "read_s": read_s, "head_rows": head.row_count,
            "head_library_s": head_s, "head_pandas_s": pandas_s}


def cbind_phase(ct, seed: int) -> dict:
    """26c: the C binding on the card over two CSVs of the join's shape
    (CBIND_ROWS rows a side, make_tables' draws): CBIND OK, its row count
    the numpy count, K3 and K4 launched in the child."""
    import shutil
    import tempfile

    from cylon_tpu_torch import cbind

    n = CBIND_ROWS
    t0 = time.perf_counter()
    binary = cbind.build()
    build_s = time.perf_counter() - t0
    hctx = ct.CylonContext.Init("cpu")
    _l, _r, (lk, lv, rk, rv) = make_tables(ct, hctx, n, seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cbind_")
    try:
        paths = [os.path.join(tmp, f) for f in ("l.csv", "r.csv", "o.csv")]
        ct.Table.from_pydict(hctx, {"k": lk, "v": lv}).to_csv(paths[0])
        ct.Table.from_pydict(hctx, {"k": rk, "w": rv}).to_csv(paths[1])
        t0 = time.perf_counter()
        stdout = cbind.execute(*paths, "cuda")
        run_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = int(stdout.split("rows=")[1].split()[0])
    launches = json.loads(stdout.split("LAUNCHES ")[1].splitlines()[0])
    expect = numpy_join_count(lk, rk, n)
    assert rows == expect, (rows, expect)
    missing = [k for k in ("join_plan_stream", "join_expand_stream")
               if launches[k] == 0]
    assert not missing, f"C binding's join launched no {missing}"
    log(f"phase 26c C binding {os.path.basename(binary)} (gcc "
        f"{build_s:.2f} s) on cuda, {n} rows a side: CBIND OK rows {rows} "
        f"== numpy count; child launches {launches}; child run "
        f"{run_s:.2f} s")
    return {"rows": rows, "launches": launches, "build_s": build_s,
            "run_s": run_s}


def mp_task_tables(ct, ctx, n: int, seed: int):
    """26d's inputs: the join's left table at n rows (whole, on every
    process), its task ids and the plan {t: t % W}."""
    from cylon_tpu_torch.plan.tasks import LogicalTaskPlan

    left, _right, _h = make_tables(ct, ctx, n, seed)
    tasks = np.random.default_rng(24).integers(0, MP_TASKS, n)
    plan = LogicalTaskPlan({t: t % WORLD for t in range(MP_TASKS)}, WORLD)
    return left, tasks, plan


def mp_task_child(args) -> int:
    """One process of 26d: task_exchange on its shards, its digests."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K
    from cylon_tpu_torch.plan.tasks import task_exchange

    ctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
        num_processes=MP_PROCS, process_id=args.mp_child, backend="gloo",
        shards_per_process=MP_SHARDS, init_method=f"file://{args.rdv}"))
    left, tasks, plan = mp_task_tables(ct, ctx, args.rows, args.seed)
    sync()
    K.reset_launches()
    t0 = time.perf_counter()
    out = task_exchange(left, tasks, plan, ctx)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    with open(args.child_out, "w") as f:
        json.dump({"rank": args.mp_child, "launches": launches,
                   "rows": out.row_count, "wall_s": wall,
                   "digests": shard_digests(out, ctx.get_rank(),
                                            MP_SHARDS)}, f)
    ctx.finalize()
    return 0


def mp_task_phase(ct, args, dctx) -> dict:
    """26d: task_exchange on two gloo processes of two shards sharing the
    card: each process's shards equal the virtual world's, K1 and K2
    launched in both."""
    from cylon_tpu_torch.plan.tasks import task_exchange

    left, tasks, plan = mp_task_tables(ct, dctx, MP_TASK_ROWS, args.seed)
    expect = shard_digests(task_exchange(left, tasks, plan, dctx), 0, WORLD)
    del left
    torch.cuda.empty_cache()  # the children share the card
    t0 = time.perf_counter()
    children = run_children(["--mp-task", "--rows", str(MP_TASK_ROWS),
                             "--seed", str(args.seed)], "26d")
    for r, c in enumerate(children):
        assert c["launches"]["partition_hist"] > 0 and \
            c["launches"]["partition_scatter"] > 0, (r, c["launches"])
        assert c["rows"] == MP_TASK_ROWS, (r, c["rows"])
        for sid, d in c["digests"].items():
            assert d == expect[sid], \
                f"process {r} shard {sid} differs from the virtual world's"
    assert sorted(s for c in children for s in c["digests"]) == \
        sorted(expect)
    seconds = time.perf_counter() - t0
    log(f"phase 26d task_exchange on {MP_PROCS} gloo processes x "
        f"{MP_SHARDS} shards ({MP_TASK_ROWS} rows, {MP_TASKS} tasks): "
        f"shards equal the virtual world's; launches "
        f"{[c['launches'] for c in children]}; walls (s) "
        f"{[c['wall_s'] for c in children]}; phase {seconds:.2f} s")
    return {"children": children, "seconds": seconds}


def examples_phase(K) -> dict:
    """26e: the nine port examples on the card (torch_ddp_demo as two
    processes, the rest in this one), each with the launch counters 0 ->
    read; their counts checked against numpy where it is cheap; K1-K7
    launched over the examples, K5 and K6 by set_ops_example."""
    import importlib.util

    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "examples", "torch_port")
    torch.cuda.empty_cache()  # the DDP demo's processes share the card
    res = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"port_example_{name}", os.path.join(folder, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sync()
        K.reset_launches()
        t0 = time.perf_counter()
        got = mod.main()
        sync()
        wall = time.perf_counter() - t0
        res[name] = {"result": got, "launches": dict(K.LAUNCHES),
                     "wall_s": wall}
        log(f"phase 26e {name}: OK {got}; launches {res[name]['launches']};"
            f" {wall:.2f} s")
    rng = np.random.default_rng(7)
    ka = rng.integers(0, 50_000, 100_000)
    rng.normal(100.0, 15.0, 100_000)
    kb = rng.integers(0, 50_000, 100_000)
    assert res["join_example"]["result"]["inner"] == \
        numpy_join_count(ka, kb, 50_000)
    rng = np.random.default_rng(3)
    a = np.stack([rng.integers(0, 50, 200), rng.integers(0, 4, 200)], 1)
    b = np.stack([rng.integers(25, 75, 200), rng.integers(0, 4, 200)], 1)
    sa, sb = set(map(tuple, a.tolist())), set(map(tuple, b.tolist()))
    assert res["set_ops_example"]["result"] == {
        "union": len(sa | sb), "intersect": len(sa & sb),
        "subtract": len(sa - sb)}, res["set_ops_example"]
    setop = res["set_ops_example"]["launches"]
    assert setop["setop_stream"] > 0 and setop["stream_compact"] > 0, setop
    assert res["groupby_example"]["result"]["groups"] == 1000
    assert res["plan_pipeline_example"]["result"]["exchange_stages"] == 1
    assert np.isfinite(res["torch_dataloader_demo"]["result"]["losses"]
                       ).all()
    for pid, w in res["torch_ddp_demo"]["result"].items():
        assert len(w["losses"]) == 2 and np.isfinite(w["losses"]).all(), pid
    launched = {k for r in res.values() for k, v in r["launches"].items()
                if v}
    missing = sorted(set(K.KERNELS) - launched)
    assert not missing, f"no example launched {missing}"
    return res


def drills_phase(K) -> dict:
    """27: each drill of scripts/torch_port on ``cuda`` in a fresh
    process; its JSON line read, its launches checked."""
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "torch_port")
    torch.cuda.empty_cache()  # the drills' processes share the card
    res = {}
    for name, extra in DRILLS:
        cmd = [sys.executable, os.path.join(folder, f"{name}.py"), *extra,
               "--device", "cuda"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=DRILL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        assert r.returncode == 0, \
            f"drill {name} exited {r.returncode}:\n{r.stdout[-4000:]}\n" \
            f"{r.stderr[-4000:]}"
        doc = json.loads([l for l in r.stdout.splitlines()
                          if l.strip()][-1])
        assert doc["device"] == "cuda", (name, doc)
        res[name] = dict(doc, process_wall_s=wall)
        log(f"phase 27 {name}: OK, checks {doc['checks']}; drill wall "
            f"{doc['wall_s']} s, process wall {wall:.2f} s; launches "
            f"{doc['launches']}")
    svc = res["smoke_service"]
    assert svc["first_query_builds"] >= 1 and \
        svc["builds_after_first_service_query"] == 0, svc
    chaos = res["chaos"]
    ran = chaos["seeds"]["0"]   # JSON keys are strings
    assert len(ran) == 10 and not any("skipped" in v for v in ran.values()), \
        ran
    assert ran["compile"]["retries"] >= 1, ran["compile"]
    missing = [k for k in JOIN_KERNELS if chaos["launches"][k] == 0]
    assert not missing, f"chaos launched no {missing}"
    fuzz = res["fuzz_differential"]
    assert fuzz["failed_seeds"] == [], fuzz
    missing = [k for k in K.KERNELS if fuzz["launches"][k] == 0]
    assert not missing, f"the fuzzer launched no {missing}"
    return res


# ---------------------------------------------------------------------------
# phase 28: bit-reproducible float group sums, the measuring tools
# ---------------------------------------------------------------------------

SUMS_ROWS = 1 << 20          # 28a: rows of the groupby, 2 x half of them
SUMS_GROUPS = 1 << 12        # for the join -> groupby; keys in [0, 4096)
SKEW_GROUPS = (1, 4, 64)     # 28a, 28c: keys of the low-cardinality groupby
SKEW_ROWS = 1 << 22          # 28a: its rows held against the CPU port
SKEW_TIMED_ROWS = 1 << 24    # 28a, 28c: its rows timed on the card
SKEW_K7_GROUPS = (1, 4, 64)  # 28a: K7 checked and timed at these
SKEW_PROFILE_GROUPS = (1, 64)  # 28a, 28c: the groupby profiled at these
AB_ROUNDS = 9                # 28c: rounds in turns with the parent
# 28b: each tool of scripts/torch_port, its arguments, the kernels it must
# launch
TOOL_RUNS = (("scaling_sweep", ("21",)), ("compare_competitors", ("20",)),
             ("profile_shuffle", ("22",)),
             ("profile_dist_join", ("22", "--bcast-rows-log2", "20")),
             ("profile_stream", ("22",)), ("profile_join", ("22",)))
TOOL_KERNELS = {
    "scaling_sweep": JOIN_KERNELS, "profile_dist_join": JOIN_KERNELS,
    "profile_shuffle": ("partition_hist", "partition_scatter"),
    "compare_competitors": ("join_plan_stream", "join_expand_stream",
                            "segment_sum"),
    "profile_stream": ("join_plan_stream", "join_expand_stream"),
    "profile_join": ("join_plan_stream", "join_expand_stream")}
TOOL_TIMEOUT_S = 300


def skew_arrays(n: int, groups: int):
    """A low-cardinality group-by's table (28a, 28c): keys in [0, groups),
    float32 values."""
    rng = np.random.default_rng(28 + groups)
    g = rng.integers(0, groups, n).astype(np.int32)
    x = rng.normal(size=n).astype(np.float32)
    return g, x


def max_sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])


def skew_k7_check(K, fn, groups: int, ns_add: dict,
                  clock_mhz: float) -> dict:
    """28a: one groupby (fn) at world 1 with the counters 0 -> read (K7
    launched exactly once for its SUM and MEAN), then K7 on the recorded
    call against its plain version (check_k7: ms, kernel ms, the byte
    bound, segment_reduce's ms). At one group, each column alone is
    timed too: its kernel ms over the group's rows is the ns a dependent
    add of its accumulator type (``ns_add``). The chain bound: the
    longest group's rows times the slowest column's ns an add, beside 4
    cycles an add at the card's highest SM clock."""
    sync()
    K.reset_launches()
    with Recorder(K) as rec:
        out = fn()
    sync()
    launches = dict(K.LAUNCHES)
    call = rec.calls["segment_sum"]
    del rec, out
    assert launches["segment_sum"] == 1, launches
    r = check_k7(K, call, reps=3, warm=1, others=False)
    assert r["exact"], f"K7 disagrees with its plain version: {r}"
    r["bound_ms"] = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
    r["launches"] = launches
    xs, gid, emit, s, accs = k7_args(K, call)
    if groups == 1:
        for x, a in zip(xs, accs):
            ms = own_kernel_ms(K, lambda x=x, a=a: K.segment_sum(
                [x], gid, emit, s, [a]), reps=3)
            ns_add[str(a)] = ms * 1e6 / r["longest"]
    r["ns_add"] = dict(ns_add)
    r["chain_bound_ms"] = r["longest"] * max(ns_add[str(a)]
                                             for a in accs) / 1e6
    r["four_cycles_ms"] = r["longest"] * 4 / (clock_mhz * 1e3)
    log(f"phase 28a K7, {groups} groups ({r['shape']}): launches "
        f"{launches['segment_sum']} in the groupby; ms {r['ms']:.4f} "
        f"kernel_ms {r['kernel_ms']:.4f} plain {r['plain_ms']:.4f} (on "
        f"the host) bound {r['bound_ms']:.4f} (bytes), chain bound "
        f"{r['chain_bound_ms']:.4f} ({r['longest']} rows x ns an add "
        f"{ns_add}; 4 cycles at {clock_mhz:.0f} MHz: "
        f"{r['four_cycles_ms']:.4f}); library (segment_reduce) "
        f"{r['library_ms']:.4f}")
    return r


def skew_profiles(pkg, ctx) -> dict:
    """28a: the low-cardinality groupby (SUM and MEAN of SKEW_TIMED_ROWS
    float32 rows in 1 and 64 groups, world 1) under torch.profiler after
    one warm-up: wall, device busy and idle share, the top device-time
    entries (profile_once). ``pkg`` is this tree's package or the parent
    tree's (28c), ``ctx`` its world-1 context."""
    out = {}
    for groups in SKEW_PROFILE_GROUPS:
        g, x = skew_arrays(SKEW_TIMED_ROWS, groups)
        t = pkg.Table.from_pydict(ctx, {"g": g, "x": x})

        def fn():
            return t.groupby(0, [1, 1], ["sum", "mean"])

        fn()
        prof = profile_once(fn)
        out[groups] = prof
        log(f"phase 28a profile ({pkg.__name__}, {groups} groups, world 1): "
            f"wall {prof['wall_ms']:.3f} ms, device busy "
            f"{prof['busy_ms']:.3f} ms (idle share "
            f"{prof['idle_share']:.4f}); top device time:")
        for name, ms, calls in prof["top"]:
            log(f"    {ms:9.3f} ms  x{calls:<3d} {name}")
        del t
    return out


def sums_phase(ct, K, lctx, dctx) -> dict:
    """28a: the world-1 and world-4 groupby (SUMS_ROWS rows, SUMS_GROUPS
    keys, float32 values across six orders of magnitude: SUM and MEAN),
    the join -> groupby at world 4 (2 x SUMS_ROWS / 2 rows, phase 10's
    generator) and the low-cardinality groupby at world 1 and 4
    (SKEW_ROWS rows, SKEW_GROUPS keys: runs long enough for K7's block
    route), each twice on the card and once with the CPU port (the route
    switches on, so the CPU runs the plain versions of the kernels
    through the same call sites and the join's output has the card's row
    order): every column bit-equal, run to run and card to CPU, K7
    launched on the card. Then the low-cardinality groupby at
    SKEW_TIMED_ROWS rows on the card alone: steady walls at world 1 and
    4, K7's one call a world-1 groupby (SKEW_K7_GROUPS) against its plain
    version with its bounds (skew_k7_check), and the world-1 groupby
    under torch.profiler (skew_profiles)."""
    n = SUMS_ROWS
    rng = np.random.default_rng(28)
    g = rng.integers(0, SUMS_GROUPS, n).astype(np.int32)
    x = (rng.normal(size=n) * rng.choice(np.array([1e-3, 1.0, 1e3]), n)
         ).astype(np.float32)
    lk, lv, lz, rk, rw = pipeline_arrays(n // 2)
    cctx = {1: ct.CylonContext.Init(device="cpu"),
            WORLD: ct.CylonContext.InitDistributed(
                ct.VirtualWorldConfig(WORLD), device="cpu")}
    D = ct.parallel.dist_ops

    def groupby_of(g, x):
        def groupby(ctx):
            t = ct.Table.from_pydict(ctx, {"g": g, "x": x})
            return t.groupby(0, [1, 1], ["sum", "mean"])
        return groupby

    def pipeline(ctx):
        left = ct.Table.from_pydict(ctx, {"k": lk, "v": lv, "z": lz})
        right = ct.Table.from_pydict(ctx, {"k": rk, "w": rw})
        j = D.distributed_join(left, right, ct.JoinConfig(
            ct.JoinType.INNER, [0], [0]))
        return D.distributed_groupby(j, [0], [4, 4], [
            ct.AggregationOp.SUM, ct.AggregationOp.MEAN])

    cases = [("groupby_w1", groupby_of(g, x), 1),
             ("groupby_w4", groupby_of(g, x), WORLD),
             ("join_groupby_w4", pipeline, WORLD)]
    for groups in SKEW_GROUPS:
        fn = groupby_of(*skew_arrays(SKEW_ROWS, groups))
        cases += [(f"skew{groups}_w1", fn, 1), (f"skew{groups}_w4", fn, WORLD)]
    res = {}
    for name, fn, world in cases:
        card_ctx = lctx if world == 1 else dctx
        sync()
        K.reset_launches()
        first = fn(card_ctx)
        sync()
        launches = dict(K.LAUNCHES)
        assert launches["segment_sum"] > 0, (name, launches)
        second = fn(card_ctx)
        assert_bits_equal(first, second, f"28a {name}: card run to run")
        t0 = time.perf_counter()
        cpu = run_route(True, lambda: fn(cctx[world]))
        cpu_s = time.perf_counter() - t0
        assert_bits_equal(first, cpu, f"28a {name}: card vs CPU")
        res[name] = {"groups": first.row_count, "launches": launches,
                     "cpu_s": cpu_s}
        log(f"phase 28a {name}: {first.row_count} groups, SUM and MEAN "
            f"bit-equal in two runs on the card and to the CPU port "
            f"({cpu_s:.2f} s there); launches {launches}")
        del first, second, cpu
    skew = {}
    clock_mhz = max_sm_clock_mhz()
    ns_add = {}   # accumulator dtype -> ns a dependent add (one group)
    for groups in SKEW_GROUPS:
        g, x = skew_arrays(SKEW_TIMED_ROWS, groups)
        for ctx, world in ((lctx, 1), (dctx, WORLD)):
            t = ct.Table.from_pydict(ctx, {"g": g, "x": x})

            def fn():
                return t.groupby(0, [1, 1], ["sum", "mean"])

            row = {}
            if world == 1 and groups in SKEW_K7_GROUPS:
                row["k7_check"] = skew_k7_check(K, fn, groups, ns_add,
                                                clock_mhz)
            walls = steady(fn)
            row.update(walls_s=walls, median_s=statistics.median(walls))
            skew[f"skew{groups}_w{world}"] = row
            log(f"phase 28a groupby SUM, MEAN of {SKEW_TIMED_ROWS} rows, "
                f"{groups} groups, world {world}: steady walls (s) {walls}; "
                f"median {row['median_s']:.6f}")
            del t
    res["skew_timed"] = skew
    res["profile"] = skew_profiles(ct, lctx)
    return res


# 28c: the cases timed against the parent tree, each (name, builder): the
# builder takes a package and its world-1 and world-4 contexts and returns
# a function that runs the case once
def ab_cases(args) -> list:
    def p10(pkg, lctx, dctx):
        lk, lv, lz, rk, rw = pipeline_arrays(args.pipeline_rows)
        left = pkg.Table.from_pydict(dctx, {"k": lk, "v": lv, "z": lz})
        right = pkg.Table.from_pydict(dctx, {"k": rk, "w": rw})
        D = pkg.parallel.dist_ops

        def run():
            j = D.distributed_join(left, right, pkg.JoinConfig(
                pkg.JoinType.INNER, [0], [0]))
            return D.distributed_groupby(j, [0], [4],
                                         [pkg.AggregationOp.SUM])
        return run

    def p11(world):
        def build(pkg, lctx, dctx):
            g, x, y = groupby_arrays(args.groupby_rows)
            t = pkg.Table.from_pydict(lctx if world == 1 else dctx,
                                      {"g": g, "x": x, "y": y})
            return lambda: t.groupby(0, [1, 2, 1], ["sum", "count", "mean"])
        return build

    def p12(world):
        def build(pkg, lctx, dctx):
            k, v = sort_arrays(args.groupby_rows)
            if world == 1:
                t = pkg.Table.from_pydict(lctx, {"k": k, "v": v})
                return lambda: t.sort("k")
            t = pkg.Table.from_pydict(dctx, {"k": k, "v": v})
            return lambda: pkg.parallel.dist_ops.distributed_sort(
                t, "k", force_exchange=True)
        return build

    def p24a(pkg, lctx, dctx):
        lk, lv, lz, rk, rw = pipeline_arrays(args.service_rows, 11)
        left = pkg.Table.from_pydict(dctx, {"k": lk, "v": lv, "z": lz})
        right = pkg.Table.from_pydict(dctx, {"k": rk, "w": rw})
        return lambda: service_query(pkg, left, right).execute()

    def skew(groups, world):
        def build(pkg, lctx, dctx):
            g, x = skew_arrays(SKEW_TIMED_ROWS, groups)
            t = pkg.Table.from_pydict(lctx if world == 1 else dctx,
                                      {"g": g, "x": x})
            return lambda: t.groupby(0, [1, 1], ["sum", "mean"])
        return build

    cases = [("p10", p10), ("p11_w1", p11(1)), (f"p11_w{WORLD}", p11(WORLD)),
             ("p12_w1", p12(1)), (f"p12_w{WORLD}", p12(WORLD)),
             ("p24a", p24a)]
    for groups in SKEW_GROUPS:
        cases += [(f"skew{groups}_w1", skew(groups, 1)),
                  (f"skew{groups}_w{WORLD}", skew(groups, WORLD))]
    return cases


def sums_cost_phase(ct, args) -> dict:
    """28c, with ``--parent-tree``: what the row-order float sums cost
    against the parent tree, in turns in this process (the parent's
    package loaded beside this one, load_parent_package). The cases:
    ``p10`` phase 10's join -> groupby; ``p11_w1``/``p11_w4`` phase 11's
    groupby; ``p12_w1``/``p12_w4`` phase 12's sorts, which sum nothing (a
    control); ``p24a`` phase 24a's query executed directly; and
    ``skew{G}_w{1,4}`` the SUM and MEAN of SKEW_TIMED_ROWS rows in G
    groups (skew_arrays), each at phase sizes and with the phases'
    generators. Each case: both trees' outputs have the same row count;
    one warm-up a tree, then AB_ROUNDS rounds in turns (in_turns), each
    wall ending in a synchronize; the medians, their difference and
    ratio."""
    pt = load_parent_package(args.parent_tree)
    pt.ops.kernels.build()
    ctxs = {pkg: (pkg.CylonContext.Init(),
                  pkg.CylonContext.InitDistributed(
                      pkg.VirtualWorldConfig(WORLD)))
            for pkg in (pt, ct)}
    res = {}
    for name, build in ab_cases(args):
        fns = {"parent": build(pt, *ctxs[pt]), "this": build(ct, *ctxs[ct])}
        rows = {tree: fn().row_count for tree, fn in fns.items()}
        assert rows["parent"] == rows["this"], (name, rows)
        walls = in_turns(fns, rounds=AB_ROUNDS)
        med = {t: statistics.median(w) for t, w in walls.items()}
        res[name] = {"rows_out": rows["this"], "walls_s": walls,
                     "median_s": med,
                     "delta_ms": (med["this"] - med["parent"]) * 1e3,
                     "ratio": med["this"] / med["parent"]}
        log(f"phase 28c {name}: {rows['this']} rows out; medians (ms) "
            f"parent {med['parent'] * 1e3:.3f}, this "
            f"{med['this'] * 1e3:.3f}: {res[name]['delta_ms']:+.3f} ms "
            f"({res[name]['ratio']:.4f}x); walls (s) {walls}")
        del fns
    # 28a's profile of both trees, the parent's first
    res["profile"] = {tree: skew_profiles(pkg, ctxs[pkg][0])
                      for tree, pkg in (("parent", pt), ("this", ct))}
    return res


def tool_expectations() -> dict:
    """numpy's row counts for the tools' runs of 28b (their generators,
    at TOOL_RUNS' sizes)."""
    out = {}
    n = 1 << 21
    sweep = {}
    for mode, rows in (("strong", lambda w: n),
                       ("weak", lambda w: (n // 8) * w)):
        for w in (1, 2, 4, 8):
            m = rows(w)
            rng = np.random.default_rng(w)
            lk = rng.integers(0, m, m)
            rng.normal(size=m)
            sweep[(mode, w)] = numpy_join_count(lk, rng.integers(0, m, m), m)
    out["scaling_sweep"] = sweep
    m = 1 << 20
    rng = np.random.default_rng(0)
    lk = rng.integers(0, m, m).astype(np.int32)
    rng.normal(size=m)
    rk = rng.integers(0, m, m).astype(np.int32)
    rng.normal(size=m)
    g = rng.integers(0, 1 << 20, m)
    out["compare_competitors"] = {
        "join_rows": numpy_join_count(lk, rk, m),
        "groups": int(np.unique(g).size)}
    m = 1 << 22
    rng = np.random.default_rng(0)
    lk = rng.integers(0, m, m).astype(np.int32)
    rng.normal(size=m)
    rk = rng.integers(0, m, m).astype(np.int32)
    out["join_22"] = numpy_join_count(lk, rk, m)
    b = 1 << 20
    rng = np.random.default_rng(21)
    nb = max(b // 1000, 64)
    keys = max(nb // 2, 1)
    bk = rng.integers(0, keys, b)
    rng.normal(size=b)
    out["broadcast_20"] = numpy_join_count(bk, rng.integers(0, keys, nb),
                                           keys)
    return out


def tools_phase(K) -> dict:
    """28b: each measuring tool of scripts/torch_port on ``cuda`` in its
    own process (TOOL_RUNS): exit 0, a JSON last line on ``cuda``, the
    kernels of TOOL_KERNELS launched, every row count it recorded equal
    to numpy's; its numbers printed."""
    folder = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "scripts", "torch_port")
    torch.cuda.empty_cache()  # the tools' processes share the card
    want = tool_expectations()
    res = {}
    for name, extra in TOOL_RUNS:
        cmd = [sys.executable, os.path.join(folder, f"{name}.py"), *extra,
               "--device", "cuda"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=TOOL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        assert r.returncode == 0, \
            f"tool {name} exited {r.returncode}:\n{r.stdout[-4000:]}\n" \
            f"{r.stderr[-4000:]}"
        doc = json.loads([l for l in r.stdout.splitlines()
                          if l.strip()][-1])
        assert doc["device"] == torch.cuda.get_device_name(0), (name, doc)
        missing = [k for k in TOOL_KERNELS[name] if doc["launches"][k] == 0]
        assert not missing, f"tool {name} launched no {missing}"
        if name == "scaling_sweep":
            for mode in ("strong", "weak"):
                for pt in doc["modes"][mode]["worlds"]:
                    assert pt["dist_join_rows_out"] == \
                        want[name][(mode, pt["world"])], (mode, pt)
        elif name == "compare_competitors":
            for e, got in doc["engines"].items():
                for k, v in want[name].items():
                    assert got.get(k, v) == v, (e, k, got.get(k), v)
            assert "join_rows" in doc["engines"]["cylon_tpu_torch"]
        elif name == "profile_shuffle":
            assert doc["rows_out"] == doc["n_rows"] == 1 << 22, doc
        elif name == "profile_dist_join":
            assert doc["rows_out"] == want["join_22"], doc
            assert doc["broadcast_rows_out"] == want["broadcast_20"], doc
            assert doc["route"] == "stream", doc
        else:
            key = "n_out" if name == "profile_stream" else "n_primary"
            assert doc[key] == want["join_22"], (name, doc)
        res[name] = dict(doc, process_wall_s=wall)
        shown = {k: v for k, v in doc.items()
                 if k not in ("launches", "modes", "engines", "diagnosis")}
        log(f"phase 28b {name} {' '.join(extra)}: OK, process wall "
            f"{wall:.2f} s; launches {doc['launches']}; {shown}")
        if name == "scaling_sweep":
            for mode in ("strong", "weak"):
                for pt in doc["modes"][mode]["worlds"]:
                    log(f"  {mode} {pt}")
            log(f"  diagnosis: {doc['diagnosis']}")
        if name == "compare_competitors":
            for e, got in doc["engines"].items():
                log(f"  {e}: {got}")
    return res


# ---------------------------------------------------------------------------
# phases 29-30: worlds past K1/K2's bucket limit; the paths of a table
# spread over processes
# ---------------------------------------------------------------------------

BIG_WORLD, WIDE_WORLD = 256, 512  # 29: past K1/K2's MAX_BUCKETS - 1 = 255
BIG_WORLD_ROWS = 1 << 16     # 29b: groupby, sort and union at world 256
WIDE_JOIN_ROWS = 1 << 20     # 29c: rows a side of the world-512 join
# 30b/c: rows a side of the redo, the sort's; 2^19, not 2^20: at 2^20
# the script took 569.15 s (phase 30 66.04 s), past the 520 s it aims at
SPREAD_ROWS = 1 << 19
SPREAD_AGGS = ("sum", "count", "min", "max", "mean")
PARTITION_KERNELS = ("partition_hist", "partition_scatter")
PLAN_KERNELS = ("join_plan_stream", "join_expand_stream")


def host_tables(ct, ctx, host):
    """make_tables' tables from its host arrays, in another context."""
    lk, lv, rk, rv = host
    return (ct.Table.from_pydict(ctx, {"k": lk, "v": lv}),
            ct.Table.from_pydict(ctx, {"k": rk, "w": rv}))


def counted(K, fn):
    """fn()'s result, synchronized, with the launch counters set to 0
    just before and read just after, and its wall (s)."""
    sync()
    K.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, dict(K.LAUNCHES), time.perf_counter() - t0


def assert_sort_route(launches, what: str) -> None:
    """Past the bucket limit: no K1/K2 launch, K3/K4 where given."""
    assert all(launches[k] == 0 for k in PARTITION_KERNELS), \
        (what, launches)


def big_world_phase(ct, K, D, SO, dctx, args, host, expect_rows) -> dict:
    """Phase 29: virtual worlds of 256 and 512 shards on the card, which
    take the stable sort's partition (K1/K2 take world + 1 <= 256
    buckets): 29a phase 2's join at world 256 (K1/K2 0 launches, K3/K4
    launched, rows phase 2's numpy count and world 4's rows as a
    bit-exact multiset, walls in turns with phase 2's world-4 kernel
    route); 29b a groupby (K7), a sort and a union at world 256 against
    world 4's; 29c a join at world 512."""
    t0 = time.perf_counter()
    res = {}
    wctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(BIG_WORLD))
    left, right = host_tables(ct, wctx, host)
    l4, r4 = host_tables(ct, dctx, host)

    def join_big():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    def join4():
        return l4.distributed_join(r4, "inner", on=["k"],
                                   force_exchange=True)

    out, launches, first = counted(K, join_big)
    assert_sort_route(launches, "29a")
    assert all(launches[k] > 0 for k in PLAN_KERNELS), launches
    assert out.row_count == expect_rows, (out.row_count, expect_rows)
    out4, launches4, _w = counted(K, join4)
    assert all(launches4[k] > 0 for k in PARTITION_KERNELS), launches4
    assert_same_rows(out, out4, "29a: world 256 vs world 4")
    del out, out4
    walls = in_turns({"world4_kernel_route": join4,
                      f"world{BIG_WORLD}_sort_route": join_big}, rounds=3)
    med = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    log(f"phase 29a join at world {BIG_WORLD} (2 x {args.rows} rows, "
        f"force_exchange): launches {launches}; rows {expect_rows} == "
        f"numpy, equal to world {WORLD}'s as a multiset; first run "
        f"{first:.4f} s; median ms in turns {med}; walls (s) {walls}; "
        f"{card_line()}")
    res["join"] = {"launches": launches, "world4_launches": launches4,
                   "first_wall_s": first, "walls_s": walls,
                   "median_ms": med}
    del left, right, l4, r4

    m = BIG_WORLD_ROWS
    g, x, y = groupby_arrays(m)
    k, v = sort_arrays(m)
    small = {}
    for ctx, world in ((wctx, BIG_WORLD), (dctx, WORLD)):
        t = ct.Table.from_pydict(ctx, {"g": g, "x": x, "y": y})
        st = ct.Table.from_pydict(ctx, {"k": k, "v": v})
        a, b, packed = make_setop_tables(ct, ctx, m, 6)
        small[world] = {
            "groupby": counted(K, lambda: t.groupby(
                0, [1, 2, 2], ["sum", "count", "sum"])),
            "sort": counted(K, lambda: D.distributed_sort(
                st, "k", force_exchange=True)),
            "union": counted(K, lambda: D.distributed_set_op(
                a, b, SO.SetOp.UNION, force_exchange=True))}
    big, w4 = small[BIG_WORLD], small[WORLD]
    for name, (_o, launches, _w) in big.items():
        assert_sort_route(launches, f"29b {name}")
    assert big["groupby"][1]["segment_sum"] > 0, big["groupby"][1]
    # groupby: keys, counts and the integer sums exact, the float sums
    # within tolerance of world 4's (their partials add in other orders)
    gb = [sorted_live(o) for o in (big["groupby"][0], w4["groupby"][0])]
    for i in (0, 2, 3):
        assert np.array_equal(gb[0][i], gb[1][i]), f"29b groupby col {i}"
    cnt = np.bincount(g, minlength=1 << 20)
    scale = np.bincount(g, weights=np.abs(x.astype(np.float64)),
                        minlength=1 << 20)[gb[0][0]]
    worst = check_sums(gb[0][1], gb[1][1].astype(np.float64), scale,
                       "29b groupby sums")
    assert np.array_equal(gb[0][2], cnt[gb[0][0]])
    # sort: the key sequence exact, the rows equal as a multiset
    (sk, _skv), (sv, _svv) = live_columns(big["sort"][0])
    assert np.array_equal(sk, np.sort(k)), "29b sort: key sequence"
    assert_same_rows(big["sort"][0], w4["sort"][0], "29b sort rows")
    expect_union = numpy_setop_rows(*packed)["UNION"].size
    assert big["union"][0].row_count == expect_union
    assert_same_rows(big["union"][0], w4["union"][0], "29b union rows")
    res["small"] = {name: {"launches": big[name][1],
                           "wall_s": big[name][2],
                           "world4_wall_s": w4[name][2]} for name in big}
    log(f"phase 29b world {BIG_WORLD} at {m} rows: groupby (keys, counts "
        f"exact; sums worst error/bound {worst:.3e} against world "
        f"{WORLD}'s), sort (key sequence == np.sort) and union ({expect_union}"
        f" rows == numpy) equal world {WORLD}'s; "
        f"{ {n: r['launches'] for n, r in res['small'].items()} }; walls "
        f"(s) world {BIG_WORLD} / {WORLD}: "
        f"{ {n: (round(r['wall_s'], 4), round(r['world4_wall_s'], 4)) for n, r in res['small'].items()} }")
    del small, big, w4

    wide = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(WIDE_WORLD))
    lw, rw, hw = make_tables(ct, wide, WIDE_JOIN_ROWS, args.seed + 29)
    l4, r4 = host_tables(ct, dctx, hw)
    out, launches, wall = counted(K, lambda: lw.distributed_join(
        rw, "inner", on=["k"], force_exchange=True))
    assert_sort_route(launches, "29c")
    assert all(launches[k] > 0 for k in PLAN_KERNELS), launches
    expect = numpy_join_count(hw[0], hw[2], WIDE_JOIN_ROWS)
    assert out.row_count == expect, (out.row_count, expect)
    assert_same_rows(out, l4.distributed_join(r4, "inner", on=["k"],
                                              force_exchange=True),
                     "29c: world 512 vs world 4")
    res["wide_join"] = {"world": WIDE_WORLD, "rows": WIDE_JOIN_ROWS,
                        "launches": launches, "wall_s": wall}
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 29c join at world {WIDE_WORLD} (2 x {WIDE_JOIN_ROWS} "
        f"rows): launches {launches}; rows {expect} == numpy, equal to "
        f"world {WORLD}'s; first run {wall:.4f} s; phase "
        f"{res['seconds']:.2f} s")
    return res


def sorted_live(table) -> list:
    """A groupby result's live columns (host numpy), rows in key order."""
    cols = live_columns(table)
    order = np.argsort(cols[0][0], kind="stable")
    return [d[order] for d, _v in cols]


def mp_helpers():
    """tests/torch_port_mp_child.py, whose long keys (``LONG_KEY``, 76
    bytes: past EXACT_KEY_WORDS and SORT_PREFIX_WORDS), collision-forcing
    hash (``pair_colliding``) and scalar tokens and bounds phase 30
    shares with the CPU tests' process-group cases."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_port_mp_child

    return torch_port_mp_child


def spread_inputs(n_agg: int, n: int, seed: int) -> dict:
    """Phase 30's host inputs: phase 11's table (g int32, x float32; d is
    x as float64), the redo's two sides and the sort's table."""
    g, x, _y = groupby_arrays(n_agg)
    rng = np.random.default_rng(seed + 30)
    long_key = mp_helpers().LONG_KEY

    def keys(ids, pad=False):
        return np.array([long_key.format(i) + ("x" * (i % 5) if pad else "")
                         for i in ids.tolist()], object)

    lid = rng.integers(0, 2 * n, n)
    rid = rng.integers(0, 2 * n, n)
    sid = rng.integers(0, n // 2, n)
    return {"agg": {"g": g, "x": x, "d": x.astype(np.float64)},
            "left": {"k": keys(lid), "v": rng.integers(
                -1000, 1000, n).astype(np.int64)},
            "right": {"k": keys(rid), "w": rng.normal(size=n).astype(
                np.float32)},
            "sort": {"k": keys(sid, pad=True), "v": rng.integers(
                -5, 5, n).astype(np.int32), "f": rng.normal(size=n).astype(
                    np.float32)},
            "ids": (lid, rid, sid)}


def local_shards(ct, ctx, cols: dict):
    """The context's shards of a table whose rows every process holds, as
    phase 22's processes build theirs: one table a local shard through
    assemble_process_local (the virtual world builds all four)."""
    from cylon_tpu_torch.parallel import shard

    n = len(next(iter(cols.values())))
    cap = shard.shard_capacity(n, ctx.get_world_size())
    return shard.assemble_process_local(
        [ct.Table.from_pydict(ctx, {k: a[s * cap:(s + 1) * cap]
                                    for k, a in cols.items()})
         for s in ctx.local_shard_indices()], ctx)


def spread_cases(ct, K, ctx, inputs: dict) -> dict:
    """Phase 30's three paths in ``ctx`` (a process of the gloo group, or
    the virtual world of 4 shards): 30a the scalar aggregates of phase
    11's table, 30b the exact left join under forced collisions (its
    redo), 30c the host sort of the long keys, descending, then the int32
    payload ascending. Each shard's rows as digests, the scalars as
    bits, launches and walls."""
    from cylon_tpu_torch.data import strings
    from cylon_tpu_torch.parallel import dist_ops as D

    MPC = mp_helpers()
    first, nloc = ctx.get_rank(), ctx.local_shard_count()
    res = {}
    t = local_shards(ct, ctx, inputs["agg"])
    sync()
    t0 = time.perf_counter()
    aggs = {f"{op}({c})": MPC._scalar(getattr(t, op)(c), c)
            for c in inputs["agg"] for op in SPREAD_AGGS}
    sync()
    res["agg"] = {"values": aggs, "wall_s": time.perf_counter() - t0}
    del t
    real, redo = strings._hash_rows, D._exact_dict_redo
    redos = []

    def spy(*a):
        redos.append(1)
        return redo(*a)

    strings._hash_rows, D._exact_dict_redo = MPC.pair_colliding(real), spy
    try:
        left = local_shards(ct, ctx, inputs["left"])
        right = local_shards(ct, ctx, inputs["right"])
        out, launches, wall = counted(K, lambda: left.distributed_join(
            right, "left", on=["k"], exact=True, force_exchange=True))
    finally:
        strings._hash_rows, D._exact_dict_redo = real, redo
    assert redos == [1], f"the exact join redid itself {len(redos)} times"
    res["exact_redo"] = {"rows": out.row_count, "launches": launches,
                         "wall_s": wall, "digests": shard_digests(
                             out, first, nloc)}
    del out, left, right
    st = local_shards(ct, ctx, inputs["sort"])
    out, launches, wall = counted(K, lambda: D.distributed_sort(
        st, ["k", "v"], [False, True]))
    res["long_sort"] = {"rows": out.row_count, "launches": launches,
                        "wall_s": wall, "digests": shard_digests(
                            out, first, nloc, ordered=True)}
    res["sorted_table"] = out
    return res


def mp_spread_child(args) -> int:
    """One process of phase 30: its shards of phase 30's inputs, the
    three paths, what it saw to ``--child-out``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K

    unbuilt = [s for s in K.SOURCES if not K._lib_path(s).exists()]
    assert not unbuilt, f"kernels not built by phase 1: {unbuilt}"
    ctx = ct.CylonContext.InitDistributed(ct.MultiHostConfig(
        num_processes=MP_PROCS, process_id=args.mp_child, backend="gloo",
        shards_per_process=MP_SHARDS, init_method=f"file://{args.rdv}"))
    res = spread_cases(ct, K, ctx, spread_inputs(args.groupby_rows,
                                                 args.rows, args.seed))
    del res["sorted_table"]
    with open(args.child_out, "w") as f:
        json.dump(dict(res, rank=args.mp_child), f)
    ctx.finalize()
    return 0


def spread_phase(ct, K, dctx, args) -> dict:
    """Phase 30: phase 22a's two gloo processes of two shards on this
    card run the paths of a table spread over processes (30a scalar
    aggregates of phase 11's table, 30b the exact join's collision redo,
    30c the long-key host sort); the virtual world of 4 shards runs the
    same inputs on the card; every process's scalars equal each other's,
    integers and MIN/MAX equal the virtual world's, float SUM and MEAN
    within PERF.md section 2's bound of it; every shard of 30b equals
    the virtual world's as a row multiset, of 30c in order."""
    torch.cuda.empty_cache()  # the children share the card
    t0 = time.perf_counter()
    children = run_children(["--mp-spread", "--rows", str(SPREAD_ROWS),
                             "--groupby-rows", str(args.groupby_rows),
                             "--seed", str(args.seed)], "30")
    child_s = time.perf_counter() - t0
    inputs = spread_inputs(args.groupby_rows, SPREAD_ROWS, args.seed)
    exp = spread_cases(ct, K, dctx, inputs)
    # the bounds of the float SUMs and MEANs, from the inputs
    MPC = mp_helpers()
    bounds = MPC.float_bounds(inputs["agg"], {},
                              {c: SPREAD_AGGS for c in inputs["agg"]})
    for r, c in enumerate(children):
        got = c["agg"]["values"]
        MPC.assert_aggs_close(got, children[0]["agg"]["values"], {},
                              f"30a process {r} against process 0")
        MPC.assert_aggs_close(got, exp["agg"]["values"], bounds,
                              f"30a process {r} against the virtual world")
        for case in ("exact_redo", "long_sort"):
            assert c[case]["rows"] == exp[case]["rows"], (r, case)
            for sid, d in c[case]["digests"].items():
                assert d == exp[case]["digests"][sid], \
                    f"30 {case}: process {r} shard {sid} differs"
        assert all(c["exact_redo"]["launches"][k] > 0 for k in JOIN_KERNELS), \
            c["exact_redo"]["launches"]
        assert all(c["long_sort"]["launches"][k] > 0
                   for k in PARTITION_KERNELS), c["long_sort"]["launches"]
    for case in ("exact_redo", "long_sort"):
        assert sorted(s for c in children for s in c[case]["digests"]) == \
            sorted(exp[case]["digests"])
    # the virtual world's own checks: the redo's rows are the true left
    # join's count; the sort's keys descend
    lid, rid, _sid = inputs["ids"]
    cnt = np.bincount(rid, minlength=2 * SPREAD_ROWS)
    assert exp["exact_redo"]["rows"] == int(np.maximum(cnt[lid], 1).sum())
    keys = exp.pop("sorted_table").to_pydict()["k"].tolist()
    assert keys == sorted(inputs["sort"]["k"].tolist(), reverse=True), \
        "30c: the virtual world's keys do not descend"
    seconds = time.perf_counter() - t0
    walls = {case: [c[case]["wall_s"] for c in children]
             for case in ("agg", "exact_redo", "long_sort")}
    log(f"phase 30 {MP_PROCS} gloo processes x {MP_SHARDS} shards on one "
        f"card: 30a {len(SPREAD_AGGS) * 3} scalar aggregates of "
        f"{args.groupby_rows} rows (the same in both processes; integers, "
        f"counts, MIN/MAX == the virtual world's, float SUM/MEAN within "
        f"the bound), 30b the exact left join of 2 x {SPREAD_ROWS} rows of "
        f"76-byte keys under forced collisions ({exp['exact_redo']['rows']}"
        f" rows, redone once), 30c the host sort of {SPREAD_ROWS} rows of "
        f"76-80-byte keys: every shard equal to the virtual world's; "
        f"launches {[{k: c[k]['launches'] for k in ('exact_redo', 'long_sort')} for c in children]}"
        f"; process walls (s) {walls}; virtual world walls (s) "
        f"{ {k: exp[k]['wall_s'] for k in walls} }; children "
        f"{child_s:.2f} s, phase {seconds:.2f} s; {card_line()}")
    return {"children": children, "virtual": exp, "seconds": seconds,
            "walls_s": walls}


class PhaseClock:
    """Seconds since the script started at each phase's start."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.marks = []

    def mark(self, phase: str) -> None:
        self.marks.append((phase, round(time.perf_counter() - self.t0, 2)))

    def spans(self) -> dict:
        """Seconds each phase took (to the next mark)."""
        ends = [t for _p, t in self.marks[1:]]
        return {p: round(e - t, 2) for (p, t), e in zip(self.marks, ends)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 24,
                    help="rows per join table")
    ap.add_argument("--setop-rows", type=int, default=1 << 23,
                    help="rows per set-op table")
    ap.add_argument("--pipeline-rows", type=int, default=1 << 23,
                    help="rows per join -> groupby table")
    ap.add_argument("--groupby-rows", type=int, default=1 << 24,
                    help="rows of the groupby and sort tables")
    ap.add_argument("--string-rows", type=int, default=1 << 22,
                    help="rows per string-join table")
    ap.add_argument("--bcast-rows", type=int, default=1 << 22,
                    help="probe rows of the broadcast join and rows of "
                         "the salted shuffle")
    ap.add_argument("--shuffle-rows", type=int, default=1 << 24,
                    help="rows of the chunked exchange")
    ap.add_argument("--service-rows", type=int, default=1 << 22,
                    help="rows per table of the served join -> groupby")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the result JSON to this path")
    ap.add_argument("--parent-tree", default=None,
                    help="a checkout of the parent commit: phase 25d "
                         "times phase 2's join of both trees in turns, "
                         "phase 28c the group-by cases")
    ap.add_argument("--mp-child", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--rdv", help=argparse.SUPPRESS)
    ap.add_argument("--child-out", help=argparse.SUPPRESS)
    ap.add_argument("--mp-task", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--mp-spread", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.mp_child is not None:
        if args.mp_task:
            return mp_task_child(args)
        return mp_spread_child(args) if args.mp_spread else mp_child(args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import cylon_tpu_torch as ct
    from cylon_tpu_torch.ops import kernels as K
    from cylon_tpu_torch.ops import setops as SO
    from cylon_tpu_torch.parallel import dist_ops as D
    from cylon_tpu_torch.parallel import shuffle as S

    clock = PhaseClock()
    clock.mark("1")
    # the compile profiler records every kernel library this run loads
    profiler = ct.telemetry.profiler
    profiler.enable()
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
    for name in K.SOURCES:
        K.load_library(name)
    compile_profile = profiler.summary()
    assert sorted(compile_profile) == sorted(K.SOURCES), compile_profile
    for name, rec in compile_profile.items():
        assert rec["programs"] == 1 and rec["kernels"], (name, rec)
        assert rec["compile_s"] == round(build_s[name], 6), (name, rec,
                                                              build_s)
    log(f"compile profile: {json.dumps(compile_profile)}")
    for name, rec in compile_profile.items():
        for fn, res in rec["kernels"].items():
            log(f"  {name} {fn}: {res['registers']} registers, "
                f"{res['smem_bytes']} bytes smem, {res['spill_bytes']} "
                f"bytes spilled")

    n = args.rows
    dctx = ct.CylonContext.InitDistributed(ct.VirtualWorldConfig(WORLD))
    left, right, host = make_tables(ct, dctx, n, args.seed)
    lk, lv, rk, rv = host
    expect_rows = numpy_join_count(lk, rk, n)
    sync()

    clock.mark("2")
    # phase 2: the join's main path on the kernel route, counters 0 -> read
    assert all(getattr(m, v) is None for m, v in route_switches())
    K.reset_launches()
    with Recorder(K) as rec, ChunkSpy(S) as chunks2:
        t0 = time.perf_counter()
        out_k = left.distributed_join(right, "inner", on=["k"],
                                      force_exchange=True)
        sync()
        wall_k = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(f"phase 2 main path (world {WORLD}, kernel route): {wall_k:.4f} s, "
        f"launches {launches}")
    join_kernels = ("partition_hist", "partition_scatter",
                    "join_plan_stream", "join_expand_stream")
    missing = [k for k in join_kernels if launches[k] == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    rows_k = out_k.row_count
    assert rows_k == expect_rows, (rows_k, expect_rows)
    log(f"  rows out {rows_k} == numpy count {expect_rows}; "
        f"capacity {out_k.capacity}; first run {wall_k:.4f} s")

    clock.mark("3")
    # phase 3: the plain route, same join
    def dist_join():
        return left.distributed_join(right, "inner", on=["k"],
                                     force_exchange=True)

    chunks2 = chunk_report(2, chunks2, dist_join)
    out_p = run_route(False, dist_join)
    assert_same_rows(out_k, out_p, "world-4 kernel route vs plain route")
    del out_p, out_k
    walls = alternate(dist_join)
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

    clock.mark("4")
    # phase 4: the world-1 local join, kernel route vs plain route
    lctx = ct.CylonContext.Init()
    l1, r1, _h = make_tables(ct, lctx, n, args.seed)

    def local_join():
        return l1.join(r1, "inner", on=["k"])

    loc_k = run_route(None, local_join)
    loc_p = run_route(False, local_join)
    assert loc_k.row_count == expect_rows
    assert_same_rows(loc_k, loc_p, "world-1 kernel route vs plain route")
    del loc_k, loc_p
    local_walls = alternate(local_join)
    log(f"phase 4 local join: outputs equal; steady walls (s) {local_walls}")
    del l1, r1, left, right

    # phases 5-7: the set-op path
    clock.mark("5")
    setop = setop_main_path(ct, K, args.setop_rows)
    clock.mark("6")
    dist_union = dist_union_path(ct, K, D, SO, dctx, args.setop_rows)
    clock.mark("7")
    small_setop_check(ct, lctx, dctx, args.seed + 2)

    clock.mark("8")
    # phase 8: each kernel at the shapes its path gave it
    calls = dict(rec.calls, **setop.pop("calls"))
    results = check_kernels(K, calls)
    del rec
    # launches: K1-K4 from the join's main path, K5/K6 summed over the
    # three set ops' kernel-route runs (each counted from 0)
    for name in ("setop_stream", "stream_compact"):
        launches[name] = sum(v[name] for v in setop["launches"].values())
    table = {k["name"]: k for k in K.kernel_table()}
    kernels = []
    for r in results:
        bound = r["bytes"] / HBM_BYTES_PER_S * 1e3
        row = dict(table[r["name"]], launches=launches[r["name"]],
                   max_abs_err=r["err"], ms=r["ms"],
                   kernel_ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                   bound_ms=bound, bound_by="bytes",
                   library_ms=r["library_ms"])
        kernels.append(row)
        log(f"phase 8 {r['name']} ({r['shape']}): ms {r['ms']:.4f} "
            f"kernel_ms {r['kernel_ms']:.4f} plain "
            f"{r['plain_ms']:.4f} bound {bound:.4f} library "
            f"{r['library_ms']} max_abs_err {r['err']}")
    # K7 joins the line after phase 11, whose groupby gives its shapes
    assert [k["name"] for k in kernels] == list(K.KERNELS[:6])
    bad = [k["name"] for k in kernels if k["max_abs_err"] != 0]
    assert not bad, f"kernels disagree with their plain versions: {bad}"
    # phase 25c runs here, where phase 8's inputs are still held
    sync_free25 = wrappers_sync_free(K, calls)

    del calls
    clock.mark("9")
    # phase 9: a small join against an independent numpy join
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
    log(f"phase 9 small join ({small} rows a side): {len(ref)} rows equal "
        f"the numpy join")

    # phases 10-13: the compact exchange route, groupby and sort
    del sl, sr, so
    clock.mark("10")
    pipe = pipeline_phase(ct, K, D, S, dctx, args.pipeline_rows)
    clock.mark("11")
    groupby = groupby_phase(ct, K, lctx, dctx, args.groupby_rows)
    # K7 at phase 11's world-1 shapes against its plain version, bit for
    # bit; launches from that run (counters 0 -> read)
    k7_call = groupby.pop("calls")
    kernels.append(dict(table["segment_sum"],
                        **k7_phase11(K, groupby, k7_call)))
    sync_free25.update(wrappers_sync_free(K, {"segment_sum": k7_call}))
    del k7_call
    clock.mark("12")
    sort = sort_phase(ct, K, D, lctx, dctx, args.groupby_rows)
    clock.mark("13")
    small_inputs = small_inputs_phase(ct, K, D, S)

    # phases 14-16: string columns; then K3 (hash mode) and K4 at phase
    # 14's shapes against their plain versions
    clock.mark("14")
    string_join = string_join_phase(ct, K, lctx, args.string_rows, 1,
                                    (10, 11))
    clock.mark("15")
    dist_string_join = string_join_phase(ct, K, dctx, args.string_rows,
                                         WORLD, (20, 21))
    clock.mark("16")
    string_small = string_small_phase(ct, K, D, lctx, dctx)
    calls = string_join.pop("calls")
    dist_string_join.pop("calls")
    string_kernels = []
    for r in (check_k3(K, calls["join_plan_stream"][1]),
              check_k4(K, *calls["join_expand_stream"][0])):
        r["bound_ms"] = r.pop("bytes") / HBM_BYTES_PER_S * 1e3
        string_kernels.append(r)
        log(f"phase 14 kernel check {r['name']} ({r['shape']}): ms "
            f"{r['ms']:.4f} kernel_ms {r['kernel_ms']:.4f} plain "
            f"{r['plain_ms']:.4f} bound {r['bound_ms']:.4f} max_abs_err "
            f"{r['err']}")
    bad = [r["name"] for r in string_kernels if r["err"] != 0]
    assert not bad, f"kernels disagree at phase 14's shapes: {bad}"
    del calls

    # phases 17-21: the ring and broadcast joins, the salted shuffle, the
    # chunked exchange
    clock.mark("17")
    ring = ring_phase(ct, K, D, dctx, n, args.seed)
    clock.mark("18")
    bcast = broadcast_phase(ct, K, D, S, dctx, args.bcast_rows)
    clock.mark("19")
    salted = salted_phase(ct, K, D, S, dctx, args.bcast_rows)
    clock.mark("20")
    chunked = chunked_phase(ct, K, S, dctx, args.shuffle_rows)
    clock.mark("21")
    small_variants = small_variants_phase(ct, K, D, S)
    log(f"chunk counts of the padded exchanges: phase 2 "
        f"{chunks2['chunks']}, phase 10 {pipe['chunks']['chunks']}, phase "
        f"15 {dist_string_join['chunks']['chunks']}, phase 20 "
        f"{chunked['chunks']}")

    clock.mark("22")
    # phase 22: the process-group backend on phase 2's join, held against
    # the virtual world's output of it (computed here, so that phases
    # 3-21 run on the same card state as before phase 22 existed)
    t0 = time.perf_counter()
    left_v, right_v, _host = make_tables(ct, dctx, n, args.seed)
    out_v = left_v.distributed_join(right_v, "inner", on=["k"],
                                    force_exchange=True)
    assert out_v.row_count == expect_rows
    digests2 = shard_digests(out_v, 0, WORLD)
    del out_v
    log(f"phase 22 virtual world's shards of phase 2's join: "
        f"{time.perf_counter() - t0:.2f} s")
    multiprocess = mp_phase(args, digests2, expect_rows)
    one_rank_nccl = nccl_phase(ct, K, args, (left_v, right_v), digests2,
                               expect_rows)
    del left_v, right_v

    # phase 23: the planned query path (plan/), in turns with phase 10's
    # eager form, its EXPLAIN ANALYZE, and every node kind at small size
    clock.mark("23a")
    plan23 = plan_pipeline_phase(ct, K, D, dctx, args.pipeline_rows)
    clock.mark("23b")
    report23 = plan_report_phase(ct, args.pipeline_rows, plan23)
    clock.mark("23c")
    nodes23 = plan_nodes_phase(ct, K, D, lctx, dctx)

    # phase 24: the query service, the task exchange, the edges
    clock.mark("24a")
    service24 = service_pipeline_phase(ct, K, dctx, args.service_rows)
    clock.mark("24b")
    obs24 = service_obs_phase(ct, service24)
    clock.mark("24c")
    outcomes24 = service_outcomes_phase(ct, K, lctx, dctx)
    clock.mark("24d")
    tasks24 = task_exchange_phase(ct, K, dctx, n, args.seed)
    clock.mark("24e")
    edges24 = edges_phase(ct, K, dctx, n, args.seed)
    # phases 2, 10, 23a and 24 launched K1-K4 on the main path; 24a's
    # service batches and 24d's task exchange add to the join's counts
    for name in PIPELINE_KERNELS:
        launches_24 = service24["service_launches"][0][name]
        log(f"launches of {name}: join {launches[name]}, one 24a service "
            f"batch {launches_24}, 24d {tasks24['launches'][name]}")

    # phase 25: the analysis suite, its catalog on the card, the
    # wrappers' sync check (run after phase 8) and the join's telemetry
    clock.mark("25a")
    analysis25 = analysis_cli_phase()
    clock.mark("25b")
    card25 = analysis_card_phase(K)
    assert sorted(sync_free25) == sorted(K.KERNELS), sync_free25
    log(f"phase 25c each wrapper at phase 8's shapes (K7 at phase 11's) "
        f"under set_sync_debug_mode('error') (run after phase 8 and 11): "
        f"no sync, launches {sync_free25}")
    clock.mark("25d")
    tel25 = join_telemetry_phase(ct, n, args.seed, args.parent_tree)

    # phase 26: the host runtime and its CSV writer, the C binding, the
    # task exchange on a process group, the examples
    from cylon_tpu_torch import native

    clock.mark("26a")
    host26 = host_runtime_phase(ct, K, D, dctx, n, args.seed, expect_rows)
    clock.mark("26b")
    csv26 = csv_writer_phase(ct, host26.pop("out"))
    calls26 = dict(native.CALLS)
    assert calls26["hash_partition"] > 0 and calls26["write_csv"] > 0, \
        calls26
    log(f"phase 26a-b host library calls {calls26}")
    clock.mark("26c")
    cbind26 = cbind_phase(ct, args.seed)
    clock.mark("26d")
    tasks26 = mp_task_phase(ct, args, dctx)
    clock.mark("26e")
    examples26 = examples_phase(K)

    # phase 27: the drills of scripts/torch_port, each in its own process
    clock.mark("27")
    drills27 = drills_phase(K)
    for row in kernels:
        row["drill_launches"] = {d: r["launches"][row["name"]]
                                 for d, r in drills27.items()}

    # phase 28: float group sums bit-equal run to run and to the CPU
    # port; the measuring tools of scripts/torch_port, each in its own
    # process
    clock.mark("28a")
    sums28 = sums_phase(ct, K, lctx, dctx)
    clock.mark("28b")
    tools28 = tools_phase(K)
    for row in kernels:
        row["tool_launches"] = {t: r["launches"][row["name"]]
                                for t, r in tools28.items()}
    clock.mark("28c")
    cost28 = None
    if args.parent_tree is None:
        log("phase 28c: no --parent-tree: the sums' cost against the "
            "parent is not taken")
    else:
        cost28 = sums_cost_phase(ct, args)

    # phase 29: worlds of 256 and 512 shards (the sort's partition);
    # phase 30: the paths of a table spread over two processes
    clock.mark("29")
    big29 = big_world_phase(ct, K, D, SO, dctx, args, host, expect_rows)
    clock.mark("30")
    spread30 = spread_phase(ct, K, dctx, args)
    for row in kernels:
        name = row["name"]
        row["phase29_launches"] = dict(
            {f"world{BIG_WORLD}_join": big29["join"]["launches"][name],
             f"world{WIDE_WORLD}_join":
                 big29["wide_join"]["launches"][name]},
            **{f"world{BIG_WORLD}_{op}": r["launches"][name]
               for op, r in big29["small"].items()})
        row["phase30_launches"] = {
            case: sum(c[case]["launches"][name]
                      for c in spread30["children"])
            for case in ("exact_redo", "long_sort")}

    clock.mark("end")
    assert [k["name"] for k in kernels] == list(K.KERNELS)
    summary = {"kernels": kernels}
    log(f"seconds a phase: {clock.spans()}; total {clock.marks[-1][1]} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(summary, card=card, rows=n, world=WORLD,
                           dist_join_wall_s=walls, dist_join_rows_s=rate,
                           first_wall_s=wall_k,
                           local_join_wall_s=local_walls, profile=prof,
                           out_rows=rows_k, build_s=build_s, setop=setop,
                           dist_union=dist_union, join_groupby=pipe,
                           groupby=groupby, sort=sort,
                           small_inputs=small_inputs,
                           string_join=string_join,
                           dist_string_join=dist_string_join,
                           string_small=string_small,
                           string_kernels=string_kernels,
                           join_chunks=chunks2, ring_join=ring,
                           broadcast_join=bcast, salted_shuffle=salted,
                           chunked_exchange=chunked,
                           small_variants=small_variants,
                           shard_digests=digests2,
                           multiprocess=multiprocess,
                           one_rank_nccl=one_rank_nccl,
                           plan_pipeline=plan23, plan_report=report23,
                           plan_nodes=nodes23,
                           compile_profile=compile_profile,
                           service_pipeline=service24, service_obs=obs24,
                           service_outcomes=outcomes24,
                           task_exchange=tasks24, edges=edges24,
                           analysis_cli=analysis25, analysis_card=card25,
                           wrappers_sync_free=sync_free25,
                           join_telemetry=tel25,
                           host_runtime=dict(host26, calls=calls26),
                           csv_writer=csv26, cbind=cbind26,
                           task_exchange_mp=tasks26, examples=examples26,
                           drills=drills27, group_sums=sums28,
                           tools=tools28, group_sums_cost=cost28,
                           big_worlds=big29, spread=spread30,
                           phase_seconds=clock.spans()), f, indent=1,
                      default=str)
    log(json.dumps(summary))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
