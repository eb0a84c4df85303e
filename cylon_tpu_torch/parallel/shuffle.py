"""The shuffle: hash-partition + the counted padded all-to-all
(counterpart of the padded route of cylon_tpu.parallel.shuffle).

A two-phase exchange, as in the JAX package:

  phase 1 ("header"): the per-(src, dst) send-count matrix, fetched to
     the host (``count_pair``);
  phase 2 ("body"): each shard partitions its rows stably by target
     (kernels K1 + K2 on the kernel route, a stable sort otherwise), and
     every (src, dst) pair moves ONE ``block``-row slice into the static
     slot ``dst_out[src*block : (src+1)*block]``. The block is the pow2 of
     the largest pair; the output is padded per source, capacity
     ``world * block``, live rows marked by the emit mask.

Rows whose emit mask is False are dropped in transit. When padding would
cost more than PADDED_WASTE_FACTOR over the compact layout (a skewed, a
diagonal or a tiny count matrix), or the block exceeds MAX_BLOCK, the
exchange takes the compact route (the JAX package's ``_exchange_fn``):
``rounds`` rounds each move one ``[W_src, W_dst, block]`` send block a
leaf, and every received row lands at its source's running offset in a
compact output of ``pow2(recv_max)`` rows a shard, live rows a prefix.
A padded exchange whose payload exceeds CYLON_EXCHANGE_CHUNK_BYTES a
shard runs in chunks (`_chunked_body`, the JAX package's overlapped
pipeline): each chunk moves ``cb`` rows a (src, dst) pair, so the live
send stack is ``[W, W, cb]`` instead of ``[W, W, block]``; the landing
is bit-identical to the single-shot route on every live row.
The memory pool's comm budget caps the per-round block
(`_budget_block_cap`).

Telemetry and resilience sit at the JAX package's sites, under its
labels: the count fetches run in ``shuffle.count`` spans, every exchange
in a ``shuffle.exchange`` span (``mode``, ``rows``, ``bytes_moved``, the
skew attributes of `telemetry.skew` reduced from the count matrix the
host already holds, the partition path, the chunk plan) and both padded
sides of a two-table shuffle in one ``shuffle.exchange_pair`` span; the
counters ``cylon_shuffle_bytes_total``, ``cylon_rows_exchanged_total``,
``cylon_collective_launches_total``, ``cylon_partition_path_total{path=}``
and ``cylon_exchange_chunks_total`` move with them. Each exchange body
and count fetch runs under ``resilience.retry.run_retryable`` (sites
``exchange`` and ``exchange.count``), the fault injector's ``exchange``
choke point firing before every attempt; a chunked exchange dispatches
each chunk so (the partition with chunk 0, then one a chunk), so a fault
in the middle of the stream retries that chunk alone. None of it adds a
device sync.

Every per-shard tensor here is this process's ``[V, ...]`` part of the
world (V = W in the virtual world, parallel/comm.py): targets and the
count matrix's columns range over the W global shards, and the
collectives go through the context's backend (``ctx.comm``). The count
matrix is gathered to the global ``[W, W]`` before the host reads it,
so every process picks the same route, block and rounds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..context import CylonContext
from ..dtypes import movable
from ..ops import hash as _hash
from ..ops import kernels as _k
from ..resilience import inject as _inject
from ..resilience import retry as _retry
from ..telemetry import knobs as _knobs
from ..telemetry import metrics as _metrics
from ..telemetry import skew as _skew
from ..telemetry import span as _span
from ..util import pow2 as _pow2
from ..util import pow2_floor as _pow2_floor

# upper bound on the per-pair block (rows per (src, dst) pair)
MAX_BLOCK = 1 << 22

# chunk-count ceiling of the chunked padded exchange: the chunk block is
# floored so that one exchange never runs more chunks than this
MAX_CHUNKS = 64

# padded-mode acceptance: worst-case capacity blowup over the compact
# layout before the compact (blockwise) route takes over
PADDED_WASTE_FACTOR = 2

# None = auto (K1 + K2 on CUDA, the stable sort elsewhere); False forces
# the stable sort; True forces the kernel wrappers, which run their plain
# versions on the CPU. The TPU route's world <= 16 cap does not carry
# over: the Hopper scatter reads its input once whatever the world, so
# every world whose world + 1 buckets fit the kernels (world <= 255)
# takes the kernel route. A larger world takes the stable sort on every
# device, even when this is True, as the JAX package takes its sort past
# its kernel's bucket limit: K1/K2 keep per-thread arrays and one scan
# thread a bucket, sized for MAX_BUCKETS.
PARTITION_KERNEL: Optional[bool] = None


def _target_counts(t: torch.Tensor, world: int) -> torch.Tensor:
    """counts[s, w] = #rows of shard s with target w (ids == world are
    dead and not counted), int32 [W, world]. One bincount over (shard,
    target) bins: a scatter-add into W * (world + 1) counters serialises
    its atomics on the card (6.2 ms for [4, 4,194,304] ids on an H100,
    scripts/profile_port_groupby.py)."""
    w = t.shape[0]
    bins = (torch.arange(w, device=t.device).unsqueeze(-1) * (world + 1)
            + t.to(torch.int64).clamp(0, world)).reshape(-1)
    counts = torch.bincount(bins, minlength=w * (world + 1))
    return counts.view(w, world + 1)[:, :world].to(torch.int32)


def _dead_keyed(targets: torch.Tensor, emit: torch.Tensor,
                world: int) -> torch.Tensor:
    return torch.where(emit, targets.to(torch.int32), world).contiguous()


def _bucket_sort(payload: Dict[str, torch.Tensor], targets, emit,
                 world: int):
    """Stable partition of [W, n] leaves by target, dead rows (emit
    False) keyed ``world`` to the tail. Returns (sorted leaves,
    counts_out int32 [W, world], start int64 [W, world])."""
    t = _dead_keyed(targets, emit, world)
    perm = torch.sort(t, dim=1, stable=True).indices
    out = {k: movable(x).gather(1, perm).view(x.dtype)
           for k, x in payload.items()}
    counts_out = _target_counts(t, world)
    c = counts_out.to(torch.int64)
    return out, counts_out, torch.cumsum(c, 1) - c


def _leg_split(x: torch.Tensor):
    """One [W, n] leaf -> (int32 [W, n] legs, join(legs) -> leaf): the
    partition kernel moves 32-bit words; 8-byte values ride as two
    words, narrower ones widen value-exactly. Round trips are
    bit-exact."""
    dt = x.dtype
    size = x.element_size()
    if size == 4:
        return [x.view(torch.int32)], lambda ls: ls[0].view(dt)
    if size == 8:
        pair = x.view(torch.int32).view(*x.shape, 2)
        return ([pair[..., 0].contiguous(), pair[..., 1].contiguous()],
                lambda ls: torch.stack(ls, -1).view(torch.int64).view(
                    *ls[0].shape).view(dt))
    if dt == torch.bool:
        return [x.to(torch.int32)], lambda ls: ls[0] != 0
    if size == 2:
        return ([x.view(torch.int16).to(torch.int32) & 0xFFFF],
                lambda ls: ls[0].to(torch.int16).view(dt))
    return ([x.view(torch.uint8).to(torch.int32)],
            lambda ls: ls[0].to(torch.uint8).view(dt))


def _kernel_partition(payload, targets, emit, world: int):
    """The kernel twin of `_bucket_sort`: identical contract, via one
    histogram pass (K1), its sum over tiles, and one counting-scatter pass
    (K2) that reads the payload's legs in place."""
    t = _dead_keyed(targets, emit, world)
    splits = {k: _leg_split(x.contiguous()) for k, x in payload.items()}
    hist = _k.partition_hist(t, world + 1)
    counts_out = hist[:, :, :world].sum(1, dtype=torch.int32)
    c = counts_out.to(torch.int64)
    outs = _k.partition_scatter(
        t, [leg for ls, _ in splits.values() for leg in ls], world + 1,
        counts_out)
    out, i = {}, 0
    for k, (ls, join) in splits.items():
        out[k] = join(list(outs[i:i + len(ls)]))
        i += len(ls)
    return out, counts_out, torch.cumsum(c, 1) - c


def use_partition_kernel(world: int, device: torch.device) -> bool:  # cylint: disable=collectives/uncataloged-factory — a route predicate, it issues no collective
    """The partition route of a world >= 2 exchange: K1 + K2 (True) or
    the stable sort (False). A world whose world + 1 buckets exceed the
    kernels' limit takes the sort on every device, whatever
    PARTITION_KERNEL says: the route follows the world size, never a
    failure (``cylon_partition_path_total{path=}`` counts it)."""
    if PARTITION_KERNEL is False or world + 1 > _k.MAX_BUCKETS:
        return False
    return PARTITION_KERNEL is True or device.type == "cuda"


def _padded_body_w1(block: int, payload, targets, emit):
    """One-shard padded body: the all-to-all is the identity; the only
    work is pushing dead rows to the tail (skipped when all rows live)."""
    n = targets.shape[1]
    all_live = bool(emit.all())
    # the port's own fetch: the JAX package decides this in-program
    _metrics.record_host_sync("shuffle.all_live")
    if all_live:
        out = payload
        counts_in = torch.full((1, 1), n, dtype=torch.int32,
                               device=targets.device)
    else:
        out, counts_in, _start = _bucket_sort(payload, targets, emit, 1)

    def pad(x):
        if block <= x.shape[1]:
            return x[:, :block]
        z = torch.zeros(1, block - x.shape[1], dtype=x.dtype,
                        device=x.device)
        return torch.cat([x, z], 1)

    pos = torch.arange(block, device=targets.device)
    return ({k: pad(x) for k, x in out.items()},
            (pos < counts_in[:, :1]), counts_in)


def _pad_block(xs: torch.Tensor, block: int) -> torch.Tensor:
    """``xs`` [W, n] with ``block`` zero rows appended, so every send
    slice of `_send_block` stays in range."""
    pad = torch.zeros(xs.shape[0], block, dtype=xs.dtype, device=xs.device)
    return torch.cat([xs, pad], 1)


def _send_block(xp: torch.Tensor, start: torch.Tensor, o: int, block: int
                ) -> torch.Tensor:
    """[V_src, W_dst, block] send stack of round offset ``o``: ONE
    contiguous slice per target (rows are target-sorted), from row
    ``start + o`` clamped to the unpadded length. ``xp`` is padded by
    ``block`` rows (`_pad_block`); over-read rows belong to other targets
    or to later rounds and are dropped on the receiving side."""
    n = xp.shape[1] - block
    v, world = start.shape
    rows = (torch.clamp(start + o, max=n).unsqueeze(-1)
            + torch.arange(block, device=xp.device)).view(v, -1)
    return movable(xp).gather(1, rows).view(xp.dtype).view(
        v, world, block)


def _partition(cm, payload, targets, emit):
    """The partition prefix of both routes: stable partition by target
    (K1 + K2 on the kernel route, the stable sort otherwise — the same
    layout) and the counts exchange. Returns (sorted leaves, counts_in
    int32 [V_dst, W_src], start int64 [V, W])."""
    world = cm.world
    if use_partition_kernel(world, targets.device):
        sorted_leaves, counts_out, start = _kernel_partition(
            payload, targets, emit, world)
    else:
        sorted_leaves, counts_out, start = _bucket_sort(
            payload, targets, emit, world)
    return sorted_leaves, cm.all_to_all(counts_out), start


def _padded_partition(cm, block: int, payload, targets, emit):
    """`_partition` plus the padded layout's receive-side emit mask."""
    sorted_leaves, counts_in, start = _partition(cm, payload, targets,
                                                 emit)
    cap_out = cm.world * block
    pos = torch.arange(cap_out, device=targets.device)
    new_emit = (pos % block) < counts_in.gather(
        1, (pos // block).expand(counts_in.shape[0], cap_out))
    return sorted_leaves, counts_in, start, new_emit


def _padded_body(cm, block: int, payload, targets, emit):
    """The padded-mode exchange over [V, n] per-shard values (``cm`` the
    context's collective backend). Returns (leaves [V, W*block], new
    emit, counts_in int32 [V, W]): source s's rows land at ``[s*block,
    s*block + counts_in[:, s])``."""
    world = cm.world
    if world == 1:
        return _padded_body_w1(block, payload, targets, emit)
    sorted_leaves, counts_in, start, new_emit = _padded_partition(
        cm, block, payload, targets, emit)
    v = start.shape[0]
    out = {k: cm.all_to_all(_send_block(_pad_block(x, block), start, 0,
                                        block)).view(v, world * block)
           for k, x in sorted_leaves.items()}
    return out, new_emit, counts_in


def _chunk_step(cm, padded, start, recv, o: int, cb: int) -> None:
    """One chunk of `_chunked_body`: the ``[W_src, W_dst, cb]`` stack of
    rows ``start + o`` of every leaf, landed at slots ``o`` onward of each
    source's block (a remainder chunk drops the rows past the block).
    Idempotent: it reads the partitioned leaves and writes its own
    slots."""
    for k, xp in padded.items():
        block = recv[k].shape[2]
        live = min(cb, block - o)
        recv[k][:, :, o:o + live] = movable(cm.all_to_all(
            _send_block(xp, start, o, cb)))[:, :, :live]


def _chunked_body(cm, block: int, cb: int, payload, targets, emit):
    """`_padded_body` in chunks of ``cb`` rows a (src, dst) pair (the JAX
    package's chunked pipeline): no ``[W, W, block]`` send stack is ever
    built, and source s's rows land at the static slots ``s * block + o``
    chunk by chunk. Each chunk is one dispatch under the exchange retry
    policy, as in the JAX package's ``_dispatch_chunked`` (shuffle.py:644):
    the partition with chunk 0, then one a chunk, so a fault in the
    middle of the stream retries that chunk alone. Bit-identical to the
    single-shot exchange on every live row."""
    world = cm.world

    def first():
        sorted_leaves, counts_in, start, new_emit = _padded_partition(
            cm, block, payload, targets, emit)
        v = start.shape[0]
        padded = {k: _pad_block(x, cb) for k, x in sorted_leaves.items()}
        # the chunks tile [0, block): every slot is written once
        recv = {k: torch.empty(v, world, block, dtype=movable(x).dtype,
                               device=x.device)
                for k, x in sorted_leaves.items()}
        _chunk_step(cm, padded, start, recv, 0, cb)
        return padded, start, recv, counts_in, new_emit

    padded, start, recv, counts_in, new_emit = _launch_exchange(first)
    for o in range(cb, block, cb):
        _launch_exchange(lambda o=o: _chunk_step(cm, padded, start, recv,
                                                 o, cb))
    v = start.shape[0]
    out = {k: r.view(padded[k].dtype).view(v, world * block)
           for k, r in recv.items()}
    return out, new_emit, counts_in


def _chunk_plan(block: int, world: int, bytes_per_row: int):
    """(chunk_block, chunks) of a padded exchange with per-pair ``block``
    (the JAX package's rule, shuffle.py:503); chunks == 1 is single-shot.
    The chunk block is pow2-floored from CYLON_EXCHANGE_CHUNK_BYTES over
    ``bytes_per_row * world`` and floored again so that an exchange runs
    at most MAX_CHUNKS chunks."""
    if not _knobs.get("CYLON_EXCHANGE_OVERLAP"):
        return block, 1
    target = int(_knobs.get("CYLON_EXCHANGE_CHUNK_BYTES"))
    per_slot = max(int(bytes_per_row), 1) * max(world, 1)
    cb = _pow2_floor(max(target // per_slot, 1))
    cb = max(cb, _pow2_floor(max(block // MAX_CHUNKS, 1)))
    if cb >= block:
        return block, 1
    return cb, -(-block // cb)


def _compact_body(cm, block: int, rounds: int, cap_out: int,
                  payload, targets, emit):
    """The compact-mode exchange (the JAX package's ``_exchange_fn``):
    ``rounds`` rounds, round k moving one block a (src, dst) pair from
    offset ``o = k * block`` of each target's run. Shard d writes source
    s's row ``o + i`` at ``S[d, s] + o + i``, ``S`` the exclusive cumsum
    of its counts_in; rows at or past ``counts_in[d, s]`` go to spare slot
    ``cap_out + i``, cut off at the end (one spare slot for all of them
    serialises the stores: 50 ms for the diagonal matrix of the join ->
    groupby cell's partials on an H100, scripts/profile_port_groupby.py).
    Returns (leaves [V, cap_out], new emit,
    counts_in int32 [V, W]): live rows form a prefix of
    ``counts_in.sum()`` rows a shard, sources in order."""
    sorted_leaves, counts_in, start = _partition(cm, payload, targets,
                                                 emit)
    world = cm.world
    v = start.shape[0]
    dev = targets.device
    ci = counts_in.to(torch.int64)
    S = torch.cumsum(ci, 1) - ci
    biota = torch.arange(block, device=dev)
    padded = {k: _pad_block(x, block) for k, x in sorted_leaves.items()}
    outs = {k: torch.zeros(v, cap_out + block, dtype=movable(x).dtype,
                           device=dev) for k, x in padded.items()}
    for r in range(rounds):
        o = r * block
        pos = S.unsqueeze(-1) + o + biota                  # [V, W_src, B]
        pvalid = (o + biota) < ci.unsqueeze(-1)
        psafe = torch.where(pvalid, pos, cap_out + biota).view(v, -1)
        for k, xp in padded.items():
            recv = cm.all_to_all(_send_block(xp, start, o, block))
            outs[k].scatter_(1, psafe,
                             movable(recv).reshape(v, world * block))
    out = {k: outs[k][:, :cap_out].view(x.dtype)
           for k, x in padded.items()}
    new_emit = torch.arange(cap_out, device=dev) < ci.sum(1, keepdim=True)
    return out, new_emit, counts_in


def _local_counts(cm, targets, emit) -> torch.Tensor:
    """This process's rows [V_src, W_dst] of the send-count matrix of
    flat [V * cap] targets: K1's histogram summed over tiles on the
    kernel route, a bincount otherwise."""
    world = cm.world
    t = _dead_keyed(targets.view(cm.shards, -1),
                    emit.view(cm.shards, -1), world)
    if use_partition_kernel(world, t.device):
        return _k.partition_hist(t, world + 1)[:, :, :world].sum(
            1, dtype=torch.int32)
    return _target_counts(t, world)


def _count_matrix(cm, targets, emit) -> torch.Tensor:
    """The global send-count matrix [W_src, W_dst] on the device: the
    local rows, gathered."""
    return cm.replicated_gather(_local_counts(cm, targets, emit))


def count_pair(targets1, emit1, targets2, emit2, ctx: CylonContext):
    """Host (countsL, countsR) global send-count matrices [src, dst] for
    two shuffles: one gather, one device->host copy, in a
    ``shuffle.count`` span under the ``exchange.count`` retry policy."""
    cm = ctx.comm

    def compute():
        with _span("shuffle.count", ctx.get_next_sequence(),
                   world=cm.world, tables=2):
            host = cm.replicated_gather(torch.stack(
                [_local_counts(cm, targets1, emit1),
                 _local_counts(cm, targets2, emit2)], 1)).cpu().numpy()
        _metrics.record_host_sync("shuffle.count_pair")
        _counter("cylon_collective_launches_total").inc()
        return host[:, 0], host[:, 1]

    return _retry.run_retryable("exchange.count", compute)


def _counter(name: str, labels=None):
    return _metrics.REGISTRY.counter(name, labels)


def _payload_nbytes(payload: Dict[str, torch.Tensor]) -> int:
    """Bytes of a payload of per-row leaves (shape x itemsize, on the
    host): the ``bytes_moved`` span attribute and the
    ``cylon_shuffle_bytes_total`` feed."""
    return sum(x.element_size() * x.numel() for x in payload.values())


def _record_exchange(rows: int, nbytes: int, programs: int = 1) -> None:
    """Metrics of one exchange: payload bytes, live rows moved, and its
    launches (one a single-shot exchange, one a chunk)."""
    _counter("cylon_shuffle_bytes_total").inc(nbytes)
    _counter("cylon_rows_exchanged_total").inc(rows)
    _counter("cylon_collective_launches_total").inc(programs)


def _launch_exchange(fn):
    """One exchange body under the resilience policy: the fault
    injector's ``exchange`` choke point fires first (each retry attempt
    is one arrival), then the body runs under bounded retry. Re-running
    is safe: the body is a pure function of its input tensors. Runs
    inside the exchange span, so a recovered stage carries the
    ``retries`` attribute."""
    def attempt():
        _inject.fire("exchange")
        return fn()

    return _retry.run_retryable("exchange", attempt)


def _partition_label(world: int, device, chunked: bool) -> str:
    """The partition route one padded body takes: "kernel" (K1 + K2) or
    "sort" (the stable sort; the one-shard single-shot body)."""
    if world == 1 and not chunked:
        return "sort"
    return "kernel" if use_partition_kernel(world, device) else "sort"


def _record_partition(sp, *paths: str) -> None:
    """The partition routes of one exchange span (two for a pair): the
    ``cylon_partition_path_total{path=}`` counter per side and one
    ``partition_path`` attribute ("mixed" when the sides differ)."""
    sp.set(partition_path=paths[0] if len(set(paths)) == 1 else "mixed")
    for p in paths:
        _counter("cylon_partition_path_total", {"path": p}).inc()


def _record_chunked(sp, chunks: int, cb: int) -> None:
    """The chunk plan of a chunked exchange: span attributes and the
    ``cylon_exchange_chunks_total`` counter. (The JAX package's
    overlap-ratio histogram is left out: the chunks here run one after
    another on one stream, nothing overlaps.)"""
    sp.set(chunks=chunks, chunk_block=cb)
    _counter("cylon_exchange_chunks_total").inc(chunks)


def _payload_row_bytes(payload: Dict[str, torch.Tensor]) -> int:
    """Bytes a row of a payload of flat per-row leaves."""
    return sum(x.element_size() * int(np.prod(x.shape[1:]))
               for x in payload.values())


def _budget_block_cap(payload, world: int, budget: Optional[int], mb: int,
                      buffer_factor: int) -> int:
    """Shrink the per-round block cap until ``buffer_factor * world *
    block * row_bytes`` fits the comm budget, pow2-floored (the JAX
    package's rule, shuffle.py:1022; the reference's analog is the
    Allocator feeding receive buffers from the pool,
    arrow_all_to_all.cpp:234-247). No budget (the CPU) leaves ``mb``."""
    bytes_per_row = _payload_row_bytes(payload) or 4
    if budget:
        while mb > 1024 and buffer_factor * world * mb * bytes_per_row \
                > budget:
            mb //= 2
    return _pow2_floor(mb)


def _padded_route(counts: np.ndarray, payload, world: int,
                  budget: Optional[int], buffer_factor: int = 4,
                  max_block: Optional[int] = None) -> Tuple[bool, int, int]:
    """(padded_ok, block, mb): the JAX package's routing rule, ``mb`` the
    per-round block cap (MAX_BLOCK or ``max_block``, shrunk to the comm
    budget)."""
    max_pair = int(counts.max()) if counts.size else 0
    recv_max = int(counts.sum(axis=0).max()) if counts.size else 0
    block_p = _pow2(max_pair)
    mb = _budget_block_cap(payload, world, budget,
                           MAX_BLOCK if max_block is None else max_block,
                           buffer_factor)
    ok = (world * block_p <= PADDED_WASTE_FACTOR * max(_pow2(recv_max), 1)
          and block_p <= mb)
    return ok, block_p, mb


def _flat(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: x.reshape(-1) for k, x in d.items()}


def _shards(d: Dict[str, torch.Tensor], v: int):
    return {k: x.view(v, -1) for k, x in d.items()}


def exchange(payload: Dict[str, torch.Tensor], targets: torch.Tensor,
             emit: torch.Tensor, ctx: CylonContext,
             max_block: Optional[int] = None,
             counts: Optional[np.ndarray] = None, dense: bool = False):
    """Shuffle flat ``[W * cap]`` per-row tensors to their target shards.
    Returns (exchanged payload, new emit mask, output capacity a shard,
    meta {"mode", "block", "counts_in"}), the JAX package's 4-tuple. Each
    source's rows land contiguous and in stable order: at ``s * block``
    in "padded" mode (capacity ``world * block``), as one live prefix in
    "compact" mode (capacity ``pow2(recv_max)``, ``block`` 0). A padded
    exchange that chunks (`_chunk_plan`) adds ``"chunks"`` to meta.
    ``max_block`` caps the per-round block (MAX_BLOCK by default).
    ``counts``, where the caller has it, is the global [W, W] matrix."""
    cm = ctx.comm
    world = cm.world
    seq = ctx.get_next_sequence()
    if world == 1 and counts is None and dense:
        # one shard, every row live: block = pow2(n), counts in-program;
        # only the memory budget (or ``max_block``) binds, there are no
        # rounds
        block1 = _pow2(int(targets.shape[0]))
        mb1 = _budget_block_cap(payload, 1, ctx.comm_budget_bytes(),
                                block1 if max_block is None else max_block,
                                4)
        if block1 <= mb1:
            rows = int(targets.shape[0])
            nbytes = _payload_nbytes(payload)
            with _span("shuffle.exchange", seq, world=1, mode="padded",
                       rows=rows, bytes_moved=nbytes):
                out, new_emit, ci = _launch_exchange(
                    lambda: _padded_body(cm, block1, _shards(payload, 1),
                                         targets.view(1, -1),
                                         emit.view(1, -1)))
            _record_exchange(rows, nbytes)
            return _flat(out), new_emit.reshape(-1), block1, {
                "mode": "padded", "block": block1, "counts_in": ci}
    if counts is None:
        def compute():
            with _span("shuffle.count", seq, world=world, tables=1):
                res = _count_matrix(cm, targets, emit).cpu().numpy()
            _metrics.record_host_sync("shuffle.count")
            _counter("cylon_collective_launches_total").inc()
            return res

        counts = _retry.run_retryable("exchange.count", compute)
    ok, block_p, mb = _padded_route(counts, payload, world,
                                    ctx.comm_budget_bytes(), 4, max_block)
    shards = (_shards(payload, cm.shards), targets.view(cm.shards, -1),
              emit.view(cm.shards, -1))
    rows_live = int(counts.sum()) if counts.size else 0
    nbytes = _payload_nbytes(payload)
    row_bytes = _payload_row_bytes(payload)
    # skew rides the count matrix the host already holds (None on one
    # shard)
    skew_stats = _skew.observe_exchange(counts, row_bytes)
    with _span("shuffle.exchange", seq, world=world,
               mode="padded" if ok else "compact", rows=rows_live,
               bytes_moved=nbytes) as sp:
        if skew_stats is not None:
            sp.set(**skew_stats.span_attrs())
        if ok:
            cb, chunks = _chunk_plan(block_p, world, row_bytes)
            _record_partition(sp, _partition_label(world, targets.device,
                                                   chunks > 1))
            if chunks > 1:
                out, new_emit, ci = _chunked_body(cm, block_p, cb, *shards)
            else:
                out, new_emit, ci = _launch_exchange(
                    lambda: _padded_body(cm, block_p, *shards))
            meta = {"mode": "padded", "block": block_p, "counts_in": ci}
            if chunks > 1:
                meta["chunks"] = chunks
                _record_chunked(sp, chunks, cb)
            _record_exchange(rows_live, nbytes, chunks)
            return _flat(out), new_emit.reshape(-1), world * block_p, meta
        max_pair = int(counts.max()) if counts.size else 0
        recv_max = int(counts.sum(axis=0).max()) if counts.size else 0
        block = min(block_p, mb)
        # a pow2 round count, as in the JAX package
        rounds = _pow2(-(-max(max_pair, 1) // block))
        cap = _pow2(recv_max)
        sp.set(block=block, rounds=rounds)
        out, new_emit, ci = _launch_exchange(
            lambda: _compact_body(cm, block, rounds, cap, *shards))
    _record_exchange(rows_live, nbytes)
    return _flat(out), new_emit.reshape(-1), cap, {
        "mode": "compact", "block": 0, "counts_in": ci}


def exchange_pair(payload1, targets1, emit1, counts1,
                  payload2, targets2, emit2, counts2, ctx: CylonContext,
                  dense: bool = False):
    """Both sides of a two-table shuffle; each result is exchange()'s
    4-tuple. ``counts`` may be None on a one-shard world with dense
    emits (the counts then come from the exchange itself). The JAX
    package's routing (shuffle.py:749-812): when both sides route padded
    (at the pair's buffer factor, 8) and neither chunks, both padded
    bodies run in one ``shuffle.exchange_pair`` span and are retried
    together (its pair program); otherwise each side goes through
    exchange(). Either way each side lands as exchange() would land
    it."""
    cm = ctx.comm
    world = cm.world
    budget = ctx.comm_budget_bytes()
    sides = ((payload1, targets1, emit1, counts1),
             (payload2, targets2, emit2, counts2))
    if world == 1 and counts1 is None and counts2 is None and dense:
        blocks = [_pow2(int(t.shape[0])) for _p, t, _e, _c in sides]
        fused = all(b <= _budget_block_cap(p, 1, budget, b, 8)
                    for (p, _t, _e, _c), b in zip(sides, blocks))
        rows = sum(int(t.shape[0]) for _p, t, _e, _c in sides)
    else:
        routes = [_padded_route(c, p, world, budget, 8)
                  for p, _t, _e, c in sides]
        blocks = [b for _ok, b, _mb in routes]
        fused = all(ok for ok, _b, _mb in routes) and all(
            _chunk_plan(b, world, _payload_row_bytes(p))[1] == 1
            for (p, _t, _e, _c), b in zip(sides, blocks))
        rows = sum(int(c.sum()) for _p, _t, _e, c in sides)
    if not fused:
        return tuple(exchange(p, t, e, ctx, counts=c, dense=dense)
                     for p, t, e, c in sides)
    seq = ctx.get_next_sequence()
    nbytes = sum(_payload_nbytes(p) for p, _t, _e, _c in sides)
    pair_stats = None
    if counts1 is not None:
        # per-side histograms carry each table's row width; the span
        # carries the combined per-destination totals
        for p, _t, _e, c in sides:
            _skew.observe_exchange(c, _payload_row_bytes(p))
        pair_stats = _skew.SkewStats.from_counts(np.asarray(counts1)
                                                 + np.asarray(counts2))
    with _span("shuffle.exchange_pair", seq, world=world, mode="padded",
               rows=rows, bytes_moved=nbytes) as sp:
        if pair_stats is not None:
            sp.set(**pair_stats.span_attrs())
        if counts1 is not None:
            part = _partition_label(world, targets1.device, False)
            _record_partition(sp, part, part)
        res = _launch_exchange(lambda: tuple(
            _padded_body(cm, b, _shards(p, cm.shards),
                         t.view(cm.shards, -1), e.view(cm.shards, -1))
            for (p, t, e, _c), b in zip(sides, blocks)))
    _record_exchange(rows, nbytes)
    return tuple((_flat(out), ne.reshape(-1), world * b,
                  {"mode": "padded", "block": b, "counts_in": ci})
                 for (out, ne, ci), b in zip(res, blocks))


def salted_exchange_targets(targets: torch.Tensor, emit: torch.Tensor,
                            ctx: CylonContext, salt: int,
                            warn_factor: float):
    """The salted shuffle's routing (the JAX package's
    ``_salted_targets_fn``, shuffle.py:919-976): a destination is hot
    when its receive total exceeds ``warn_factor`` x the mean (computed in
    float32, as there); a hot destination's rows spread over ``salt``
    consecutive shards by ``fmix32(row index within the shard) % salt``.
    Returns (salted targets int32 [V * cap], salted counts, raw counts),
    the two global ``[W, W]`` host count matrices fetched together, under
    the ``exchange.count`` retry policy."""
    cm = ctx.comm
    world = cm.world
    t = targets.view(cm.shards, -1).to(torch.int32)
    e = emit.view(cm.shards, -1)

    def compute():
        raw = _count_matrix(cm, t, e)
        recv = raw.sum(0)
        total = recv.sum().clamp(min=1)
        hot = (recv.to(torch.float32) * float(world)
               > torch.tensor(warn_factor, dtype=torch.float32,
                              device=t.device) * total.to(torch.float32))
        iota = torch.arange(t.shape[1], device=t.device)
        sub = (_hash.fmix32(iota) % salt).to(torch.int32)
        safe = t.clamp(0, world - 1)
        spread = (safe + sub) % world
        t2 = torch.where(hot[safe.to(torch.int64)] & e, spread, safe)
        salted = _count_matrix(cm, t2, e)
        host = torch.stack([salted, raw]).cpu().numpy()
        _metrics.record_host_sync("shuffle.salt")
        _counter("cylon_collective_launches_total").inc()
        return t2.reshape(-1), host[0], host[1]

    return _retry.run_retryable("exchange.count", compute)
