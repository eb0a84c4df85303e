"""Distributed relational operators: shuffle-composed, per-shard kernels
(counterpart of cylon_tpu.parallel.dist_ops: the shuffle, the join, the
set ops, the groupby, the sort, hash_partition and repartition).

The reference composes every distributed op as *local partition +
all-to-all + local op* (reference: DistributedJoin, table.cpp:656-696).
The same composition here:

  1. key prep on the flat sharded columns (elementwise): dtype promotion,
     order-preserving key bits, murmur-style partition targets;
  2. the counted padded exchange of parallel/shuffle.py;
  3. the per-shard op on ``[W, cap]`` views: matching keys (full rows for
     a set op) are co-located after the hash shuffle, so one batched call
     of the local op's routes covers every shard.

Results stay sharded: a result table holds ``W * cap`` rows, its padding
masked by ``row_mask``.

In a context of P processes of V shards each (W = P * V) a process's
tensors hold its own V shards, ``[V * cap]``, and every per-shard view
is ``[V, cap]`` (V = W in the virtual world). What the JAX package gets
replicated by construction becomes an explicit collective here
(``ctx.comm``, parallel/comm.py), so every process takes the same
decision: the count matrices are gathered, the capacities and the
per-shard routes agreed by an all-reduce, the sort's sample gathered in
global order, the comm budget agreed as a minimum.

Every materialized output is registered with the telemetry ledger under
the JAX package's owner labels (``shuffle``, ``distributed_join``,
``distributed_join_ring``, ``distributed_set_op``,
``distributed_groupby``, ``distributed_sort``, ``repartition``); the
join counts the algorithm it ran in ``cylon_join_algorithm_total
{algo=}`` and the salted shuffle annotates the open span with the raw
(pre-salt) skew the planner's salting decision reads.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes
from ..context import CylonContext
from ..data import table as table_mod
from ..data.column import Column, string_key_arrays
from ..data.table import Table
from ..dtypes import movable
from ..ops import groupby as _groupby
from ..ops import hash as _hash
from ..ops import join as _join
from ..ops import order as _order
from ..ops import setops as _setops
from ..data.strings import (EXACT_KEY_WORDS, LANE_WORDS_MAX, VarBytes,
                            _nwords, _word_row_map, pair_k_words)
from ..status import Code, CylonError, not_ported
from ..telemetry import annotate as _annotate
from ..telemetry import knobs as _knobs
from ..telemetry import ledger as _ledger
from ..telemetry import metrics as _metrics
from ..telemetry import phase as _phase
from ..telemetry import skew as _skew
from ..telemetry import span as _span
from ..util import bucket_cap as _bucket_cap
from ..util import capacity as _capacity
from ..util import pow2_floor as _pow2_floor
from . import shard
from .comm import agree_max
from .shuffle import (count_pair, exchange, exchange_pair,
                      salted_exchange_targets)


# ---------------------------------------------------------------------------
# key prep: bits and partition hashes of plain, dictionary and varbytes
# key columns, on the flat sharded columns (elementwise, or through
# eff_starts for varbytes: a sharded varbytes column's per-shard layouts
# tile one global word buffer, so whole-tensor passes cover every shard)
# ---------------------------------------------------------------------------


def _lanes_hash(lanes: Sequence[torch.Tensor], ln: torch.Tensor
                ) -> torch.Tensor:
    """Partition hash of word lanes + byte length (the exact-key analog
    of the content hash h1; both sides of a join pass the same lane
    count, so equal bytes land on equal shards), as int32 bits."""
    h = (_hash.u32(ln) * 0x9E3779B1) & _hash.M32
    for l in lanes:
        h = (h * 31 + _hash.fmix32(_hash.u32(l))) & _hash.M32
    return _hash.as_i32(_hash.fmix32(h))


def _lane_count(c: Column, k_words: Optional[int]) -> int:
    vb = c.varbytes
    return vb.max_words if k_words is None else max(int(k_words),
                                                    vb.max_words)


def _dist_col_bits(c: Column, k_words: Optional[int] = None) -> list:
    """One column's key bit arrays: short varbytes rows (<=
    EXACT_KEY_WORDS words, at least ``k_words`` lanes) their word lanes +
    length, byte-exact; longer rows the content-hash quad; plain and
    dictionary columns their ordered bits (nulls at the all-ones end)."""
    if not c.is_varbytes:
        return [_order.sort_keys([c])[0]]
    return string_key_arrays(c, k_words)[0]


def _dist_col_hash(c: Column, k_words: Optional[int] = None
                   ) -> torch.Tensor:
    """One column's partition hash: the word-lane hash of short varbytes
    rows, the content hash h1 of long ones, ops/hash.hash_column
    otherwise; null rows hash to the null tag."""
    if not c.is_varbytes:
        return _hash.hash_column(c)
    k = _lane_count(c, k_words)
    h1 = _lanes_hash(c.varbytes.word_lanes(k), c.varbytes.lengths) \
        if k <= EXACT_KEY_WORDS else c.varbytes.raw_hashes()[0]
    if c.validity is not None:
        h1 = torch.where(c.validity, h1, _hash.NULL_TAG - (1 << 32))
    return h1


def _dist_key_bits(cols: Sequence[Column],
                   paired: Optional[Sequence[Column]] = None):
    """Key bit arrays and combined key validity of flat sharded key
    columns. ``paired``: the other side's aligned key columns, so both
    sides emit matching lane counts."""
    bits = []
    for j, c in enumerate(cols):
        bits.extend(_dist_col_bits(
            c, pair_k_words(c, paired[j]) if paired is not None else None))
    return tuple(bits), table_mod._all_valid(cols)


def _targets_from_hashes(world: int, h1s: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """Combine per-column row hashes into a shard target (the
    ops/hash.hash_columns combine scheme, from the first hash)."""
    return (_hash.combine_hashes(h1s) % world).to(torch.int32)


def _partition_targets_dist(world: int, cols: Sequence[Column],
                            paired: Optional[Sequence[Column]] = None
                            ) -> torch.Tensor:
    """Per-row target shard for the key columns."""
    return _targets_from_hashes(world, [
        _dist_col_hash(c, pair_k_words(c, paired[j])
                       if paired is not None else None)
        for j, c in enumerate(cols)])


# ---------------------------------------------------------------------------
# varbytes movement: short rows ride the row exchange as word lanes; long
# rows move their words through a second exchange whose "rows" are words,
# then the shard-relative starts are rebuilt from both exchanges' layouts
# ---------------------------------------------------------------------------


def _word_targets(vb, targets: torch.Tensor, emit: torch.Tensor):
    """Per-word (targets, emit): every word inherits its row's target;
    words of dead rows and slack slots are dropped."""
    nw = _nwords(vb.lengths)
    row, p = _word_row_map(vb.eff_starts(), nw, int(vb.words.shape[0]))
    wemit = emit[row] & (p >= 0) & (p < nw[row])
    return targets[row].to(torch.int32), wemit


def _block_offsets(meta: dict, world: int, like: torch.Tensor):
    """[W, W] start of each source's items in each receiving shard: s *
    block on the padded route, the exclusive cumsum of the counts on the
    compact route (block 0)."""
    ci = meta["counts_in"].to(torch.int64)
    if meta["block"]:
        return (torch.arange(world, device=like.device)
                * meta["block"]).expand(ci.shape[0], world)
    return torch.cumsum(ci, 1) - ci


def _starts_reconcile(cm, lengths: torch.Tensor, row_meta: dict,
                      word_meta: dict) -> torch.Tensor:
    """Shard-relative starts after a row + word exchange pair, for any mix
    of padded and compact layouts: both exchanges keep each source's
    items contiguous and in order, so row (source s, j)'s words sit at
    that source's word-segment offset plus the within-source word
    prefix. Dead rows must have length 0."""
    L = lengths.view(cm.shards, -1)
    n = L.shape[1]
    nw = _nwords(L)
    cs = _order.cumsum_rows(nw)
    row_off = _block_offsets(row_meta, cm.world, L)
    word_off = _block_offsets(word_meta, cm.world, L)
    pos = torch.arange(n, device=L.device)
    sid = (pos.view(1, 1, n) >= row_off[:, 1:].unsqueeze(-1)).sum(1)
    head = torch.where(row_off > 0, cs.gather(1, (row_off - 1).clamp(
        0, max(n - 1, 0))), 0)
    starts = word_off.gather(1, sid) + (cs - nw) - head.gather(1, sid)
    return starts.reshape(-1).to(torch.int32)


def _exchange_varbytes_words(ctx: CylonContext, vb, targets, emit,
                             new_lengths, row_meta: dict):
    """The word leg of a varbytes shuffle: the words ride their own
    exchange (its stable partition keeps word order = row order), then
    the starts are rebuilt."""
    v = ctx.local_shard_count()
    wt, wemit = _word_targets(vb, targets, emit)
    wout, _e, _cap, wmeta = exchange({"w": vb.words}, wt, wemit, ctx)
    w = wout["w"]
    return VarBytes(w, _starts_reconcile(ctx.comm, new_lengths, row_meta,
                                         wmeta),
                    new_lengths, vb.max_words, int(w.shape[0]),
                    shard_geom=(int(new_lengths.shape[0]) // v,
                                int(w.shape[0]) // v))


def _take_into_shards(src, idx_g: torch.Tensor, cm) -> VarBytes:
    """Per-shard varlen gather: ``idx_g`` [V, m] holds row indices of
    ``src``'s flat buffer (-1: an empty row); shard w's rows land packed
    in its own word segment of ``bucket_cap`` (worst shard's words, over
    every process) words, with shard-relative starts — one host sync
    for that capacity."""
    v, m = idx_g.shape
    dev = idx_g.device
    hit = idx_g >= 0
    if src.nrows == 0:
        hit = torch.zeros_like(hit)
    safe = torch.where(hit, idx_g, 0)
    nw_src = _nwords(src.lengths)
    nw = torch.where(hit, nw_src[safe], 0) if src.nrows \
        else torch.zeros_like(idx_g)
    lens = torch.where(hit, src.lengths[safe], 0) if src.nrows \
        else torch.zeros(v, m, dtype=torch.int32, device=dev)
    worst = 0
    if m:
        worst = int(nw.sum(1).max())
        _metrics.record_host_sync("varlen.count")
    cap_w = _bucket_cap(agree_max(cm, [worst])[0])
    starts = _order.cumsum_rows(nw) - nw
    words = torch.zeros(v * cap_w, dtype=torch.int32, device=dev)
    if m and src.nrows:
        gstarts = starts + torch.arange(v, device=dev).unsqueeze(1) \
            * cap_w
        row, p = _word_row_map(gstarts.reshape(-1), nw.reshape(-1),
                               v * cap_w)
        at = src.eff_starts()[safe.reshape(-1)][row] + p
        w = src.words[at.clamp(0, int(src.words.shape[0]) - 1)]
        valid = (p >= 0) & (p < nw.reshape(-1)[row])
        words = torch.where(valid, w, 0)
    return VarBytes(words, starts.reshape(-1).to(torch.int32),
                    lens.reshape(-1).to(torch.int32), src.max_words,
                    v * cap_w, shard_geom=(m, cap_w))


def varlen_take_sharded(vb, idx: torch.Tensor, cm) -> VarBytes:
    """The distributed VarBytes.take: ``idx`` is the flat ``[V * m]``
    layout of shard-local row indices (-1: an empty row) into the
    sharded ``vb`` (``cm`` the collective backend)."""
    iw = idx.view(cm.shards, -1).to(torch.int64)
    rows = vb.nrows // cm.shards
    base = torch.arange(cm.shards, device=iw.device).unsqueeze(1) * rows
    return _take_into_shards(vb, torch.where(iw >= 0, iw + base, -1), cm)


def _dist_as_varbytes(col: Column, cm) -> Column:
    """A sharded dictionary column lifted to varbytes: the vocabulary's
    VarBytes is built once and every shard gathers its own layout."""
    if col.is_varbytes:
        return col
    vocab = VarBytes.from_host(col.dictionary, device=col.data.device)
    vb = _take_into_shards(
        vocab, col.data.view(cm.shards, -1).to(torch.int64), cm)
    return Column(vb.lengths, col.dtype, col.validity, col.name, varbytes=vb)


def _align_key_columns_dist(left_d: Table, right_d: Table, lidx, ridx,
                            cm):
    """Distribution-aware align_key_columns: a dictionary column meeting
    a varbytes one lifts per shard (the local lift would collapse the
    per-shard layouts)."""
    lcols, rcols = [], []
    for li, ri in zip(lidx, ridx):
        a, b = left_d._columns[li], right_d._columns[ri]
        if a.is_string and b.is_string and (a.is_varbytes or b.is_varbytes):
            a, b = _dist_as_varbytes(a, cm), _dist_as_varbytes(b, cm)
        else:
            a, b = table_mod._align_pair(a, b)
        lcols.append(a)
        rcols.append(b)
    return lcols, rcols


def _build_exchange_payload(t: Table) -> Tuple[dict, dict]:
    """Payload leaves of a table shuffle: all-valid columns skip their
    mask leaf (validity None round-trips as None); short varbytes columns
    (<= LANE_WORDS_MAX words) add their word lanes as legs. Returns
    (payload, lane_cols: column -> lane count)."""
    payload, lane_cols = {}, {}
    for i, c in enumerate(t._columns):
        payload[f"d{i}"] = c.data
        if c.validity is not None:
            payload[f"v{i}"] = c.validity
        if c.is_varbytes and c.varbytes.max_words <= LANE_WORDS_MAX:
            lane_cols[i] = c.varbytes.max_words
            for k, l in enumerate(c.varbytes.word_lanes()):
                payload[f"d{i}w{k}"] = l
    return payload, lane_cols


def _finish_exchange_table(t: Table, ctx: CylonContext, targets, emit,
                           result, lane_cols: dict):
    """Columns out of an exchange result. Varbytes rows that are dead
    after the exchange get length 0 first (both exchange routes leave
    garbage in dead slots; the lane masks and the word-row map need
    nw = 0 there)."""
    out, new_emit, _cap, meta = result
    cols = []
    for i, c in enumerate(t._columns):
        d, v = out[f"d{i}"], out.get(f"v{i}")
        if not c.is_varbytes:
            cols.append(Column(d, c.dtype, v, c.name,
                               dictionary=c.dictionary))
            continue
        d = torch.where(new_emit, d, 0)
        if i in lane_cols:
            vb = VarBytes.from_lanes([out[f"d{i}w{k}"]
                                      for k in range(lane_cols[i])], d,
                                     ctx.local_shard_count())
        else:
            vb = _exchange_varbytes_words(ctx, c.varbytes, targets, emit, d,
                                          meta)
        cols.append(Column(vb.lengths, c.dtype, v, c.name, varbytes=vb))
    return cols, new_emit


def _exchange_table(t: Table, targets, emit, ctx, extra=None, counts=None,
                    dense: bool = False):
    """Shuffle a whole table's columns plus optional extra per-row int32
    tensors (``extra``: name -> flat ``[V * cap]`` tensor, one more K2 leg
    each). Returns (columns, new_emit, extra_out)."""
    payload, lane_cols = _build_exchange_payload(t)
    for k, x in (extra or {}).items():
        if k in payload:
            raise CylonError(Code.Invalid, f"extra leg {k!r} names a "
                             f"payload leaf")
        payload[k] = x
    res = exchange(payload, targets, emit, ctx, counts=counts, dense=dense)
    cols, new_emit = _finish_exchange_table(t, ctx, targets, emit, res,
                                            lane_cols)
    return cols, new_emit, {k: res[0][k] for k in (extra or {})}


def _exchange_table_pair(t1: Table, tg1, e1, c1, t2: Table, tg2, e2, c2,
                         ctx, dense: bool = False):
    """The two-table shuffle of a distributed join."""
    p1, lc1 = _build_exchange_payload(t1)
    p2, lc2 = _build_exchange_payload(t2)
    r1, r2 = exchange_pair(p1, tg1, e1, c1, p2, tg2, e2, c2, ctx,
                           dense=dense)
    return (_finish_exchange_table(t1, ctx, tg1, e1, r1, lc1),
            _finish_exchange_table(t2, ctx, tg2, e2, r2, lc2))


def _rebuild_columns(dat: Sequence, val: Sequence, src: Sequence[Column],
                     names: Sequence[str]) -> List[Column]:
    return [Column(d, c.dtype, v, name, dictionary=c.dictionary)
            for d, v, c, name in zip(dat, val, src, names)]


def _shards(xs, v: int) -> tuple:
    """Flat [V * cap] tensors as [V, cap] per-shard views."""
    return tuple(x.view(v, -1) for x in xs)


def _dist_stream_mode(lkb, rkb, join_type: _join.JoinType,
                      device: torch.device) -> Optional[Tuple[bool, int]]:
    """None (the plan route) or (hash_mode, block_rows) when the per-shard
    stream route applies to [W, na] and [W, nb] key bits: on CUDA the
    kernel route K3/K4, where the JAX package picks its Pallas kernels on
    a TPU."""
    if not _join._stream_on(device) \
            or join_type == _join.JoinType.FULL_OUTER:
        return None
    na = int(lkb[0].shape[1])
    nb = int(rkb[0].shape[1])
    if na == 0 or nb == 0 or na + nb >= (1 << 29):
        return None
    if len(lkb) == 1 and lkb[0].element_size() == 4:
        return (False, _join.stream_block_rows(na, nb))
    lanes = sum(2 if b.element_size() == 8 else 1 for b in lkb)
    if lanes <= _join.MAX_HASH_KEY_LANES:
        return (True, _join.stream_block_rows(na, nb))
    return None


def _plan_on_device(lkb, lkv, lemit, rkb, rkv, remit, ldat, lval, rdat,
                    rval, jt: _join.JoinType, stream: bool = True):
    """The device half of phase 1 of the per-shard join over [V, n] key
    bits, key validity, emits and payload lanes: K3 on the stream route
    (picked by `_dist_stream_mode`, unless ``stream`` is False), the plan
    route otherwise. Returns (route, device counts, state); the stream
    route's counts are K3's int32 [V, 4] (column 3 flags a 64-bit hash
    collision when ``state[6]``, the hash mode, is set), the plan route's
    [V, 2] = [n_out, n_unmatched_b]."""
    mode = _dist_stream_mode(lkb, rkb, jt, lemit.device) if stream else None
    if mode is not None:
        hash_mode, br = mode
        a_desc, b_desc = _join.plan_lane_descs(ldat, lval, rdat, rval, jt)
        counts, a_streams, b_streams = _join.plan_program_stream(
            lkb, lkv, lemit, rkb, rkv, remit, ldat, lval, rdat, rval, jt,
            a_desc=a_desc, b_desc=b_desc, hash_mode=hash_mode)
        return "stream", counts, (counts, a_streams, b_streams, a_desc,
                                  b_desc, br, hash_mode)
    counts2, lo, m, bperm, un_mask = _join.join_plan_keys(
        lkb, lkv, lemit, rkb, rkv, remit, jt)
    aemit = remit if jt == _join.JoinType.RIGHT else lemit
    return "plan", counts2, (lo, m, bperm, un_mask, aemit)


def _host_counts(route: str, hc: np.ndarray) -> np.ndarray:
    """int64 [V, 2] = [n_out, n_unmatched_b] from fetched plan counts."""
    hc = hc.astype(np.int64)
    if route == "plan":
        return hc
    return np.stack([hc[:, 0], np.zeros_like(hc[:, 0])], 1)


def _collided(cm, route: str, state, hc: np.ndarray) -> bool:
    """A 64-bit hash collision of the stream route's hash mode on any
    shard of any process (agreed through ``cm``)."""
    return route == "stream" and state[6] and \
        agree_max(cm, [hc[..., 3].max()])[0] > 0


def _shard_plan(cm, lkb, lkv, lemit, rkb, rkv, remit, ldat, lval, rdat,
                rval, jt: _join.JoinType):
    """Phase 1 of the per-shard join: `_plan_on_device`, its counts
    fetched (``join.plan``), the plan route again after a hash collision.
    Returns (route, host counts int64 [V, 2] = [n_out, n_unmatched_b],
    state) for `_shard_materialize`."""
    args = (lkb, lkv, lemit, rkb, rkv, remit, ldat, lval, rdat, rval, jt)
    route, counts, state = _plan_on_device(*args)
    hc = counts.cpu().numpy()
    _metrics.record_host_sync("join.plan")
    if _collided(cm, route, state, hc):
        # recompute via the exact plan route
        route, counts, state = _plan_on_device(*args, stream=False)
        hc = counts.cpu().numpy()
        _metrics.record_host_sync("join.plan")
    return route, _host_counts(route, hc), state


def _shard_materialize(route: str, state, ldat, lval, rdat, rval,
                       jt: _join.JoinType, cap: int, cap_u: int = 0):
    """Phase 2 of the per-shard join at ``cap`` output rows a shard (plus
    ``cap_u`` unmatched build rows on the plan route's FULL_OUTER): K4 on
    the stream route. Returns (ldat', lval', rdat', rval', emit, lidx,
    ridx), each [W, cap + cap_u]."""
    if route == "stream":
        counts, a_streams, b_streams, a_desc, b_desc = state[:5]
        return _join.materialize_program_stream(
            counts, a_streams, b_streams, ldat, lval, rdat, rval, jt, cap,
            a_desc=a_desc, b_desc=b_desc)
    lo, m, bperm, un_mask, aemit = state
    return _join.materialize_program(lo, m, bperm, un_mask, aemit, ldat,
                                     lval, rdat, rval, jt, cap, cap_u)


def _shard_matched(route: str, state) -> torch.Tensor:
    """bool [V, na]: the probe rows an INNER plan matched (K3's group A
    rows, the plan route's ``m > 0``)."""
    if route == "stream":
        counts, a_streams = state[0], state[1]
        w, na = a_streams.shape[1:]
        idx = a_streams[0].to(torch.int64)
        pos = torch.arange(na, device=idx.device)
        emits = pos < counts[:, 1:2].to(torch.int64)
        # entries past n_emit go to spare slots of their own: one shared
        # overflow slot would serialise their stores on the card
        hit = torch.zeros(w, 2 * na, dtype=torch.bool, device=idx.device)
        hit.scatter_(1, torch.where(emits, idx, na + pos), True)
        return hit[:, :na]
    return state[1] > 0


def _shard_caps(cm, route: str, host: np.ndarray, state,
                jt: _join.JoinType) -> Tuple[int, int]:
    """(cap, cap_u) of `_shard_materialize` from the worst shard of every
    process: the JAX package's shapes, the stream route's expansion
    capacity or the plan route's bucket capacities."""
    n_out, n_un = agree_max(cm, host.max(axis=0))
    if route == "stream":
        return _join.stream_expand_capacity(n_out, state[5]), 0
    cap_u = _bucket_cap(n_un) if jt == _join.JoinType.FULL_OUTER else 0
    return _bucket_cap(n_out), cap_u


def shuffle(table: Table, hash_columns: Sequence,
            salted: bool = False) -> Table:
    """Repartition rows by key hash (reference: cylon::Shuffle,
    table.cpp:162-236). Tables already hash-placed on the same keys pass
    through without an exchange.

    ``salted``: the hot-key variant (the JAX package's dist_ops.py:751):
    destinations whose receive total exceeds CYLON_SKEW_WARN_FACTOR x the
    mean spread their rows over the pow2 floor of CYLON_SALT_FACTOR
    consecutive shards (`shuffle.salted_exchange_targets`); a factor
    below 2 turns salting off. The salt only routes, the rows are
    unchanged, but the output carries no placement witness."""
    ctx = table._ctx
    world = ctx.get_world_size()
    if world == 1:
        return table
    t = shard.distribute(table, ctx)
    idxs = [t._col_index(c) for c in hash_columns]
    sig = shard.partition_signature([t._columns[i] for i in idxs], idxs,
                                    world)
    salt = _pow2_floor(max(int(_knobs.get("CYLON_SALT_FACTOR")), 1)) \
        if salted else 0
    salted = salted and salt >= 2
    if sig is not None and t._hash_partitioned == sig and not salted:
        return t
    targets = _partition_targets_dist(world, [t._columns[i] for i in idxs])
    emit = t.emit_mask()
    if salted:
        targets, counts, raw = salted_exchange_targets(
            targets, emit, ctx, salt,
            float(_knobs.get("CYLON_SKEW_WARN_FACTOR")))
        _counter("cylon_salted_exchanges_total").inc()
        raw_stats = _skew.SkewStats.from_counts(raw)
        _annotate(salted=True, salt_factor=salt,
                  skew_raw=round(raw_stats.imbalance, 3)
                  if raw_stats is not None else None)
        cols, new_emit, _ = _exchange_table(t, targets, emit, ctx,
                                            counts=counts)
        result = Table(cols, ctx, new_emit)
        result._shard_world = world
        table._free_if_unretained()
        return _ledger.track(result, "shuffle")
    cols, new_emit, _ = _exchange_table(t, targets, emit, ctx,
                                        dense=t.row_mask is None)
    result = Table(cols, ctx, new_emit)
    result._shard_world = world
    result._hash_partitioned = sig
    # reference parity: Shuffle frees non-retained inputs (table.cpp:207)
    table._free_if_unretained()
    return _ledger.track(result, "shuffle")


def _counter(name: str, labels=None):
    return _metrics.REGISTRY.counter(name, labels)


def _shards_opt(xs, v: int) -> tuple:
    """`_shards` keeping None entries (all-valid lane columns)."""
    return tuple(None if x is None else x.view(v, -1) for x in xs)


def distributed_join(left: Table, right: Table, config: _join.JoinConfig,
                     force_exchange: bool = False) -> Table:
    """The shuffle join (reference: DistributedJoin, table.cpp:656-696).
    ``force_exchange`` runs the full shuffle + join composition even on a
    one-shard world or co-partitioned inputs. Short varbytes columns ride
    the exchange and the join as word lanes; long ones move their words
    through their own exchange and gather per shard. With ``exact``, long
    varbytes keys (joined on their content hash) are byte-verified after
    the join."""
    ctx = left._ctx
    world = ctx.get_world_size()
    if world == 1 and not (force_exchange and ctx.is_distributed()):
        # reference parity: world 1 short-circuits to the local join
        _counter("cylon_join_algorithm_total", {"algo": "local"}).inc()
        return _ledger.track(table_mod.join(left, right, config),
                             "distributed_join")
    _counter("cylon_join_algorithm_total", {"algo": "shuffle"}).inc()
    lidx, ridx = config.left_column_idx, config.right_column_idx
    exact_pairs = []
    if config.exact:
        for li, rj in zip(lidx, ridx):
            kw = pair_k_words(left._columns[li], right._columns[rj])
            if kw is not None and kw > EXACT_KEY_WORDS:
                exact_pairs.append((li, rj))
    cm = ctx.comm
    v = cm.shards
    left_d = shard.distribute(left, ctx)
    right_d = shard.distribute(right, ctx)
    lcols, rcols = _align_key_columns_dist(left_d, right_d, lidx, ridx, cm)

    seq = ctx.get_next_sequence()
    with _span("distributed_join.shuffle", seq, world=world,
               rows_in=left_d.capacity + right_d.capacity) as sp:
        plan = []
        for t, kcols, kidx, other in ((left_d, lcols, lidx, rcols),
                                      (right_d, rcols, ridx, lcols)):
            sig = shard.partition_signature(kcols, kidx, world)
            if sig is not None and t._hash_partitioned == sig \
                    and not force_exchange:
                # co-partitioned: rows are already hash-placed
                plan.append(("skip", t, None, None))
                continue
            plan.append(("exchange", t,
                         _partition_targets_dist(world, kcols, other),
                         t.emit_mask()))
        ex = [p for p in plan if p[0] == "exchange"]
        sp.set(sides_exchanged=len(ex), sides_skipped=2 - len(ex))
        results = {}
        if len(ex) == 2:
            # one count fetch covers both shuffles; a dense one-shard
            # world needs none (the exchange counts in-program)
            dense = ex[0][1].row_mask is None and ex[1][1].row_mask is None
            cl = cr = None
            if world > 1 or not dense:
                cl, cr = count_pair(ex[0][2], ex[0][3], ex[1][2], ex[1][3],
                                    ctx)
            r1, r2 = _exchange_table_pair(ex[0][1], ex[0][2], ex[0][3], cl,
                                          ex[1][1], ex[1][2], ex[1][3], cr,
                                          ctx, dense=dense)
            results[id(ex[0])] = r1
            results[id(ex[1])] = r2
        shuffled = []
        for p in plan:
            kind, t, targets, emit = p
            if kind == "skip":
                shuffled.append((t._columns, t.emit_mask()))
            elif id(p) in results:
                shuffled.append(results[id(p)])
            else:
                shuffled.append(_exchange_table(
                    t, targets, emit, ctx, dense=t.row_mask is None)[:2])

    # key bits from the SHUFFLED columns (elementwise ordered bits; word
    # lanes slice out of the strided layout)
    (lcols_s, lemit), (rcols_s, remit) = shuffled
    left_s = Table(list(lcols_s), ctx, lemit)
    right_s = Table(list(rcols_s), ctx, remit)
    lcols2, rcols2 = _align_key_columns_dist(left_s, right_s, lidx, ridx,
                                             cm)
    lkb, lkv = _dist_key_bits(lcols2, rcols2)
    rkb, rkv = _dist_key_bits(rcols2, lcols2)
    alias = table_mod._alias_right_keys(left_s, right_s, config)
    ldat, lval, lslots = table_mod.lane_payload(lcols_s)
    rdat, rval, rslots = table_mod.lane_payload(rcols_s, skip=alias)
    # the plan carries every real column's validity (all-valid ones too),
    # as the JAX package's does; lane columns carry none
    lval = [c.valid_mask() for c in lcols_s] + list(lval[len(lcols_s):])
    rval = [c.valid_mask() for c in rcols_s] + list(rval[len(rcols_s):])
    ldat, rdat = _shards(ldat, v), _shards(rdat, v)
    lval, rval = _shards_opt(lval, v), _shards_opt(rval, v)
    lkb_w, rkb_w = _shards(lkb, v), _shards(rkb, v)
    lkv_w, rkv_w = lkv.view(v, -1), rkv.view(v, -1)
    lemit_w, remit_w = lemit.view(v, -1), remit.view(v, -1)

    jt = config.type
    with _phase("distributed_join.plan", seq):
        route, host, state = _shard_plan(cm, lkb_w, lkv_w, lemit_w, rkb_w,
                                         rkv_w, remit_w, ldat, lval, rdat,
                                         rval, jt)
        if route == "plan":
            _annotate(rows_out=int(host[:, 0].sum()))
    cap, cap_u = _shard_caps(cm, route, host, state, jt)
    with _phase("distributed_join.materialize", seq) if route == "stream" \
            else _span("distributed_join.materialize", seq, world=world,
                       capacity=cap + cap_u):
        res = _shard_materialize(route, state, ldat, lval, rdat, rval, jt,
                                 cap, cap_u)
    # flatten the [W, cap] outputs back to the sharded flat layout
    lod, lov, rod, rov, (emit,), (lidx_o,), (ridx_o,) = (
        [x.reshape(-1) for x in part] for part in (
            res[0], res[1], res[2], res[3], [res[4]], [res[5]], [res[6]]))
    nl = left_d.column_count
    cols = table_mod.rebuild_join_columns(
        lcols_s, lod, lov, lslots, lidx_o, [f"lt-{i}" for i in range(nl)],
        cm)
    cols += table_mod.rebuild_join_columns(
        rcols_s, rod, rov, rslots, ridx_o,
        [f"rt-{nl + j}" for j in range(right_d.column_count)], cm,
        alias=alias, aliased_to=cols)
    result = Table(cols, ctx, emit)
    result._shard_world = world
    if exact_pairs:
        result, collided = _exact_post_verify(result, nl, exact_pairs,
                                              config)
        if collided:
            return _ledger.track(
                _exact_dict_redo(left, right, config, exact_pairs,
                                 force_exchange), "distributed_join")
    # co-partitioning witness: every emitted row sits on the shard its
    # join-key hash routed it to
    if jt in (_join.JoinType.INNER, _join.JoinType.LEFT):
        result._hash_partitioned = shard.partition_signature(
            lcols2, tuple(lidx), world)
    elif jt == _join.JoinType.RIGHT:
        result._hash_partitioned = shard.partition_signature(
            rcols2, tuple(nl + j for j in ridx), world)
    left._free_if_unretained()
    right._free_if_unretained()
    return _ledger.track(result, "distributed_join")


def _exact_post_verify(res: Table, nl: int, pairs, config):
    """Byte verification of exact=True long varbytes keys after the
    exchange: both key columns sit row-aligned in the output, so it is one
    ``equals_rows`` per key pair. INNER joins drop false matches from the
    row mask; outer joins report any collision for the exact redo."""
    emit = res.emit_mask()
    bad = torch.zeros_like(emit)
    for li, rj in pairs:
        a, b = res._columns[li], res._columns[nl + rj]
        both = a.valid_mask() & b.valid_mask()
        bad = bad | (emit & both & ~a.varbytes.equals_rows(b.varbytes))
    if config.type == _join.JoinType.INNER:
        out = Table(res._columns, res._ctx, emit & ~bad)
        out._shard_world = res._shard_world
        return out, False
    collided = bool(bad.any())
    _metrics.record_host_sync("join.exact_verify")
    return res, agree_max(res._ctx.comm, [collided])[0] > 0


def _exact_dict_redo(left: Table, right: Table, config: _join.JoinConfig,
                     pairs, force_exchange: bool) -> Table:
    """Collision recovery for exact outer joins on long varbytes keys:
    each colliding key pair re-encoded over ONE shared sorted vocabulary
    (a host round trip, paid only after a detected collision), the
    distributed join redone on the exact codes, and the redone key
    columns lifted back to varbytes so the schema matches. (A table
    spread over several processes would need one vocabulary over every
    process's keys: not ported.)"""
    ctx = left._ctx
    if ctx.is_multiprocess():
        raise not_ported("the exact join's collision redo across "
                         "processes")
    nl = left.column_count
    lcols2, rcols2 = list(left._columns), list(right._columns)
    for li, rj in pairs:
        lcols2[li], rcols2[rj] = table_mod._dict_encode_pair(
            left._columns[li], right._columns[rj])
    cfg = _join.JoinConfig(config.type, config.left_column_idx,
                           config.right_column_idx, config.algorithm,
                           exact=False)
    l2 = Table(lcols2, ctx, left.row_mask)
    r2 = Table(rcols2, ctx, right.row_mask)
    l2._shard_world, r2._shard_world = left._shard_world, right._shard_world
    res = distributed_join(l2, r2, cfg, force_exchange=force_exchange)
    out_cols = list(res._columns)
    for li, rj in pairs:
        for pos in (li, nl + rj):
            c = out_cols[pos]
            if c.dictionary is not None:
                out_cols[pos] = _dist_as_varbytes(c, ctx.comm)
    out = Table(out_cols, ctx, res.row_mask)
    out._shard_world = res._shard_world
    # the redo is materialized: the unretained originals can go now
    left._free_if_unretained()
    right._free_if_unretained()
    return out


# ---------------------------------------------------------------------------
# the ring join and the broadcast hash join (the JAX package's
# dist_ops.py:1225-1731): the probe (a) side stays where it is; the build
# (b) side either rotates around the ring, one shard's block a step
# (comm.ring_shift), or is replicated to every shard (comm.gather_full).
# Each step, or the one broadcast probe, is the shuffle join's per-shard
# join (`_shard_plan` / `_shard_materialize`), so on the card it runs K3
# and K4.
# ---------------------------------------------------------------------------

# the ring join routes to the shuffle join when its output slab overshoots
# the worst per-shard output by this factor (hot-key skew)
RING_SKEW_FACTOR = 4


def _prep_join_side(t: Table, cols, other_cols, v: int):
    """One join side's per-shard operands, all [V, n]: key bits, combined
    key validity, emit, then the payload data and validity of every
    column with the word lanes of its (short) varbytes columns appended
    (``slots``: column -> (first lane, lane count), for
    `_rebuild_join_side`)."""
    bits, kv = _dist_key_bits(cols, other_cols)
    dat, val, slots = table_mod.lane_payload(t._columns)
    return (_shards(bits, v), kv.view(v, -1),
            t.emit_mask().view(v, -1), _shards(dat, v),
            _shards_opt(val, v), slots)


def _rebuild_join_side(t: Table, od, ov, idx, slots, prefix: str,
                       cm) -> List[Column]:
    """A side's output columns from its materialized [V, cap] tensors and
    row indices (-1: no row): lane columns reassemble from their word
    lanes."""
    return table_mod.rebuild_join_columns(
        t._columns, [x.reshape(-1) for x in od],
        [x.reshape(-1) for x in ov], slots, idx.reshape(-1),
        [f"{prefix}-{i}" for i in range(t.column_count)], cm)


def _join_output(ctx, a_cols: List[Column], b_cols: List[Column],
                 a_left: bool, emit: torch.Tensor) -> Table:
    """The joined table: left columns first, named lt-i / rt-i."""
    cols = a_cols + b_cols if a_left else b_cols + a_cols
    nl = len(a_cols) if a_left else len(b_cols)
    cols = [c.rename(f"lt-{i}" if i < nl else f"rt-{i}")
            for i, c in enumerate(cols)]
    out = Table(cols, ctx, emit.reshape(-1))
    out._shard_world = ctx.get_world_size()
    return out


def _long_varbytes(left: Table, right: Table) -> bool:
    """A varbytes column too wide to ride as word lanes."""
    return any(c.is_varbytes and c.varbytes.max_words > LANE_WORDS_MAX
               for c in left._columns + right._columns)


def _long_exact_keys(left: Table, right: Table, config) -> bool:
    """An exact=True key pair joined on its content hash (wider than
    EXACT_KEY_WORDS), which only the shuffle join byte-verifies."""
    if not config.exact:
        return False
    for li, rj in zip(config.left_column_idx, config.right_column_idx):
        kw = pair_k_words(left._columns[li], right._columns[rj])
        if kw is not None and kw > EXACT_KEY_WORDS:
            return True
    return False


def _ring_plans(cm, a, b, need_matched: bool, stream: bool = True):
    """The ring's count pass: W INNER plans of the resident a side against
    the b side rotated k times (after step k global shard i holds shard
    (i - k) % W's block, ``cm.ring_shift``), every step's counts and the
    unmatched a rows fetched in ONE device->host copy (``ring.count``, the
    JAX package's one count program). Returns (pairs int64 [V, W] = rows
    of (local shard, step), unmatched a rows int64 [V] (0 unless
    ``need_matched``), the matched-a mask [V, na] when ``need_matched``,
    the plans and each step's visiting b payload, and whether a stream
    plan met a hash collision: the caller then runs the pass again with
    ``stream`` False)."""
    abits, akv, aemit, adat, aval = a
    bbits, bkv, bemit, bdat, bval = b
    world = cm.world
    matched = torch.zeros_like(aemit) if need_matched else None
    steps, counts = [], []
    for k in range(world):
        route, cnt, state = _plan_on_device(
            abits, akv, aemit, bbits, bkv, bemit, adat, aval, bdat, bval,
            _join.JoinType.INNER, stream)
        counts.append(cnt.to(torch.int64))
        if need_matched:
            matched |= _shard_matched(route, state)
        steps.append((route, state, bdat, bval))
        if k + 1 < world:
            bbits = tuple(cm.ring_shift(x) for x in bbits)
            bkv, bemit = cm.ring_shift(bkv), cm.ring_shift(bemit)
            bdat = tuple(cm.ring_shift(x) for x in bdat)
            bval = tuple(None if x is None else cm.ring_shift(x)
                         for x in bval)
    extra = (aemit & ~matched).sum(1) if need_matched \
        else torch.zeros(aemit.shape[0], dtype=torch.int64,
                         device=aemit.device)
    hc = torch.cat([torch.stack(counts, 1).reshape(cm.shards, -1),
                    extra.view(-1, 1).to(torch.int64)], 1).cpu().numpy()
    _metrics.record_host_sync("ring.count")
    per_step = hc[:, :-1].reshape(cm.shards, world, -1)
    pairs = per_step[:, :, 0]
    collided = _collided(cm, route, state, per_step)
    return pairs, hc[:, -1], matched, steps, collided


def _ring_slabs(a, steps, matched, cap_step: int, cap_extra: int):
    """The ring's materialize pass: step k's rows at slab offset ``k *
    cap_step``, then the unmatched a rows (``cap_extra``). Returns
    (a data, a validity, b data, b validity, emit, a idx, b idx), each
    [W, world * cap_step + cap_extra]."""
    _abits, _akv, aemit, adat, aval = a
    parts = [_shard_materialize(route, state, adat, aval, bdat, bval,
                                _join.JoinType.INNER, cap_step)
             for route, state, bdat, bval in steps]
    if cap_extra:
        un = _join._masked_indices(aemit & ~matched, cap_extra)
        hole = torch.full_like(un, -1)
        parts.append(_join.gather_columns(adat, aval, un)
                     + _join.gather_columns(steps[0][2], steps[0][3], hole)
                     + (un >= 0, un, hole))
    cols = [tuple(torch.cat(c, 1) for c in zip(*(p[i] for p in parts)))
            for i in range(4)]
    return (*cols, *(torch.cat([p[i] for p in parts], 1)
                     for i in (4, 5, 6)))


def distributed_join_ring(left: Table, right: Table,
                          config: _join.JoinConfig) -> Table:
    """Streaming ring join (the JAX package's dist_ops.py:1406; the
    reference's ArrowJoin): INNER, LEFT and RIGHT. The probe side (left;
    right for RIGHT) stays resident and the other side rotates around the
    ring, each step joined per shard. FULL_OUTER, world 1, varbytes wider
    than LANE_WORDS_MAX and exact keys wider than EXACT_KEY_WORDS take the
    shuffle join, as does a hot key whose step slab would overshoot the
    worst shard's output by RING_SKEW_FACTOR, or a slab past the memory
    pool's comm budget. The count pass keeps each step's plan (K3's
    output on the card) for the materialize pass."""
    ctx = left._ctx
    cm = ctx.comm
    world = cm.world
    jt = config.type
    if world == 1 or jt == _join.JoinType.FULL_OUTER \
            or _long_varbytes(left, right) \
            or _long_exact_keys(left, right, config):
        return distributed_join(left, right, config)
    left_d = shard.distribute(left, ctx)
    right_d = shard.distribute(right, ctx)
    lcols, rcols = _align_key_columns_dist(
        left_d, right_d, config.left_column_idx, config.right_column_idx,
        cm)
    if jt == _join.JoinType.RIGHT:
        a_t, a_cols, b_t, b_cols = right_d, rcols, left_d, lcols
    else:
        a_t, a_cols, b_t, b_cols = left_d, lcols, right_d, rcols
    *a, a_slots = _prep_join_side(a_t, a_cols, b_cols, cm.shards)
    *b, b_slots = _prep_join_side(b_t, b_cols, a_cols, cm.shards)

    emit_unmatched = jt != _join.JoinType.INNER
    seq = ctx.get_next_sequence()
    with _phase("ring_join.count", seq):
        pairs, extra, matched, steps, collided = _ring_plans(
            cm, a, b, emit_unmatched)
        if collided:
            # a 64-bit hash collision: every step again on the exact
            # plan route
            pairs, extra, matched, steps, _ = _ring_plans(
                cm, a, b, emit_unmatched, stream=False)
    # skew guard: every shard's slab is world * cap_step rows, cap_step
    # set by the worst (shard, step) block of any process; with an
    # absolute floor, so that sparse outputs stay on the ring
    worst_pair, extra, worst_total = agree_max(
        cm, [pairs.max(), extra.max(), pairs.sum(axis=1).max()])
    cap_step = _bucket_cap(worst_pair)
    cap_extra = _bucket_cap(extra) if emit_unmatched else 0
    slab = world * cap_step
    budget = ctx.comm_budget_bytes()
    row_bytes = sum(c.data.element_size() + 1
                    + (5 * c.varbytes.max_words if c.is_varbytes else 0)
                    for c in a_t._columns + b_t._columns)
    over_budget = bool(budget) and slab * row_bytes > budget
    skewed = slab > (1 << 16) and \
        slab > RING_SKEW_FACTOR * _capacity(max(worst_total, 1))
    if skewed or over_budget:
        return distributed_join(left, right, config)

    _counter("cylon_join_algorithm_total", {"algo": "ring"}).inc()
    with _phase("ring_join.materialize", seq):
        aod, aov, bod, bov, emit, aidx, bidx = _ring_slabs(
            a, steps, matched, cap_step, cap_extra)
    a_out = _rebuild_join_side(a_t, aod, aov, aidx, a_slots, "a", cm)
    b_out = _rebuild_join_side(b_t, bod, bov, bidx, b_slots, "b", cm)
    result = _join_output(ctx, a_out, b_out, jt != _join.JoinType.RIGHT,
                          emit)
    left._free_if_unretained()
    right._free_if_unretained()
    return _ledger.track(result, "distributed_join_ring")


# build sides a broadcast join may replicate, per join type: the probe
# must cover every row the join can emit unmatched (the JAX package's
# runtime gate, dist_ops.py:1605; its planner and verifier keep their
# own copies)
_BCAST_LEGAL_SIDES = {_join.JoinType.INNER: (0, 1),
                      _join.JoinType.LEFT: (1,),
                      _join.JoinType.RIGHT: (0,)}


def _broadcast_eligible(left: Table, right: Table,
                        config: _join.JoinConfig,
                        build_side: int) -> Optional[str]:
    """None when the broadcast join can run this join, else the reason it
    takes the shuffle join."""
    jt = config.type
    if build_side not in _BCAST_LEGAL_SIDES.get(jt, ()):
        return f"build_side={build_side} not replicable under {jt.name}"
    if _long_varbytes(left, right):
        return "long varbytes payload cannot ride fixed word lanes"
    if _long_exact_keys(left, right, config):
        return "exact long varbytes keys need post-verification"
    return None


def broadcast_hash_join(left: Table, right: Table,
                        config: _join.JoinConfig,
                        build_side: int = 1) -> Table:
    """Replicate ``build_side`` (0 = left, 1 = right) to every shard and
    probe each shard's resident rows against the whole build table (the
    JAX package's dist_ops.py:1635): no exchange. INNER may replicate
    either side, LEFT only its right input, RIGHT only its left;
    ineligible joins take the shuffle join. The output keeps the probe
    side's placement witness (its positions shifted past the build
    columns when the probe is the right table)."""
    ctx = left._ctx
    cm = ctx.comm
    if cm.world == 1:
        # one shard replicates nothing: the local join is the broadcast
        _counter("cylon_join_algorithm_total", {"algo": "local"}).inc()
        return _ledger.track(table_mod.join(left, right, config),
                             "distributed_join")
    reason = _broadcast_eligible(left, right, config, build_side)
    if reason is not None:
        _annotate(join_algorithm="shuffle", broadcast_fallback=reason)
        return distributed_join(left, right, config)
    _counter("cylon_join_algorithm_total", {"algo": "broadcast"}).inc()
    left_d = shard.distribute(left, ctx)
    right_d = shard.distribute(right, ctx)
    lcols, rcols = _align_key_columns_dist(
        left_d, right_d, config.left_column_idx, config.right_column_idx,
        cm)
    if build_side == 1:
        a_t, a_cols, b_t, b_cols = left_d, lcols, right_d, rcols
    else:
        a_t, a_cols, b_t, b_cols = right_d, rcols, left_d, lcols
    # the probe is always the a side: LEFT and RIGHT both run the local
    # LEFT plan (unmatched probe rows emitted)
    jt_local = _join.JoinType.INNER \
        if config.type == _join.JoinType.INNER else _join.JoinType.LEFT
    abits, akv, aemit, adat, aval, a_slots = _prep_join_side(
        a_t, a_cols, b_cols, cm.shards)
    bbits, bkv, bemit, bdat, bval, b_slots = _prep_join_side(
        b_t, b_cols, a_cols, cm.shards)

    def full(x):
        return None if x is None else cm.gather_full(x)

    seq = ctx.get_next_sequence()
    world = cm.world
    with _span("broadcast_join.plan", seq, world=world,
               rows_in=a_t.capacity + b_t.capacity,
               build_rows=b_t.capacity, build_bytes=int(b_t.nbytes)):
        bdat_f = tuple(full(x) for x in bdat)
        bval_f = tuple(full(x) for x in bval)
        route, host, state = _shard_plan(
            cm, abits, akv, aemit, tuple(full(x) for x in bbits), full(bkv),
            full(bemit), adat, aval, bdat_f, bval_f, jt_local)
        _annotate(rows_out=int(host[:, 0].sum()))
    cap, cap_u = _shard_caps(cm, route, host, state, jt_local)
    with _span("broadcast_join.materialize", seq, world=world,
               capacity=cap):
        aod, aov, bod, bov, emit, aidx, bidx = _shard_materialize(
            route, state, adat, aval, bdat_f, bval_f, jt_local, cap, cap_u)
    a_out = _rebuild_join_side(a_t, aod, aov, aidx, a_slots, "a", cm)
    b_out = _rebuild_join_side(b_t, bod, bov, bidx, b_slots, "b", cm)
    out = _join_output(ctx, a_out, b_out, build_side == 1, emit)
    sig = a_t._hash_partitioned
    if sig is not None:
        pos, dts, w = sig
        if build_side == 0:
            pos = tuple(b_t.column_count + int(p) for p in pos)
        # the probe's witness, dtypes spelled as partition_signature
        # spells them (numpy names)
        out._hash_partitioned = (tuple(int(p) for p in pos), tuple(dts),
                                 int(w))
    left._free_if_unretained()
    right._free_if_unretained()
    return _ledger.track(out, "distributed_join")


# ---------------------------------------------------------------------------
# distributed set ops (reference: DistributedUnion/Subtract/Intersect,
# table.cpp:948-1010 — ShuffleTwoTables on ALL columns + local set op)
# ---------------------------------------------------------------------------


def _concat_shards(a, b, v: int) -> VarBytes:
    """Per shard, [a's rows; b's rows] as one sharded VarBytes: the word
    segments concatenate and b's starts shift by a's segment (the range
    sums ignore the gaps, so nothing is repacked)."""
    wa = a.words.view(v, -1)
    ca = wa.shape[1]
    starts = torch.cat([a.starts.view(v, -1).to(torch.int64),
                        b.starts.view(v, -1).to(torch.int64) + ca], 1)
    words = torch.cat([wa, b.words.view(v, -1)], 1)
    lens = torch.cat([a.lengths.view(v, -1),
                      b.lengths.view(v, -1)], 1)
    return VarBytes(words.reshape(-1), starts.reshape(-1).to(torch.int32),
                    lens.reshape(-1), max(a.max_words, b.max_words),
                    int(words.numel()),
                    shard_geom=(lens.shape[1], words.shape[1]))


def distributed_set_op(left: Table, right: Table, op: _setops.SetOp,
                       force_exchange: bool = False) -> Table:
    """Both tables shuffle on all their columns, then every shard runs
    the dense-ranks set op (as the JAX package does: its per-shard set op
    has no kernel). ``force_exchange`` runs the full composition even on
    a one-shard world. The result stays sharded, in the JAX package's
    per-shard row order."""
    ctx = left._ctx
    world = ctx.get_world_size()
    if world == 1 and not (force_exchange and ctx.is_distributed()):
        # reference parity: world 1 short-circuits to the local set op
        return _ledger.track(table_mod.set_op(left, right, op),
                             "distributed_set_op")
    if left.column_count != right.column_count:
        raise CylonError(Code.Invalid, "set ops need equal schemas")
    cm = ctx.comm
    v = cm.shards
    left_d = shard.distribute(left, ctx)
    right_d = shard.distribute(right, ctx)
    idx = list(range(left_d.column_count))
    lcols, rcols = _align_key_columns_dist(left_d, right_d, idx, idx, cm)
    has_validity = [a.validity is not None or b.validity is not None
                    for a, b in zip(lcols, rcols)]

    seq = ctx.get_next_sequence()
    with _span("distributed_set_op.shuffle", seq, world=world,
               rows_in=left_d.capacity + right_d.capacity, op=str(op)):
        # exchange only the aligned columns; the row keys are recomputed
        # per shard from the shuffled columns. Both counts in one host
        # fetch.
        sides = [(Table(list(cols), ctx, t.row_mask),
                  _partition_targets_dist(world, cols, other), t.emit_mask())
                 for cols, other, t in ((lcols, rcols, left_d),
                                        (rcols, lcols, right_d))]
        dense = (world == 1 and left_d.row_mask is None
                 and right_d.row_mask is None)
        cl = cr = None
        if not dense:
            cl, cr = count_pair(sides[0][1], sides[0][2], sides[1][1],
                                sides[1][2], ctx)
        (lcols_s, lemit), (rcols_s, remit) = (
            _exchange_table(view, targets, emit, ctx, counts=cnt,
                            dense=dense)[:2]
            for (view, targets, emit), cnt in zip(sides, (cl, cr)))

    def rebits(cols, other):
        # key bits (nulls at the all-ones end for plain columns, word
        # lanes or content hashes for varbytes) plus the validity byte:
        # validity is part of the row key, so nulls compare equal
        bits = []
        for ci, c in enumerate(cols):
            bits.extend(_dist_col_bits(c, pair_k_words(c, other[ci])))
            if has_validity[ci]:
                bits.append(c.valid_mask().to(torch.uint8))
        return _shards(bits, v)

    lemit_w, remit_w = lemit.view(v, -1), remit.view(v, -1)
    with _phase("distributed_set_op.count", seq):
        gl, gr = _order.dense_ranks_two(rebits(lcols_s, rcols_s),
                                        rebits(rcols_s, lcols_s))
        counts = torch.stack(list(_setops.setop_counts(
            gl, gr, lemit_w, remit_w).values()), 1).cpu().numpy()
        _metrics.record_host_sync("setop.count")
    cap = _bucket_cap(agree_max(cm, [counts[:, int(op)].max()])[0])
    with _phase("distributed_set_op.materialize", seq):
        idx = _setops.setop_indices(gl, gr, lemit_w, remit_w, op, cap)
        # indices address the per-shard concatenation [left; right]
        dat = [torch.cat([a, b], 1) for a, b in zip(
            _shards((c.data for c in lcols_s), v),
            _shards((c.data for c in rcols_s), v))]
        val = [torch.cat([a, b], 1) for a, b in zip(
            _shards((c.valid_mask() for c in lcols_s), v),
            _shards((c.valid_mask() for c in rcols_s), v))]
        od, ov = _join.gather_columns(dat, val, idx)
    cols = _rebuild_columns([d.reshape(-1) for d in od],
                            [v.reshape(-1) for v in ov], lcols_s,
                            [c.name for c in lcols_s])
    flat_idx = idx.reshape(-1)
    for ci, (a, b) in enumerate(zip(lcols_s, rcols_s)):
        if a.is_varbytes:
            vb = varlen_take_sharded(
                _concat_shards(a.varbytes, b.varbytes, v), flat_idx, cm)
            cols[ci] = Column(vb.lengths, a.dtype, cols[ci].validity,
                              a.name, varbytes=vb)
    result = Table(cols, ctx, (idx >= 0).reshape(-1))
    result._shard_world = world
    return _ledger.track(result, "distributed_set_op")


# ---------------------------------------------------------------------------
# hash_partition / repartition (reference: HashPartition, table.cpp:102-160)
# ---------------------------------------------------------------------------


def hash_partition(table: Table, hash_columns: Sequence,
                   num_partitions: int) -> Dict[int, Table]:
    """Split a table into ``{partition: Table}`` by key hash: one stable
    sort by target (dead rows last), then each partition is one slice of
    every column, on the device; short varbytes columns ride the sort as
    word lanes. A table with varbytes rows longer than LANE_WORDS_MAX
    words takes the host partitioner (the same placement). The split is
    local, as the reference's HashPartition is per rank: a table spread
    over several processes splits the rows this process holds, and no
    collective follows, so nothing needs agreeing."""
    idxs = [table._col_index(c) for c in hash_columns]
    if any(c.is_varbytes and c.varbytes.max_words > LANE_WORDS_MAX
           for c in table._columns):
        return _hash_partition_host(table, idxs, num_partitions)
    ctx = table._ctx
    targets = _hash.partition_targets([table._columns[i] for i in idxs],
                                      num_partitions)
    tkey = torch.where(table.emit_mask(), targets, num_partitions)
    perm = torch.sort(tkey, stable=True).indices
    counts = torch.bincount(tkey.to(torch.int64),
                            minlength=num_partitions + 1).cpu().numpy()
    _metrics.record_host_sync("hash_partition.counts")
    offs = np.concatenate([[0], np.cumsum(counts[:num_partitions])])

    def take(x):
        return movable(x)[perm].view(x.dtype)

    sorted_cols = []
    for c in table._columns:
        lanes = [take(l) for l in c.varbytes.word_lanes()] \
            if c.is_varbytes else None
        sorted_cols.append((c, take(c.data), None if c.validity is None
                            else c.validity[perm], lanes))
    out = {}
    for p in range(num_partitions):
        lo, hi = int(offs[p]), int(offs[p + 1])
        cols = []
        for c, d, v, lanes in sorted_cols:
            v = None if v is None else v[lo:hi]
            if lanes is None:
                cols.append(Column(d[lo:hi], c.dtype, v, c.name,
                                   dictionary=c.dictionary))
            else:
                vb = VarBytes.from_lanes([l[lo:hi] for l in lanes],
                                         d[lo:hi])
                cols.append(Column(vb.lengths, c.dtype, v, c.name,
                                   varbytes=vb))
        out[p] = Table(cols, ctx)
    return out


def _hash_partition_host(table: Table, idxs, num_partitions: int) -> dict:
    """The host partitioner of long varbytes rows: the key columns hash
    on the host exactly as on the device (varbytes through
    ``native.np_varbytes_hash``, the content hash h1;
    `shard.host_partition_arrays`)."""
    t = table._compact_rows()
    dev = t._ctx.device
    host, valids, _counts, order, offs = shard.host_partition_arrays(
        t, idxs, num_partitions)
    out = {}
    for p in range(num_partitions):
        seg = order[offs[p]:offs[p + 1]]
        cols = []
        for ci, c in enumerate(t._columns):
            v = None if valids[ci] is None \
                else torch.from_numpy(valids[ci][seg]).to(dev)
            if c.is_varbytes:
                vb = VarBytes.from_host(host[ci][seg], device=dev)
                cols.append(Column(vb.lengths, c.dtype, v, c.name,
                                   varbytes=vb))
            else:
                cols.append(Column(torch.from_numpy(np.ascontiguousarray(
                    host[ci][seg])).to(dev), c.dtype, v, c.name,
                    dictionary=c.dictionary))
        out[p] = Table(cols, t._ctx)
    return out


def repartition(table: Table, ctx: CylonContext) -> Table:
    """Round-robin rows over the shards (no key): row i of the global
    flat layout goes to shard i % world (this process's rows start at
    its rank times its capacity)."""
    t = shard.distribute(table, ctx)
    world = ctx.get_world_size()
    first = ctx.get_process_rank() * t.capacity
    targets = ((torch.arange(t.capacity, device=ctx.device) + first)
               % world).to(torch.int32)
    cols, new_emit, _ = _exchange_table(t, targets, t.emit_mask(), ctx,
                                        dense=t.row_mask is None)
    result = Table(cols, ctx, new_emit)
    result._shard_world = world
    return _ledger.track(result, "repartition")


# ---------------------------------------------------------------------------
# distributed groupby (reference: GroupBy, groupby/groupby.cpp:96-139):
# per-shard partial aggregates, their exchange by key hash, and a merge
# with the second-phase ops (COUNT partials summed, MEAN as SUM + COUNT)
# ---------------------------------------------------------------------------


def _shard_groupby(nloc: int, kbits, kdat, kval, emit, vdat, vval,
                   ops, col_ids, all_valid):
    """The per-shard group-by over ``[nloc, n]`` views of this process's
    nloc shards, every shard in one batched call (the JAX package's
    ``_groupby_fn`` under ``shard_map``): group slots per shard = the
    shard capacity n. Returns flat ``[nloc * n]`` key data, key validity,
    group validity, aggregates, and the representative row of each
    group slot (shard-local)."""
    n = emit.shape[0] // nloc
    keys = [b.view(nloc, n) for b in kbits] \
        + [v.view(nloc, n).to(torch.uint8) for v in kval]
    vdat_s, vval_s, emit_s, iota_s, gid_s, _ng = _groupby.presort_groups(
        keys, emit.view(nloc, n), [d.view(nloc, n) for d in vdat],
        [None if v is None else v.view(nloc, n) for v in vval])
    rep, gvalid, results = _groupby.sorted_segment_aggregate(
        gid_s, emit_s, iota_s, vdat_s, vval_s, n, ops, col_ids, all_valid)
    safe = torch.clamp(rep, max=n - 1)

    def take(x):
        return movable(x.view(nloc, n)).gather(1, safe).view(
            x.dtype).reshape(-1)

    kout = [take(d) for d in kdat]
    kvout = [take(v) & gvalid.reshape(-1) for v in kval]
    agg = [(arr.reshape(-1), (av & gvalid).reshape(-1))
           for arr, av in results]
    return kout, kvout, gvalid.reshape(-1), agg, safe.reshape(-1)


def _group_bits(cols: Sequence[Column]) -> list:
    """Group keys of key columns (validity bytes are added per shard)."""
    return [b for c in cols for b in _dist_col_bits(c)]


def _key_columns_out(cm, kcols, kout, kvout, safe) -> List[Column]:
    """Group key columns from the per-shard group-by: varbytes keys
    gather their representatives' bytes per shard."""
    out = []
    for d, v, kc in zip(kout, kvout, kcols):
        if kc.is_varbytes:
            vb = varlen_take_sharded(kc.varbytes, safe, cm)
            out.append(Column(vb.lengths, kc.dtype, v, kc.name, varbytes=vb))
        else:
            out.append(Column(d, kc.dtype, v, kc.name,
                              dictionary=kc.dictionary))
    return out


def _groupby_shuffle_agg(ctx: CylonContext, key_columns, value_columns,
                         ops, emit, seq, col_ids=None, dense: bool = False,
                         skip_exchange: bool = False):
    """Shuffle rows by key hash (unless ``skip_exchange``: the caller
    asserts each key's rows already sit on one shard), then aggregate per
    shard. Returns (key columns, [(agg, valid)], group validity)."""
    world = ctx.get_world_size()
    cm = ctx.comm
    if skip_exchange:
        out_cols, emit_s = list(key_columns) + list(value_columns), emit
        _annotate(exchange_skipped=True)
    else:
        with _span("distributed_groupby.shuffle", seq, world=world,
                   rows_in=int(emit.shape[0])):
            view = Table(list(key_columns) + list(value_columns), ctx, None)
            targets = _partition_targets_dist(world, key_columns)
            out_cols, emit_s, _ = _exchange_table(view, targets, emit, ctx,
                                                  dense=dense)
    nk = len(key_columns)
    kcols_s, vcols_s = out_cols[:nk], out_cols[nk:]
    if col_ids is None:
        col_ids = tuple(range(len(vcols_s)))
    with _phase("distributed_groupby.aggregate", seq):
        kout, kvout, gvalid, agg, safe = _shard_groupby(
            cm.shards, _group_bits(kcols_s), [c.data for c in kcols_s],
            [c.valid_mask() for c in kcols_s], emit_s,
            [c.data for c in vcols_s], [c.validity for c in vcols_s], ops,
            col_ids, [c.validity is None for c in vcols_s])
    return _key_columns_out(cm, kcols_s, kout, kvout, safe), agg, gvalid


def _groupby_table(ctx, key_out, cols, gvalid) -> Table:
    """The distributed groupby's result: sharded, its groups placed by
    key hash (the witness lets a later same-key stage skip its
    exchange)."""
    world = ctx.get_world_size()
    out = Table(list(key_out) + cols, ctx, gvalid)
    out._shard_world = world
    out._hash_partitioned = shard.partition_signature(
        key_out, tuple(range(len(key_out))), world)
    return _ledger.track(out, "distributed_groupby")


def distributed_groupby(table: Table, index_col, aggregate_cols: List,
                        aggregate_ops: List[_groupby.AggregationOp],
                        pre_aggregate: bool = True,
                        pre_partitioned: bool = False) -> Table:
    """Phase A aggregates each shard's rows into partials (MEAN as a
    float64 SUM and a COUNT), phase B exchanges the partials by key hash
    and merges them with the second-phase ops. ``pre_aggregate=False``
    exchanges the rows and aggregates once; ``pre_partitioned=True``
    asserts the rows are already hash-placed by these keys and runs one
    per-shard pass with no exchange. A one-shard world runs the local
    groupby."""
    ctx = table._ctx
    world = ctx.get_world_size()
    # op names ("sum", ...) as Table.groupby takes them
    aggregate_ops = [table_mod._as_agg_op(o) for o in aggregate_ops]
    if world == 1:
        return _ledger.track(
            table_mod.groupby_local(table, index_col, aggregate_cols,
                                    aggregate_ops), "distributed_groupby")
    t = shard.distribute(table, ctx)
    idx_cols = index_col if isinstance(index_col, (list, tuple)) \
        else [index_col]
    idx_cols = [t._col_index(c) for c in idx_cols]
    val_cols = [t._col_index(c) for c in aggregate_cols]
    key_columns = [t._columns[i] for i in idx_cols]
    ops = list(aggregate_ops)
    table_mod._check_string_values([t._columns[i] for i in val_cols], ops)
    seq = ctx.get_next_sequence()
    emit = t.emit_mask()
    MEAN = _groupby.AggregationOp.MEAN
    SUM = _groupby.AggregationOp.SUM
    COUNT = _groupby.AggregationOp.COUNT

    if pre_partitioned or not pre_aggregate:
        key_out, agg, gvalid = _groupby_shuffle_agg(
            ctx, key_columns, [t._columns[vi] for vi in val_cols],
            tuple(ops), emit, seq, col_ids=tuple(val_cols),
            dense=t.row_mask is None, skip_exchange=pre_partitioned)
        cols = [table_mod._agg_column(arr, av, t._columns[vi], op)
                for (arr, av), vi, op in zip(agg, val_cols, ops)]
        return _groupby_table(ctx, key_out, cols, gvalid)

    # phase A: per-shard partials; MEAN expands to (f64 SUM, COUNT)
    a_entries = []   # (original position, phase-A op, cast to f64)
    b_ops = []
    out_map = []     # ("d", a index) or ("mean", sum index, count index)
    for j, op in enumerate(ops):
        if op == MEAN:
            out_map.append(("mean", len(a_entries), len(a_entries) + 1))
            a_entries += [(j, SUM, True), (j, COUNT, False)]
            b_ops += [SUM, SUM]
        else:
            out_map.append(("d", len(a_entries)))
            a_entries.append((j, op, False))
            b_ops.append(_groupby.second_phase_op(op))
    srcs = [t._columns[val_cols[j]] for j, _op, _c in a_entries]
    with _phase("distributed_groupby.pre_aggregate", seq):
        koutA, kvoutA, gvalidA, aggA, safeA = _shard_groupby(
            ctx.local_shard_count(), _group_bits(key_columns),
            [c.data for c in key_columns],
            [c.valid_mask() for c in key_columns], emit,
            [src.data.to(torch.float64) if cast else src.data  # cylint: disable=collectives/f64-promotion — MEAN's partial sums are float64, as the JAX package's
             for src, (_j, _op, cast) in zip(srcs, a_entries)],
            [src.validity for src in srcs],
            tuple(op for _j, op, _c in a_entries),
            tuple((val_cols[j], cast) for j, _op, cast in a_entries),
            [src.validity is None for src in srcs])
    pkey_cols = _key_columns_out(ctx.comm, key_columns, koutA, kvoutA,
                                 safeA)
    pval_cols = [Column(arr, dtypes.Double(), av, src.name) if cast
                 else table_mod._agg_column(arr, av, src, opA)
                 for (arr, av), src, (_j, opA, cast)
                 in zip(aggA, srcs, a_entries)]

    # phase B: exchange the partials, merge with the second-phase ops
    key_out, aggB, gvalid = _groupby_shuffle_agg(
        ctx, pkey_cols, pval_cols, tuple(b_ops), gvalidA, seq)
    cols = []
    for op, vi, m in zip(ops, val_cols, out_map):
        src = t._columns[vi]
        if m[0] == "mean":
            s_arr, s_av = aggB[m[1]]
            c_arr, c_av = aggB[m[2]]
            data = s_arr / torch.clamp(c_arr.to(torch.float64), min=1)  # cylint: disable=collectives/f64-promotion — the mean of float64 partial sums, as the JAX package's
            cols.append(Column(data, table_mod._agg_dtype(src, op),
                               s_av & c_av & (c_arr > 0), src.name))
        else:
            arr, av = aggB[m[1]]
            cols.append(table_mod._agg_column(arr, av, src, op))
    return _groupby_table(ctx, key_out, cols, gvalid)


# ---------------------------------------------------------------------------
# distributed sort: sample the key lanes, agree range splitters, range-
# partition through the exchange the joins use, then sort each shard
# ---------------------------------------------------------------------------

# per-shard sample count for splitter estimation (total = world * this)
SORT_SAMPLES_PER_SHARD = 4096


def _range_splitters(ctx: CylonContext, lanes: Sequence[torch.Tensor],
                     emit: torch.Tensor) -> list:
    """world - 1 splitter tuples: the lexicographic quantiles of a
    sample of the live rows' key lanes, as unsigned numpy scalars. The
    sample positions come from the JAX package's generator and seed, so
    the splitters match its own on the same layout. They are drawn over
    the GLOBAL flat layout (every process's ``V * cap`` rows, in rank
    order); each process reads the positions it holds and the samples
    are gathered in global order, so every process, and the virtual
    world, gets the same splitters bit for bit."""
    cm = ctx.comm
    world = cm.world
    n_local = int(lanes[0].shape[0])
    n = n_local * cm.nproc
    rng = np.random.default_rng(0xC11)
    k = min(n, SORT_SAMPLES_PER_SHARD * world)
    gpos = np.sort(rng.integers(0, n, k))
    # every process knows every process's share of the positions
    cuts = np.searchsorted(gpos, np.arange(cm.nproc + 1) * n_local)
    mine = gpos[cuts[cm.rank]:cuts[cm.rank + 1]] - cm.rank * n_local
    pos = torch.from_numpy(mine).to(emit.device)
    # one device->host copy: every lane's unsigned value as int64 (8-byte
    # lanes keep their bits), then the emit flag
    packed = torch.stack([l[pos].to(torch.int64)
                          if l.element_size() == 8
                          else _order.unsigned(l[pos]) for l in lanes]
                         + [emit[pos].to(torch.int64)]).cpu().numpy()
    _metrics.record_host_sync("sort.splitters")
    if cm.nproc > 1:
        width = int(np.diff(cuts).max())
        padded = np.zeros((packed.shape[0], width), np.int64)
        padded[:, :packed.shape[1]] = packed
        every = cm.all_gather_host(padded)
        packed = np.concatenate([every[p][:, :cuts[p + 1] - cuts[p]]
                                 for p in range(cm.nproc)], 1)
    live = packed[-1].astype(bool)
    samples = [packed[i].view(np.uint64)[live].astype(
        np.dtype(f"u{l.element_size()}")) for i, l in enumerate(lanes)]
    if samples[0].size == 0:
        return [tuple(s.dtype.type(0) for s in samples)] * (world - 1)
    order = np.lexsort(tuple(reversed(samples)))
    q = (np.arange(1, world) * samples[0].size) // world
    return [tuple(s[order[qi]] for s in samples) for qi in q]


def _sortable_scalar(v: np.generic) -> int:
    """An unsigned splitter value in `order.sortable`'s int64 space."""
    if v.dtype.itemsize == 8:
        return int(np.array(v).view(np.int64)) ^ _order._I64_MIN
    return int(v)


def _splitter_targets(lanes: Sequence[torch.Tensor],
                      splitters) -> torch.Tensor:
    """target = the number of splitter tuples lexicographically <= the
    row's key tuple. Lanes compare unsigned (`order.sortable`): the
    port's bits ride in signed containers, and a signed compare would
    send every key with the top bit set to the wrong shard."""
    keys = [_order.sortable(l) for l in lanes]
    n = keys[0].shape[0]
    targets = torch.zeros(n, dtype=torch.int32, device=keys[0].device)
    for tup in splitters:
        ge = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
        eq = torch.ones(n, dtype=torch.bool, device=keys[0].device)
        for key, sv in zip(keys, tup):
            v = _sortable_scalar(sv)
            ge |= eq & (key > v)
            eq &= key == v
        targets += (ge | eq).to(torch.int32)
    return targets


def _shard_sort(nloc: int, bits, emit, dat, val):
    """Each shard's rows stably sorted by (dead last, key lanes...), this
    process's nloc shards in one batched sort: sorted data, validity and
    emit, flat, and the flat shard-local permutation."""
    n = emit.shape[0] // nloc
    emit_w = emit.view(nloc, n)
    perm = _order.lexsort_indices([(~emit_w).to(torch.uint8)]
                                  + [b.view(nloc, n) for b in bits])

    def take(x):
        return movable(x.view(nloc, n)).gather(1, perm).view(
            x.dtype).reshape(-1)

    return ([take(d) for d in dat], [take(v) for v in val],
            take(emit), perm.reshape(-1))


def _dist_order_lanes(c: Column, a: bool):
    """Lanes whose lexicographic (unsigned) tuple order is column c's
    sort order (ascending ``a``, nulls last), or None for varbytes rows
    past the device prefix bound (the host sort)."""
    if not c.is_varbytes:
        return list(_order.sort_keys([c], [a]))
    return table_mod._sort_keys_mixed([c], [a])


def distributed_sort(table: Table, order_by, ascending=True,
                     force_exchange: bool = False) -> Table:
    """Splitter-based distributed sort: sample the key lanes, agree
    world - 1 range splitters, range-partition through the exchange,
    then sort every shard. Shard i's rows all precede shard i+1's, so the
    global order is (shard, position); nulls last. Varbytes keys sort on
    big-endian prefix words + length; rows past SORT_PREFIX_WORDS words
    take the host sort, then redistribute. ``force_exchange`` runs the
    whole composition on a one-shard world too. (The JAX package
    memoizes the splitters per source column; the port samples on every
    call.)"""
    ctx = table._ctx
    cm = ctx.comm
    t = shard.distribute(table, ctx) if ctx.is_distributed() else table
    by = order_by if isinstance(order_by, (list, tuple)) else [order_by]
    idxs = [t._col_index(c) for c in by]
    asc = list(ascending) if isinstance(ascending, (list, tuple)) \
        else [ascending] * len(idxs)
    world = ctx.get_world_size()
    if not (ctx.is_distributed() and (world > 1 or force_exchange)):
        return t.sort(by, ascending)
    per_col = [_dist_order_lanes(t._columns[i], a)
               for i, a in zip(idxs, asc)]
    if any(l is None for l in per_col):
        if ctx.is_multiprocess():
            raise not_ported("the host sort of varbytes keys past "
                             "SORT_PREFIX_WORDS words across processes")
        return shard.distribute(t.compact().sort(by, ascending), ctx)
    lanes = [l for col_lanes in per_col for l in col_lanes]
    seq = ctx.get_next_sequence()
    with _span("distributed_sort.partition", seq, world=world,
               rows_in=t.capacity):
        emit = t.emit_mask()
        splitters = _range_splitters(ctx, lanes, emit)
        targets = _splitter_targets(lanes, splitters)
        cols_s, emit_s, _ = _exchange_table(t, targets, emit, ctx,
                                            dense=t.row_mask is None)
    with _phase("distributed_sort.local", seq):
        # key lanes recomputed from the shuffled columns: they never
        # cross the exchange
        sbits = [l for i, a in zip(idxs, asc)
                 for l in _dist_order_lanes(cols_s[i], a)]
        sdat, sval, semit, perm = _shard_sort(
            cm.shards, sbits, emit_s, [c.data for c in cols_s],
            [c.valid_mask() for c in cols_s])
    cols = _rebuild_columns(sdat, sval, cols_s, [c.name for c in cols_s])
    for ci, c in enumerate(cols_s):
        if c.is_varbytes:
            vb = varlen_take_sharded(c.varbytes, perm, cm)
            cols[ci] = Column(vb.lengths, c.dtype, sval[ci], c.name,
                              varbytes=vb)
    out = Table(cols, ctx, semit)
    out._shard_world = world
    return _ledger.track(out, "distributed_sort")
