"""Local join — sort-merge join with static shapes (counterpart of
cylon_tpu.ops.join).

Every function here works on tensors with a leading SHARD dimension,
``[W, n]``: the local join passes W = 1, the distributed join runs all W
shards of the virtual world in one call. Two routes, as in the JAX
package:

* the plan route (``join_plan_keys`` + ``JoinPlan.materialize``): one
  fused sort of the concatenated key bits with the packed tag
  ``side<<31 | live<<29 | iota``, then scans, scatters and gathers —
  plain PyTorch, the counterpart of the JAX package's XLA plan;
* the stream route (``plan_program_stream`` + ``JoinPlan.materialize``):
  the same sort, then the plan kernel K3 and the expansion kernel K4 of
  ops/kernels.py.

The local join and every per-shard join of parallel/dist_ops.py take
their route and plan from one planner at the end of this module
(``join_route``, ``plan_join``, ``JoinPlan``).

``jax.lax.sort`` with several keys becomes one stable ``torch.sort`` of a
packed int64 key ``((bits << 32) | tag) ^ (1 << 63)`` where one 32-bit
key and the tag fit, and stable sorts from the least significant key up
elsewhere; payload rides as a gather by the permutation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
from typing import Optional, Tuple

import torch

from ..dtypes import movable
from ..util import bucket_cap
from . import kernels as _k
from .hash import as_i32
from .order import all_ones, lexsort_indices, ordered_bits_raw, unsigned


class JoinType(enum.IntEnum):
    """Reference: join/join_config.hpp:22 `JoinType`."""

    INNER = 0
    LEFT = 1
    RIGHT = 2
    FULL_OUTER = 3


class JoinAlgorithm(enum.IntEnum):
    """Reference: join/join_config.hpp:25 (SORT/HASH); AUTO picks the
    fastest applicable route."""

    SORT = 0
    HASH = 1
    AUTO = 2


class JoinConfig:
    """Reference: join/join_config.hpp:29-89. Accepts single ints or lists
    of column indices."""

    def __init__(self, join_type: JoinType, left_column_idx,
                 right_column_idx,
                 algorithm: JoinAlgorithm = JoinAlgorithm.SORT,
                 exact: bool = False):
        self.type = join_type
        self.algorithm = algorithm
        self.left_column_idx = _as_list(left_column_idx)
        self.right_column_idx = _as_list(right_column_idx)
        # byte-verification of varbytes keys that join on their content
        # hash (rows longer than strings.EXACT_KEY_WORDS words)
        self.exact = exact

    # the reference's named constructors and getters
    # (join_config.hpp:48-89); the C binding calls InnerJoin
    @staticmethod
    def InnerJoin(l, r, algorithm: JoinAlgorithm = JoinAlgorithm.SORT):
        return JoinConfig(JoinType.INNER, l, r, algorithm)

    @staticmethod
    def LeftJoin(l, r, algorithm: JoinAlgorithm = JoinAlgorithm.SORT):
        return JoinConfig(JoinType.LEFT, l, r, algorithm)

    @staticmethod
    def RightJoin(l, r, algorithm: JoinAlgorithm = JoinAlgorithm.SORT):
        return JoinConfig(JoinType.RIGHT, l, r, algorithm)

    @staticmethod
    def FullOuterJoin(l, r, algorithm: JoinAlgorithm = JoinAlgorithm.SORT):
        return JoinConfig(JoinType.FULL_OUTER, l, r, algorithm)

    def GetType(self) -> JoinType:
        return self.type

    def GetAlgorithm(self) -> JoinAlgorithm:
        return self.algorithm

    def GetLeftColumnIdx(self):
        return self.left_column_idx

    def GetRightColumnIdx(self):
        return self.right_column_idx


def _as_list(v):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [int(v)]


_SIGN64 = -(1 << 63)
_IDX_MASK = (1 << 29) - 1


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=like.device)


def _scatter_drop(n: int, dest: torch.Tensor, src: torch.Tensor,
                  dtype=torch.int32) -> torch.Tensor:
    """``zeros([W, n]).at[dest].set(src, mode="drop")`` for unique
    in-range destinations, with destination ``n`` meaning "drop"."""
    out = torch.zeros(dest.shape[0], n + 1, dtype=dtype, device=dest.device)
    out.scatter_(1, dest, src.to(dtype))
    return out[:, :n]


def _pack_tag(side_a: torch.Tensor, emit: Optional[torch.Tensor],
              live: torch.Tensor) -> torch.Tensor:
    """``side<<31 | emit<<30 | live<<29 | iota`` as int64 in [0, 2^32)."""
    n = live.shape[1]
    tag = (side_a.to(torch.int64) << 31) | (live.to(torch.int64) << 29) \
        | _arange(n, live)
    if emit is not None:
        tag = tag | (emit.to(torch.int64) << 30)
    return tag


def _side_flags(na: int, nb: int, like: torch.Tensor) -> torch.Tensor:
    """[W, na + nb] bool: True on probe (a) rows."""
    w = like.shape[0]
    return torch.cat([torch.ones(w, na, dtype=torch.bool, device=like.device),
                      torch.zeros(w, nb, dtype=torch.bool,
                                  device=like.device)], 1)


def _bits_tag_key(bits: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """The packed int64 key that sorts [W, n] rows by (unsigned 32-bit
    bits, tag) in ONE sort (tags are unique, so no tie remains)."""
    return ((unsigned(bits) << 32) | tag) ^ _SIGN64


def _sort_by_bits_tag(bits: torch.Tensor, tag: torch.Tensor) -> torch.Tensor:
    """Permutation sorting [W, n] rows by (unsigned 32-bit bits, tag)."""
    return torch.sort(_bits_tag_key(bits, tag), dim=1).indices


# ---------------------------------------------------------------------------
# plan route: plan / materialize
# ---------------------------------------------------------------------------


def join_plan_keys(lbits, lkv, lemit, rbits, rkv, remit,
                   join_type: JoinType):
    """One-sort join plan over [W, n] key bits (tuples of same-width bit
    containers, ops/order.py), key validity and emit masks.

    Returns (counts2 int64 [W, 2] = [n_primary, n_unmatched_b], lo, m
    int32 [W, na], bperm int32 [W, nb], un_mask bool [W, nb]) — the
    arrays of cylon_tpu.ops.join.join_plan_keys, per shard."""
    if join_type == JoinType.RIGHT:
        abits, akv, aemit = rbits, rkv, remit
        bbits, bkv, bemit = lbits, lkv, lemit
    else:
        abits, akv, aemit = lbits, lkv, lemit
        bbits, bkv, bemit = rbits, rkv, remit
    w, na = aemit.shape
    nb = bemit.shape[1]
    n = na + nb
    dev = aemit.device
    if na == 0 or n == 0:
        if join_type == JoinType.FULL_OUTER:
            un_mask = bemit
            n_un = un_mask.sum(1)
        else:
            un_mask = torch.zeros(w, nb, dtype=torch.bool, device=dev)
            n_un = torch.zeros(w, dtype=torch.int64, device=dev)
        counts2 = torch.stack([torch.zeros_like(n_un), n_un], 1)
        z = torch.zeros(w, na, dtype=torch.int32, device=dev)
        return counts2, z, z, torch.zeros(w, nb, dtype=torch.int32,
                                          device=dev), un_mask
    if n >= (1 << 29):
        raise ValueError("per-shard row count must fit the 29-bit tag")
    live_a = aemit & akv
    live_b = bemit & bkv
    live = torch.cat([live_a, live_b], 1)
    tag = _pack_tag(_side_flags(na, nb, live), None, live)
    bits = []
    for x, y in zip(abits, bbits):
        b = torch.cat([x, y], 1)
        bits.append(torch.where(live, b, torch.full(
            (), all_ones(b.dtype), dtype=b.dtype, device=dev)))
    if len(bits) == 1 and bits[0].element_size() <= 4:
        perm = _sort_by_bits_tag(bits[0], tag)
    else:
        perm = lexsort_indices(bits + [tag])
    bits_s = [b.gather(1, perm) for b in bits]
    tag_s = tag.gather(1, perm)

    is_a = ((tag_s >> 31) & 1) == 1
    live_s = ((tag_s >> 29) & 1) == 1
    idx_s = tag_s & _IDX_MASK
    ib = (~is_a & live_s).to(torch.int64)
    cum_b = torch.cumsum(ib, 1)
    neq = torch.zeros(w, n, dtype=torch.bool, device=dev)
    neq[:, 0] = True
    for k in bits_s:
        neq[:, 1:] |= k[:, 1:] != k[:, :-1]
    run_id = torch.cumsum(neq.to(torch.int64), 1) - 1
    # live-b count before each run, broadcast via run heads (scatter to
    # unique head slots + gather by run id)
    head_b = _scatter_drop(n, torch.where(neq, run_id, n), cum_b - ib,
                           torch.int64)
    b_before = head_b.gather(1, run_id)
    m_at = cum_b - b_before  # valid at a positions: run b's all precede

    dest_a = torch.where(is_a, idx_s, na)
    lo = _scatter_drop(na, dest_a, b_before)
    m = _scatter_drop(na, dest_a, m_at)
    # dead a rows sharing the all-ones run with live max-key b rows must
    # not match them
    m = torch.where(live_a, m, 0)
    bperm = _scatter_drop(nb, torch.where(ib == 1, cum_b - 1, nb),
                          idx_s - na)

    if join_type == JoinType.INNER:
        n_primary = m.sum(1, dtype=torch.int64)
    else:
        n_primary = torch.where(aemit, m.clamp(min=1), 0).sum(
            1, dtype=torch.int64)
    if join_type == JoinType.FULL_OUTER:
        ia = (is_a & live_s).to(torch.int64)
        cum_a = torch.cumsum(ia, 1)
        head_a = _scatter_drop(n + 1, torch.where(neq, run_id, n + 1),
                               cum_a - ia, torch.int64)
        nruns = run_id[:, -1:] + 1
        head_a.scatter_(1, nruns, cum_a[:, -1:])
        # live-a total of each run = next run's prefix minus this run's
        m_b_at = head_a.gather(1, run_id + 1) - head_a.gather(1, run_id)
        mb = _scatter_drop(nb, torch.where(is_a, nb, idx_s - na), m_b_at)
        # dead b rows in the shared all-ones run are unmatched by fiat
        un_mask = bemit & (torch.where(live_b, mb, 0) == 0)
        n_un = un_mask.sum(1, dtype=torch.int64)
    else:
        un_mask = torch.zeros(w, nb, dtype=torch.bool, device=dev)
        n_un = torch.zeros(w, dtype=torch.int64, device=dev)
    counts2 = torch.stack([n_primary, n_un], 1)
    return counts2, lo, m, bperm, un_mask


def join_plan_gids(gl, gr, lemit, remit, join_type: JoinType):
    """Plan from precomputed shared dense int32 key ids ``[W, n]`` (the
    JAX package's compat wrapper over `join_plan_keys`): negative ids are
    null sentinels that never match. The ids' uint32 bits with the sign
    bit flipped ride an int32 container, so ids order as unsigned bits."""
    sb = -(1 << 31)
    return join_plan_keys((gl.to(torch.int32) ^ sb,), gl >= 0, lemit,
                          (gr.to(torch.int32) ^ sb,), gr >= 0, remit,
                          join_type)


def _expand_from_match(lo, m, aemit, bperm, out_size: int,
                       emit_unmatched_a: bool):
    """Emit (a_idx, b_idx) int32 [W, out_size] pairs from match info,
    padded with (-1, -1). A row i's j-th output picks build slot
    ``lo[i] + (j - starts[i])``; the covering row of output j comes from
    a cumsum over run-start marks and a gather through the compacted list
    of emitting rows."""
    w, na = lo.shape
    nb = bperm.shape[1]
    dev = lo.device
    if na == 0:
        e = torch.full((w, out_size), -1, dtype=torch.int32, device=dev)
        return e, e
    m64 = m.to(torch.int64)
    mm = torch.where(aemit & emit_unmatched_a, m64.clamp(min=1), m64)
    off = torch.cumsum(mm, 1)
    total = off[:, -1:]
    starts = off - mm
    emits = mm > 0
    erank = torch.cumsum(emits.to(torch.int64), 1)
    emit_list = _scatter_drop(na, torch.where(emits, erank - 1, na),
                              _arange(na, lo).expand(w, na), torch.int64)
    z = _scatter_drop(out_size, torch.where(
        emits & (starts < out_size), starts, out_size),
        torch.ones_like(starts), torch.int64)
    c = torch.cumsum(z, 1)  # 1-based ordinal of the run covering j
    ord_safe = (c - 1).clamp(0, na - 1)
    i = emit_list.gather(1, ord_safe)
    d = (lo.to(torch.int64) - starts).gather(1, i)
    has = (m > 0).gather(1, i)
    j = _arange(out_size, lo).expand(w, out_size)
    if nb == 0:
        bidx = torch.full((w, out_size), -1, dtype=torch.int64, device=dev)
    else:
        bpos = j + d
        inb = (bpos >= 0) & (bpos < nb)
        bidx = torch.where(inb, bperm.to(torch.int64).gather(
            1, bpos.clamp(0, nb - 1)), 0)
        bidx = torch.where(has, bidx, -1)
    valid = j < total
    aidx = torch.where(valid, i, -1)
    bidx = torch.where(valid, bidx, -1)
    return aidx.to(torch.int32), bidx.to(torch.int32)


def _masked_indices(mask: torch.Tensor, out_size: int) -> torch.Tensor:
    """Per shard, positions of True values in order, padded with -1 to
    ``out_size`` (int32 [W, out_size])."""
    w, n = mask.shape
    j = _arange(out_size, mask).expand(w, out_size)
    if n == 0:
        return torch.full((w, out_size), -1, dtype=torch.int32,
                          device=mask.device)
    srt = torch.sort((~mask).to(torch.int8), dim=1, stable=True).indices
    idx = torch.where(j < n, srt.gather(1, j.clamp(max=n - 1)), 0)
    return torch.where(j < mask.sum(1, keepdim=True), idx, -1).to(
        torch.int32)


def gather_columns(dat, val, idx: torch.Tensor):
    """Batch -1 -> null gather over [W, n] columns by [W, m] indices: new
    validity = source validity at the gathered row AND a real index.
    Empty sources produce all-null outputs."""
    safe = idx.to(torch.int64).clamp(min=0)
    hit = idx >= 0
    out_d, out_v = [], []
    for d, v in zip(dat, val):
        if d.shape[1] == 0:
            out_d.append(torch.zeros(idx.shape, dtype=d.dtype,
                                     device=d.device))
            out_v.append(torch.zeros_like(hit))
            continue
        out_d.append(movable(d).gather(1, safe).view(d.dtype))
        out_v.append(hit if v is None else (v.gather(1, safe) & hit))
    return tuple(out_d), tuple(out_v)


def _vm(v, like):
    """validity-or-None -> mask shaped like ``like`` (None = all valid)."""
    if v is None:
        return torch.ones(like.shape[:2], dtype=torch.bool,
                          device=like.device)
    return v


def key_bits(keys, valids, raw=None):
    """Key columns -> (tuple of ordered key bits, combined key validity),
    the inputs of both plan routes. ``raw[i]`` True: key i already is its
    bits (dictionary codes, varbytes word lanes and hashes: the JAX
    package's string keys)."""
    raw = raw or [False] * len(keys)
    bits = tuple(x if r else ordered_bits_raw(x) for x, r in zip(keys, raw))
    kv = _vm(None, keys[0])
    for v in valids:
        if v is not None:
            kv = kv & v
    return bits, kv


# ---------------------------------------------------------------------------
# stream and hash routes: the sort, then kernels K3 (plan) and K4
# (expansion); `join_route` says which route a join takes (FULL_OUTER
# runs as LEFT plus an unmatched-build tail in data/table.py)
# ---------------------------------------------------------------------------

# None = auto (the kernel route on CUDA); False disables the stream route
# (the plan route everywhere); True forces it, also on the CPU, where the
# kernel wrappers run their plain versions
STREAM_PLAN: Optional[bool] = None


def _stream_on(device: torch.device) -> bool:
    if STREAM_PLAN is not None:
        return STREAM_PLAN
    return device.type == "cuda"


# sort-operand budget for the hash route: key-verify lanes (K8's limit)
MAX_HASH_KEY_LANES = _k.MAX_HASH_LANES


# payload slots that ride the plan sort as 32-bit lanes; columns beyond
# the budget gather by the materialized indices
MAX_SHARED_LANES = 8


def plan_lane_descs(ldat, lval, rdat, rval, join_type: JoinType):
    """Static lane packing for the stream route: which columns ride the
    plan sort as 32-bit payload lanes. Slot s carries the probe side's
    lane s at probe rows and the build side's lane s at build rows.
    Returns (a_desc, b_desc): tuples of (col_idx, kind), kind "d" (data
    bits) or "v" (validity widened)."""
    if join_type == JoinType.RIGHT:
        adat, aval, bdat, bval = rdat, rval, ldat, lval
    else:
        adat, aval, bdat, bval = ldat, lval, rdat, rval

    def side(dat, val):
        desc = []
        for ci, (d, v) in enumerate(zip(dat, val)):
            need = 1 + (1 if v is not None else 0)
            if (d.element_size() == 4 and d.dtype != torch.bool
                    and len(desc) + need <= MAX_SHARED_LANES):
                desc.append((ci, "d"))
                if v is not None:
                    desc.append((ci, "v"))
        return tuple(desc)

    return side(adat, aval), side(bdat, bval)


def stream_block_rows(na: int, nb: int) -> int:
    """The JAX package's Pallas block-rows choice. The port's kernels do
    not use it; it sets ``stream_expand_capacity`` so output shapes match
    the JAX package's."""
    return 8 if (na + nb) < (1 << 20) else 64


def stream_expand_capacity(n: int, block_rows: int) -> int:
    """cap_e: the pow2-bucketed capacity lifted to a whole number of
    (block_rows * 128)-row expansion blocks."""
    blk = block_rows * 128
    return -(-bucket_cap(n) // blk) * blk


def _side_lanes(dat, val, desc):
    lanes = []
    for ci, kind in desc:
        if kind == "d":
            lanes.append(dat[ci].view(torch.int32))
        else:
            lanes.append(val[ci].to(torch.int32))
    return lanes


def plan_program_stream(lbits, lkv, lemit, rbits, rkv, remit,
                        ldat, lval, rdat, rval, join_type: JoinType,
                        a_desc=(), b_desc=(), hash_mode: bool = False,
                        stage=contextlib.nullcontext, fetch=None):
    """Phase 1 of the stream route over [W, n] inputs (key bits and key
    validity as ``key_bits`` returns them): one sort with the payload
    lanes riding along, then the plan kernel K3. Returns (counts int32
    [W, 4], a_streams, b_streams) as ops/kernels.join_plan_stream does.
    ``stage(label)`` opens the span of each stage and ``fetch(counts)``
    runs in the last (the local join's ``join.plan.*`` spans and its
    count fetch; by default neither).

    hash_mode: rows sort by a 2x32-bit row hash (two sort keys for any
    key shape); the true key bits ride as verify lanes and counts[:, 3]
    reports within-run mismatches for the caller's exact fallback."""
    with stage("join.plan.hash"):
        keys = stream_sort_keys(lbits, lkv, lemit, rbits, rkv, remit, ldat,
                                lval, rdat, rval, join_type, a_desc, b_desc,
                                hash_mode)
    with stage("join.plan.sort"):
        kw = stream_sort(keys)
        del keys
    with stage("join.plan.stream"):
        out = _k.join_plan_stream(**kw)
        del kw
        if fetch is not None:
            fetch(out[0])
    return out


def stream_sort_keys(lbits, lkv, lemit, rbits, rkv, remit,
                     ldat, lval, rdat, rval, join_type: JoinType,
                     a_desc=(), b_desc=(), hash_mode: bool = False
                     ) -> dict:
    """The first stage of ``plan_program_stream``, everything before its
    sorts: the row tags, the payload lanes, and the packed sort keys (in
    hash mode K8 ``join_hash_keys``: the tags, the key bits' u32 lanes,
    their two hash streams and the packed key in one pass).
    ``stream_sort`` takes the dict and pops the sort keys, so they are
    freed once sorted."""
    if join_type == JoinType.RIGHT:
        abits, akv, aemit = rbits, rkv, remit
        bbits, bkv, bemit = lbits, lkv, lemit
        adat, aval, bdat, bval = rdat, rval, ldat, lval
    else:
        abits, akv, aemit = lbits, lkv, lemit
        bbits, bkv, bemit = rbits, rkv, remit
        adat, aval, bdat, bval = ldat, lval, rdat, rval
    w, na = akv.shape
    nb = bkv.shape[1]
    if hash_mode:
        # every key column flattens to u32 lanes (8-byte bits split
        # hi/lo), hashed into two independent 32-bit streams; (h1, h2,
        # tag) order: a stable sort by h1 after one by (h2, tag)
        out = _k.join_hash_keys(abits, akv, aemit, bbits, bkv, bemit)
    else:
        aemit, bemit = _vm(aemit, akv), _vm(bemit, bkv)
        live = torch.cat([aemit & akv, bemit & bkv], 1)
        emit = torch.cat([aemit, bemit], 1)
        tag = _pack_tag(_side_flags(na, nb, live), emit, live)
        bits = torch.cat([abits[0], bbits[0]], 1)
        bits = torch.where(live, bits, torch.full((), -1, dtype=bits.dtype,
                                                  device=bits.device))
        out = dict(tag=tag, key=_bits_tag_key(bits, tag), bits=bits)

    a_lanes = _side_lanes(adat, aval, a_desc)
    b_lanes = _side_lanes(bdat, bval, b_desc)
    lanes = []
    for s in range(max(len(a_lanes), len(b_lanes))):
        z = torch.zeros(w, 1, dtype=torch.int32, device=akv.device)
        al = a_lanes[s] if s < len(a_lanes) else z.expand(w, na)
        bl = b_lanes[s] if s < len(b_lanes) else z.expand(w, nb)
        lanes.append(torch.cat([al, bl], 1))
    out.update(lanes=lanes, na=na, nb=nb,
               emit_unmatched_a=join_type != JoinType.INNER,
               n_a_lanes=len(a_lanes), n_b_lanes=len(b_lanes))
    return out


def stream_sort(keys: dict) -> dict:
    """The second stage of ``plan_program_stream``: the sorts of
    ``stream_sort_keys``'s packed keys (popped from ``keys``) and the key
    bits, tags and lanes in their order. Returns K3's keyword arguments.
    On the card the rows move as records (``record_stream_sort``, K10);
    elsewhere ``plain_stream_sort``, which gives the same tensors."""
    if not keys["tag"].is_cuda:
        return plain_stream_sort(keys)
    return record_stream_sort(keys)


def plain_stream_sort(keys: dict) -> dict:
    """``stream_sort`` by torch gathers: each stream gathered by the
    sorts' permutation, then narrowed."""
    tag, lanes = keys["tag"], keys["lanes"]
    out = {k: keys[k] for k in ("na", "nb", "emit_unmatched_a",
                                "n_a_lanes", "n_b_lanes")}
    perm = torch.sort(keys.pop("key"), dim=1).indices
    if "h1" in keys:
        h1, h2 = keys["h1"], keys["h2"]
        perm = perm.gather(1, torch.sort(h1.gather(1, perm), dim=1,
                                         stable=True).indices)
        out.update(bits_s=as_i32(h1.gather(1, perm)),
                   bits2_s=as_i32(h2.gather(1, perm)),
                   verify_lanes=[as_i32(x.gather(1, perm))
                                 for x in keys["kb"]])
    else:
        out["bits_s"] = keys["bits"].gather(1, perm)
    out.update(tag_s=as_i32(tag.gather(1, perm)),
               lanes=[x.gather(1, perm) for x in lanes])
    return out


def record_stream_sort(keys: dict) -> dict:
    """``stream_sort`` with the rows as records of 32-bit words (K10
    ``kernels.permute_rows``): the tag, the key words and the lanes packed
    into one record a row, the records moved by each sort's permutation,
    the last move split into K3's int32 streams. The sorts are
    ``plain_stream_sort``'s, so the order is the same. ``keys``' streams
    are popped as soon as the pack has read them."""
    out = {k: keys[k] for k in ("na", "nb", "emit_unmatched_a",
                                "n_a_lanes", "n_b_lanes")}
    hash_mode = "h1" in keys
    if hash_mode:
        nk = len(keys["kb"])
        words = [keys.pop("h1"), keys.pop("h2"), keys.pop("tag"),
                 *keys.pop("kb"), *keys.pop("lanes")]
    else:
        bits = keys.pop("bits")
        words = [bits.view(torch.int32), keys.pop("tag"), *keys.pop("lanes")]
    nw = len(words)
    rows, _ = _k.permute_rows(words)
    del words
    perm = torch.sort(keys.pop("key"), dim=1).indices
    if hash_mode:
        # then a stable sort by h1 (word 0), its key written by the move
        rows, key = _k.permute_rows(rows, perm, nw, key=1)
        perm = torch.sort(key, dim=1, stable=True).indices
        del key
    s, _ = _k.permute_rows(rows, perm, nw, split=True)
    del rows, perm
    if hash_mode:
        out.update(bits_s=s[0], bits2_s=s[1], tag_s=s[2],
                   verify_lanes=list(s[3:3 + nk]), lanes=list(s[3 + nk:]))
    else:
        out.update(bits_s=s[0].view(bits.dtype), tag_s=s[1],
                   lanes=list(s[2:]))
    return out


def _lane_columns(dat, val, desc, lane_outs, idx, hit):
    """One side's output columns: those ``desc`` put in lanes from K4's
    ``lane_outs`` (``hit``: ``idx >= 0``), the rest gathered by ``idx``."""
    od: list = [None] * len(dat)
    ov: list = [None] * len(dat)
    for (ci, kind), lane in zip(desc, lane_outs):
        if kind == "d":
            od[ci] = lane.view(dat[ci].dtype)
            if val[ci] is None:
                ov[ci] = hit
        else:
            ov[ci] = (lane != 0) & hit
    fb = [ci for ci in range(len(dat)) if od[ci] is None]
    if fb:
        fbd, fbv = gather_columns([dat[ci] for ci in fb],
                                  [val[ci] for ci in fb], idx)
        for k, ci in enumerate(fb):
            od[ci], ov[ci] = fbd[k], fbv[k]
    return tuple(od), tuple(ov)


# ---------------------------------------------------------------------------
# the planner of the local join and of every per-shard join of
# parallel/dist_ops.py: `join_route`, then `plan_join` on the device, the
# caller's fetch of ``JoinPlan.counts`` (inside the plan's last stage
# where the caller passes it as ``fetch``), then `JoinPlan.materialize`
# ---------------------------------------------------------------------------


def join_route(lbits, rbits, join_type: JoinType,
               algorithm: JoinAlgorithm) -> str:
    """A join's route over [W, n] key bits: "stream" (one 4-byte key; SORT
    or AUTO), "hash" (keys within K8's lane budget sort on a 2x32-bit row
    hash, reference arrow_hash_kernels.hpp:48-225; HASH or AUTO) or
    "plan", the general route (stream routes off, FULL_OUTER, an empty
    side, 2^29 rows a shard, other keys). Distributed joins pass AUTO."""
    na, nb = lbits[0].shape[-1], rbits[0].shape[-1]
    if not _stream_on(lbits[0].device) or join_type == JoinType.FULL_OUTER \
            or na == 0 or nb == 0 or na + nb >= (1 << 29):
        return "plan"
    if algorithm != JoinAlgorithm.HASH and len(lbits) == 1 \
            and lbits[0].element_size() == rbits[0].element_size() == 4:
        return "stream"
    lanes = sum(2 if b.element_size() == 8 else 1 for b in lbits)
    if algorithm != JoinAlgorithm.SORT and lanes <= MAX_HASH_KEY_LANES:
        return "hash"
    return "plan"


@dataclasses.dataclass(frozen=True)
class JoinPlan:
    """A join planned on the device over [W, n] inputs (`plan_join`); the
    caller fetches ``counts``: K3's int32 [W, 4] on the stream and hash
    routes, [W, 2] = [n_out, n_unmatched_b] on the plan route."""

    route: str
    join_type: JoinType
    counts: torch.Tensor
    # the stream and hash routes: K3's groups, their payload lanes and
    # the JAX package's block rows (its expansion capacities)
    a_streams: Optional[torch.Tensor] = None
    b_streams: Optional[torch.Tensor] = None
    a_desc: tuple = ()
    b_desc: tuple = ()
    block_rows: int = 0
    # the plan route's arrays (`join_plan_keys`) and the probe's emits
    lo: Optional[torch.Tensor] = None
    m: Optional[torch.Tensor] = None
    bperm: Optional[torch.Tensor] = None
    un_mask: Optional[torch.Tensor] = None
    aemit: Optional[torch.Tensor] = None

    def read_counts(self, rows: list) -> Tuple[list, bool]:
        """Fetched ``counts`` rows (``counts.tolist()``; the ring stacks
        its steps' rows) as [n_out, n_unmatched_b] rows, and whether the
        hash route met a 64-bit hash collision (a within-run key
        mismatch): the plan route then plans again. Plain lists: the
        local join reads them with the card idle."""
        if self.route == "plan":
            return rows, False
        return ([[r[0], 0] for r in rows],
                self.route == "hash" and any(r[3] > 0 for r in rows))

    def materialize(self, ldat, lval, rdat, rval, cap: int, cap_u: int = 0):
        """Phase 2 at ``cap`` rows a shard (plus ``cap_u`` unmatched build
        rows on the plan route's FULL_OUTER): the (a, b) row pairs from K4
        or the plan route's expansion, then each column from its lanes or
        gathered. Returns (ldat', lval', rdat', rval', emit, lidx, ridx),
        [W, cap + cap_u], padded (-1, -1, False)."""
        jt = self.join_type
        if self.route == "plan":
            aidx, bidx = _expand_from_match(
                self.lo, self.m, self.aemit, self.bperm, cap,
                jt != JoinType.INNER)
            if jt == JoinType.FULL_OUTER:
                un = _masked_indices(self.un_mask, cap_u)
                aidx = torch.cat([aidx, torch.full_like(un, -1)], 1)
                bidx = torch.cat([bidx, un], 1)
            lanes, emit, bhit = ((), ()), (aidx >= 0) | (bidx >= 0), None
        else:
            aidx, bidx, *lanes = _k.join_expand_stream(
                self.counts, self.a_streams, self.b_streams, cap)
            emit, bhit = aidx >= 0, bidx >= 0
        right = jt == JoinType.RIGHT
        adat, aval, bdat, bval = (rdat, rval, ldat, lval) if right \
            else (ldat, lval, rdat, rval)
        a = _lane_columns(adat, aval, self.a_desc, lanes[0], aidx, emit)
        b = _lane_columns(bdat, bval, self.b_desc, lanes[1], bidx, bhit)
        (lod, lov), (rod, rov) = (b, a) if right else (a, b)
        lidx, ridx = (bidx, aidx) if right else (aidx, bidx)
        return lod, lov, rod, rov, emit, lidx, ridx

    def matched(self) -> torch.Tensor:
        """bool [W, na]: the probe rows an INNER plan matched (K3's group
        A rows, the plan route's ``m > 0``)."""
        if self.route == "plan":
            return self.m > 0
        w, na = self.a_streams.shape[1:]
        idx = self.a_streams[0].to(torch.int64)
        pos = torch.arange(na, device=idx.device)
        emits = pos < self.counts[:, 1:2].to(torch.int64)
        # entries past n_emit go to spare slots of their own: one shared
        # overflow slot would serialise their stores on the card
        hit = torch.zeros(w, 2 * na, dtype=torch.bool, device=idx.device)
        hit.scatter_(1, torch.where(emits, idx, na + pos), True)
        return hit[:, :na]


def plan_join(route: str, lbits, lkv, lemit, rbits, rkv, remit, ldat, lval,
              rdat, rval, join_type: JoinType,
              stage=contextlib.nullcontext, fetch=None) -> JoinPlan:
    """Phase 1 on ``route`` (`join_route`'s, or "plan" to redo a hash
    collision) over [W, n] key bits and validity (`key_bits`), emits
    (None: all) and payload: `plan_program_stream` (with its ``stage``
    and ``fetch``) or `join_plan_keys`, then ``fetch(counts)``."""
    if route == "plan":
        lemit, remit = _vm(lemit, lkv), _vm(remit, rkv)
        counts, lo, m, bperm, un_mask = join_plan_keys(
            lbits, lkv, lemit, rbits, rkv, remit, join_type)
        if fetch is not None:
            fetch(counts)
        return JoinPlan(route, join_type, counts, lo=lo, m=m, bperm=bperm,
                        un_mask=un_mask, aemit=remit
                        if join_type == JoinType.RIGHT else lemit)
    a_desc, b_desc = plan_lane_descs(ldat, lval, rdat, rval, join_type)
    counts, a_streams, b_streams = plan_program_stream(
        lbits, lkv, lemit, rbits, rkv, remit, ldat, lval, rdat, rval,
        join_type, a_desc, b_desc, hash_mode=route == "hash", stage=stage,
        fetch=fetch)
    return JoinPlan(route, join_type, counts, a_streams, b_streams, a_desc,
                    b_desc, stream_block_rows(lkv.shape[1], rkv.shape[1]))
